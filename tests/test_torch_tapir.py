"""PyTorch port, the whole TAPIR at a small BootsTAPIR-shaped config against
the JAX TAPIR in fp32: the module, `TapirPredictor(device="cpu")` with query
padding and chunking, and the video resize that feeds the backbone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tapnet_tpu.models import tapir as jax_tapir
from tapnet_tpu_torch.checkpoints.convert import load_flax_params
from tapnet_tpu_torch.inference import TapirPredictor
from tapnet_tpu_torch.models import tapir

SMALL = dict(
    blocks_per_group=(1, 1, 1, 1), highres_dim=16, lowres_dim=32,
    mixer_hidden_dim=32, num_mixer_blocks=2, initial_resolution=(64, 64),
    extra_convs=True, pyramid_level=1, num_pips_iter=2,
)
B, T, H, W, N = 1, 4, 96, 80, 6
# fp32 on both sides: summation order in convolutions and matmuls, carried
# through 4 refinement steps and the soft-argmax, stays well under 1e-3 px.
TRACK_TOL = 1e-3
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def small_model():
  """JAX params and outputs for a 96x80 clip: refinement at 64x64 and
  96x80, so the backbone input is resized and two ladders run."""
  rng = np.random.RandomState(0)
  video = (rng.rand(B, T, H, W, 3) * 2 - 1).astype(np.float32)
  qp = np.stack(
      [rng.randint(0, T, N), rng.rand(N) * (H - 8) + 4,
       rng.rand(N) * (W - 8) + 4], -1,
  )[None].astype(np.float32)
  model = jax_tapir.TAPIR(config=jax_tapir.bootstapir_config(**SMALL))
  args = (jnp.asarray(video), jnp.asarray(qp))
  params = jax.jit(model.init)(jax.random.PRNGKey(0), *args)["params"]
  noise = np.random.RandomState(1)
  params = jax.tree_util.tree_map(
      lambda x: np.asarray(x)
      + 0.02 * noise.randn(*x.shape).astype(np.float32),
      jax.device_get(params),
  )
  out = jax.jit(lambda p, v, q: model.apply({"params": p}, v, q))(
      params, *args
  )
  return params, video, qp, jax.device_get(out)


def _check(out, ref):
  np.testing.assert_allclose(
      np.asarray(out["tracks"]), ref["tracks"], rtol=0, atol=TRACK_TOL
  )
  for key in ("occlusion", "expected_dist"):
    np.testing.assert_allclose(
        np.asarray(out[key]), ref[key], rtol=LOGIT_TOL, atol=LOGIT_TOL
    )


def test_tapir_matches_jax(small_model):
  params, video, qp, ref = small_model
  model = tapir.TAPIR(tapir.bootstapir_config(**SMALL))
  load_flax_params(model, params)
  with torch.no_grad():
    out = model(torch.from_numpy(video), torch.from_numpy(qp))
  _check({k: v.numpy() for k, v in out.items() if not k.startswith("un")}, ref)
  # Every refinement iteration (2 resolutions x 2 steps) and stage 1.
  assert len(out["unrefined_tracks"]) == len(ref["unrefined_tracks"]) == 4
  for ours, theirs in zip(out["unrefined_tracks"], ref["unrefined_tracks"]):
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=TRACK_TOL)


@pytest.mark.parametrize(
    "chunk,bucket", [(4, 8), (None, 8), (6, 1)],
    ids=["chunk_lt_n", "chunk_eq_padded_n", "chunk_eq_n"],
)
def test_predictor_matches_jax(small_model, chunk, bucket):
  """Query padding to the bucket and chunking do not change the result."""
  params, video, qp, ref = small_model
  predictor = TapirPredictor(
      params, tapir.bootstapir_config(**SMALL), query_bucket=bucket,
      query_chunk_size=chunk, device="cpu",
  )
  out = predictor(video, qp)
  assert out["tracks"].shape == (B, N, T, 2)
  _check(out, ref)
  vis = predictor.visibles(out)
  assert vis.dtype == bool and vis.shape == (B, N, T)


def test_track_many_yields_in_order(small_model):
  params, video, qp, _ = small_model
  predictor = TapirPredictor(
      params, tapir.bootstapir_config(**SMALL), device="cpu"
  )
  items = [(video, qp), (video[:, ::-1].copy(), qp[:, :3])]
  outs = list(predictor.track_many(items))
  assert [o["tracks"].shape[1] for o in outs] == [N, 3]
  for out, (v, q) in zip(outs, items):
    single = predictor(v, q)
    np.testing.assert_array_equal(out["tracks"], single["tracks"])


@pytest.mark.parametrize(
    "src,dst", [((96, 80), (64, 64)), ((37, 29), (16, 24)), ((32, 32), (48, 56))],
    ids=["down", "down_odd", "up"],
)
def test_resize_matches_jax_image_resize(src, dst):
  """The backbone input resize equals the JAX image.resize(bilinear), which
  antialiases when it downsamples."""
  video = np.random.RandomState(2).rand(1, 2, *src, 3).astype(np.float32)
  ref = jax.image.resize(jnp.asarray(video), (1, 2) + dst + (3,), "bilinear")
  out = tapir.resize_video(torch.from_numpy(video), dst)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)

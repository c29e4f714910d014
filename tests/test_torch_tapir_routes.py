"""PyTorch port, TAPIR's options beyond the kernel's route, against the JAX
TAPIR in fp32 at a small BootsTAPIR-shaped config (test_torch_tapir's small
model on a 64x64 clip of 5 frames): the local correlation's four routes
(the corr-tents kernel's, the whole correlation map with tent products or
with gathers, the sampled neighbours), each alone and with the backbone run
in chunks of 2 frames (the last one ragged) and the per-frame query
extraction, on query times that are not whole frames; and the int8
correlation's flag on a route that has no int8 form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.models import tapir as jax_tapir  # noqa: E402
from tapnet_tpu_torch.checkpoints.convert import load_flax_params  # noqa: E402
from tapnet_tpu_torch.models import tapir  # noqa: E402
from tapnet_tpu_torch.ops import corr_tents  # noqa: E402

SMALL = dict(
    blocks_per_group=(1, 1, 1, 1), highres_dim=16, lowres_dim=32,
    mixer_hidden_dim=32, num_mixer_blocks=2, initial_resolution=(64, 64),
    extra_convs=True, pyramid_level=1, num_pips_iter=2,
)
B, T, H, W, N = 1, 5, 64, 64, 6
# test_torch_tapir's limits: fp32 on both sides, summation order only.
TRACK_TOL = 1e-3
LOGIT_TOL = 1e-4

ROUTES = {
    "kernel": dict(),
    "tents": dict(use_fused_corr=False),
    "gathers": dict(use_fused_corr=False, use_gather_tents=True),
    "sampled": dict(use_matmul_corr=False),
}
OPTIONS = {
    "plain": dict(),
    "chunked_per_frame": dict(feature_extractor_chunk_size=2,
                              parallelize_query_extraction=True),
}


@pytest.fixture(scope="module")
def clip():
  """Weights (JAX's init plus noise), a 5-frame clip and queries whose times
  lie between frames (the per-frame extraction rounds them, the default
  interpolates)."""
  rng = np.random.RandomState(0)
  video = (rng.rand(B, T, H, W, 3) * 2 - 1).astype(np.float32)
  qp = np.stack(
      [rng.rand(N) * (T - 1), rng.rand(N) * (H - 8) + 4,
       rng.rand(N) * (W - 8) + 4], -1,
  )[None].astype(np.float32)
  model = jax_tapir.TAPIR(config=jax_tapir.bootstapir_config(**SMALL))
  params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(video),
                               jnp.asarray(qp))["params"]
  noise = np.random.RandomState(1)
  params = jax.tree_util.tree_map(
      lambda x: np.asarray(x) + 0.02 * noise.randn(*x.shape).astype(np.float32),
      jax.device_get(params),
  )
  return params, video, qp


def _jax_out(params, video, qp, overrides):
  model = jax_tapir.TAPIR(
      config=jax_tapir.bootstapir_config(**SMALL, **overrides))
  out = jax.jit(lambda p, v, q: model.apply({"params": p}, v, q))(
      params, jnp.asarray(video), jnp.asarray(qp))
  return jax.device_get(out)


def _port_out(params, video, qp, overrides):
  model = tapir.TAPIR(tapir.bootstapir_config(**SMALL, **overrides))
  load_flax_params(model, params)
  with torch.no_grad():
    out = model(torch.from_numpy(video), torch.from_numpy(qp))
  return {k: v.numpy() for k, v in out.items() if not k.startswith("un")}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax(clip, route, option):
  params, video, qp = clip
  overrides = dict(ROUTES[route], **OPTIONS[option])
  ref = _jax_out(params, video, qp, overrides)
  out = _port_out(params, video, qp, overrides)
  np.testing.assert_allclose(out["tracks"], ref["tracks"], rtol=0,
                             atol=TRACK_TOL)
  for key in ("occlusion", "expected_dist"):
    np.testing.assert_allclose(out[key], ref[key], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_per_frame_extraction_rounds_query_times(clip):
  """At query times between frames the per-frame extraction takes the
  nearest frame's sample where the default interpolates in time: the query
  descriptors differ, and equal the default's at the rounded times."""
  params, video, qp = clip
  model = tapir.TAPIR(tapir.bootstapir_config(**SMALL))
  load_flax_params(model, params)
  per_frame = tapir.TAPIR(tapir.bootstapir_config(
      **SMALL, parallelize_query_extraction=True))
  load_flax_params(per_frame, params)
  v, q = torch.from_numpy(video), torch.from_numpy(qp)
  rounded = q.clone()
  rounded[..., 0] = torch.round(rounded[..., 0])
  with torch.no_grad():
    grids = model.get_feature_grids(v)
    fractional = model.get_query_features(v.shape, q, grids).lowres[0]
    ours = per_frame.get_query_features(v.shape, q, grids).lowres[0]
    at_rounded = model.get_query_features(v.shape, rounded, grids).lowres[0]
  assert (ours - fractional).abs().max() > 1e-2
  np.testing.assert_allclose(ours.numpy(), at_rounded.numpy(), rtol=0,
                             atol=1e-6)


def test_chunked_backbone_keeps_the_grids(clip):
  """Chunks of 2 frames (2, 2, 1) give the unchunked run's grids, and the
  ExtraConvs run once, on all frames."""
  params, video, _ = clip
  grids = {}
  for chunk in (None, 2):
    model = tapir.TAPIR(tapir.bootstapir_config(
        **SMALL, feature_extractor_chunk_size=chunk))
    load_flax_params(model, params)
    calls = []
    model.extra.register_forward_hook(
        lambda mod, args, out: calls.append(args[0].shape[0]))
    with torch.no_grad():
      grids[chunk] = model.get_feature_grids(torch.from_numpy(video))
    assert calls == [B * T]
  for a, b in zip(grids[None].lowres + grids[None].hires,
                  grids[2].lowres + grids[2].hires):
    assert a.shape == b.shape
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("route", ["tents", "gathers", "sampled"])
def test_int8_flag_is_ignored_off_the_kernel_route(clip, route, monkeypatch):
  """quantized_corr="per_frame" on a route without an int8 form: the float
  route's result, and no grid or query is quantized (as in JAX, which
  quantizes only on its kernel's route)."""
  params, video, qp = clip
  calls = []
  for name in ("quantize_per_frame", "quantize_per_position",
               "corr_tent_patches", "corr_tent_patches_prequantized",
               "corr_tent_patches_prequantized_per_position"):
    real = getattr(corr_tents, name)
    monkeypatch.setattr(
        corr_tents, name,
        lambda *a, _name=name, _real=real, **k: calls.append(_name)
        or _real(*a, **k))
  float_out = _port_out(params, video, qp, ROUTES[route])
  int8_out = _port_out(params, video, qp,
                       dict(ROUTES[route], quantized_corr="per_frame"))
  assert not calls, calls
  for key in float_out:
    np.testing.assert_array_equal(int8_out[key], float_out[key])

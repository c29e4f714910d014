"""PyTorch port, the whole TAPIR at a small BootsTAPIR-shaped config against
the JAX TAPIR in fp32: the module, `TapirPredictor(device="cpu")` with query
padding and chunking, the video resize that feeds the backbone, and the int8
configurations (w8a8 mixer with per-frame int8 correlation; per-position int8
correlation; the JAX package's headline configuration, which adds the
per-frame int8 ExtraConvs; the per-pixel int8 ExtraConvs) against the JAX
TAPIR with the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.models import tapir as jax_tapir
from tapnet_tpu.ops import fused_extra_convs as jax_fec
from tapnet_tpu_torch.checkpoints.convert import load_flax_params
from tapnet_tpu_torch.inference import TapirPredictor
from tapnet_tpu_torch.models import tapir
from tapnet_tpu_torch.ops import fused_extra_convs

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


# ------------------------------------------------------------ int8 configs

INT8_CONFIGS = {
    "a_mixer_per_frame": dict(quantized_mixer=True, quantized_corr="per_frame"),
    "b_per_position": dict(quantized_corr=True),
    "c_headline": dict(quantized_mixer=True, quantized_extra_convs=True,
                       quantized_corr="per_frame"),
}
# Both sides run the same exact integer products on bit-equal int8 values;
# they differ by float32 noise and, where that noise moves a value across a
# rounding boundary, by one int8 or bf16 step of one correlation or hidden
# value, carried through the remaining refinement steps. Per configuration:
# the limits on tracks (px) and logits against JAX, about 4x (a, c) and 10x
# (b) what was measured (tracks 7.6e-3, 1e-4 and 0.065 px, logits 4.7e-3,
# 1.1e-4 and 0.026), and the least shift from the port's own full-precision
# output that shows the int8 mode ran, about half of what was measured
# (tracks 0.064, 0.021 and 3.65 px at most; the shift stays under 10x that
# least one). Each limit is under its configuration's shift, so the
# full-precision computation in place of the int8 one fails both checks. In
# c the per-frame int8 ExtraConvs requantize every layer's input, so a step
# that float32 noise moves in one layer changes the next layer's inputs at 9
# pixels and every channel (bit-equal on identical inputs, 0.03 apart after
# 5 layers at C = 32).
INT8_TOL = {
    "a_mixer_per_frame": dict(tracks=0.03, logits=2e-2, min_shift=0.03),
    "b_per_position": dict(tracks=1e-3, logits=1e-3, min_shift=0.01),
    "c_headline": dict(tracks=0.3, logits=0.1, min_shift=1.5),
}


@pytest.fixture(scope="module")
def torch_full_tracks(small_model):
  """The port's own full-precision tracks on the small clip."""
  params, video, qp, _ = small_model
  model = tapir.TAPIR(tapir.bootstapir_config(**SMALL))
  load_flax_params(model, params)
  with torch.no_grad():
    return model(torch.from_numpy(video), torch.from_numpy(qp))["tracks"].numpy()


# The configurations whose refinement loop differs from the float one; the
# chunking and per-video quantization tests run these (c adds only the
# backbone's int8 ExtraConvs to a).
REFINEMENT_CONFIGS = ["a_mixer_per_frame", "b_per_position"]


@pytest.fixture(scope="module")
def int8_model(request, small_model):
  """JAX outputs of the small clip in the int8 configuration named by the
  test's indirect parameter."""
  params, video, qp, _ = small_model
  overrides = INT8_CONFIGS[request.param]
  model = jax_tapir.TAPIR(config=jax_tapir.bootstapir_config(**SMALL, **overrides))
  out = jax.jit(lambda p, v, q: model.apply({"params": p}, v, q))(
      params, jnp.asarray(video), jnp.asarray(qp)
  )
  return overrides, params, video, qp, jax.device_get(out), INT8_TOL[request.param]


def _check_int8(out, ref, tol):
  np.testing.assert_allclose(
      np.asarray(out["tracks"]), ref["tracks"], rtol=0, atol=tol["tracks"]
  )
  for key in ("occlusion", "expected_dist"):
    np.testing.assert_allclose(
        np.asarray(out[key]), ref[key], rtol=0, atol=tol["logits"]
    )


@pytest.mark.parametrize("int8_model", sorted(INT8_CONFIGS), indirect=True)
def test_int8_tapir_matches_jax(int8_model, torch_full_tracks):
  overrides, params, video, qp, ref, tol = int8_model
  model = tapir.TAPIR(tapir.bootstapir_config(**SMALL, **overrides))
  load_flax_params(model, params)
  with torch.no_grad():
    out = model(torch.from_numpy(video), torch.from_numpy(qp))
  _check_int8({k: v.numpy() for k, v in out.items() if not k.startswith("un")},
              ref, tol)
  for ours, theirs in zip(out["unrefined_tracks"], ref["unrefined_tracks"]):
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=tol["tracks"])
  # The int8 mode really ran: the result is as far from the port's own
  # full-precision one as this configuration's quantization moves it.
  shift = np.abs(out["tracks"].numpy() - torch_full_tracks).max()
  assert tol["min_shift"] < shift < 10 * tol["min_shift"]


@pytest.mark.parametrize("chunk,bucket", [(4, 8), (6, 1)],
                         ids=["chunk_lt_n", "chunk_eq_n"])
@pytest.mark.parametrize("int8_model", REFINEMENT_CONFIGS, indirect=True)
def test_int8_predictor_matches_jax(int8_model, chunk, bucket):
  """Buckets, chunks and track_many with the int8 configurations: the grids
  are quantized once per video, whatever the chunking."""
  overrides, params, video, qp, ref, tol = int8_model
  predictor = TapirPredictor(
      params, tapir.bootstapir_config(**SMALL, **overrides),
      query_bucket=bucket, query_chunk_size=chunk, device="cpu",
  )
  out = predictor(video, qp)
  assert out["tracks"].shape == (B, N, T, 2)
  _check_int8(out, ref, tol)
  many = list(predictor.track_many([(video, qp), (video, qp[:, :3])]))
  np.testing.assert_array_equal(many[0]["tracks"], out["tracks"])
  assert many[1]["tracks"].shape == (B, 3, T, 2)


@pytest.mark.parametrize("int8_model", REFINEMENT_CONFIGS, indirect=True)
def test_per_frame_grids_are_quantized_once_per_video(int8_model, monkeypatch):
  overrides, params, video, qp, _, _ = int8_model
  from tapnet_tpu_torch.ops import corr_tents

  calls = []
  real = corr_tents.quantize_per_frame
  monkeypatch.setattr(
      corr_tents, "quantize_per_frame",
      lambda g: calls.append(tuple(g.shape)) or real(g),
  )
  predictor = TapirPredictor(
      params, tapir.bootstapir_config(**SMALL, **overrides),
      query_bucket=1, query_chunk_size=2, device="cpu",
  )
  predictor(video, qp)
  if overrides["quantized_corr"] == "per_frame":
    # 2 refinement resolutions x 3 pyramid grids, not x 3 chunks x 2 steps.
    assert len(calls) == 6, calls
  else:
    assert not calls


@pytest.mark.parametrize("int8_model", REFINEMENT_CONFIGS, indirect=True)
def test_per_position_grids_are_quantized_once_per_video(int8_model, monkeypatch):
  """Configuration b quantizes each pyramid grid once per video
  (`quantize_per_position`) and every chunk and refinement step takes the
  pre-quantized entry, never the inline `quantized=True` one; the result
  still matches JAX, which quantizes inline in every call."""
  overrides, params, video, qp, ref, tol = int8_model
  from tapnet_tpu_torch.ops import corr_tents

  calls, entries = [], []
  real_quantize = corr_tents.quantize_per_position
  real_entry = corr_tents.corr_tent_patches_prequantized_per_position
  real_inline = corr_tents.corr_tent_patches
  monkeypatch.setattr(
      corr_tents, "quantize_per_position",
      lambda g: calls.append(tuple(g.shape)) or real_quantize(g))
  monkeypatch.setattr(
      corr_tents, "corr_tent_patches_prequantized_per_position",
      lambda *a: entries.append(tuple(a[0].shape)) or real_entry(*a))

  def inline(*args):
    assert not (len(args) > 5 and args[5] is True), "inline per-position call"
    return real_inline(*args)

  monkeypatch.setattr(corr_tents, "corr_tent_patches", inline)
  predictor = TapirPredictor(
      params, tapir.bootstapir_config(**SMALL, **overrides),
      query_bucket=1, query_chunk_size=2, device="cpu",
  )
  out = predictor(video, qp)
  if overrides["quantized_corr"] is True:
    # 2 refinement resolutions x 3 pyramid grids, not x 3 chunks x 2 steps.
    assert len(calls) == 6, calls
    assert len(entries) == 6 * 3 * 2, len(entries)
    _check_int8(out, ref, tol)
  else:
    assert not calls and not entries


@pytest.mark.parametrize("mode", [False, True, "per_pixel"])
def test_quantized_extra_convs_modes_build(mode):
  """Each ExtraConvs mode is accepted and reaches the model's stack."""
  model = tapir.TAPIR(tapir.bootstapir_config(**SMALL, quantized_extra_convs=mode))
  assert model.extra.quantized == mode


@pytest.mark.parametrize("mode", ["per_frame", "pixel", 2])
def test_quantized_extra_convs_rejects_other_values(mode):
  with pytest.raises(ValueError, match="quantized_extra_convs"):
    tapir.TapirConfig(quantized_extra_convs=mode)
  with pytest.raises(ValueError, match="quantized_corr"):
    tapir.TapirConfig(quantized_corr="per_pixel")


# The per-pixel int8 ExtraConvs at C = 128 with the JAX gate's size threshold
# lowered to 1 on both sides (the real gate needs 4 * 1024 * 1024 elements,
# a clip too long for these tests; tests/test_torch_golden.py has one). Each
# layer matches JAX to 1e-6 on identical inputs, but on grids of 8 x 8 and
# 12 x 10 pixels the rare int8 step that float32 noise moves (a few per
# layer) reaches 9 of the grid's pixels in every channel, and the next
# layer's per-pixel scales carry it on: after 5 layers most feature values
# differ a little. Measured: tracks 0.031 px in the median and 0.086 px at
# most, logits 0.017. The limits are about 3x that.
PER_PIXEL_TOL = dict(median_px=0.1, tracks=0.3, logits=0.05)


def test_per_pixel_extra_convs_tapir_matches_jax(small_model, monkeypatch):
  monkeypatch.setattr(jax_fec, "_MIN_FUSED_ELEMENTS", 1)
  monkeypatch.setattr(fused_extra_convs, "_MIN_FUSED_ELEMENTS", 1)
  _, video, qp, _ = small_model
  small = dict(SMALL, lowres_dim=128, quantized_extra_convs="per_pixel")
  jmodel = jax_tapir.TAPIR(config=jax_tapir.bootstapir_config(**small))
  args = (jnp.asarray(video), jnp.asarray(qp))
  params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *args)["params"]
  noise = np.random.RandomState(4)
  params = jax.tree_util.tree_map(
      lambda x: np.asarray(x) + 0.02 * noise.randn(*x.shape).astype(np.float32),
      jax.device_get(params))
  ref = jax.device_get(jax.jit(lambda p, v, q: jmodel.apply({"params": p}, v, q))(
      params, *args))

  model = tapir.TAPIR(tapir.bootstapir_config(**small))
  load_flax_params(model, params)
  calls = []
  real = fused_extra_convs.extra_convs_layer
  monkeypatch.setattr(fused_extra_convs, "extra_convs_layer",
                      lambda *a, **k: calls.append(1) or real(*a, **k))
  before = fused_extra_convs.LAUNCHES
  with torch.no_grad():
    out = model(torch.from_numpy(video), torch.from_numpy(qp))
  # 5 layers at each of the two backbone resolutions (64x64, 96x80); CPU
  # tensors launch nothing.
  assert len(calls) == 10 and fused_extra_convs.LAUNCHES == before
  err = np.linalg.norm(out["tracks"].numpy() - ref["tracks"], axis=-1)
  assert np.median(err) <= PER_PIXEL_TOL["median_px"], np.median(err)
  assert err.max() <= PER_PIXEL_TOL["tracks"], err.max()
  for key in ("occlusion", "expected_dist"):
    np.testing.assert_allclose(out[key].numpy(), ref[key], rtol=0,
                               atol=PER_PIXEL_TOL["logits"])

"""PyTorch port, online/causal TAPIR against the JAX package: the streaming
and warm-up temporal block, PipsMixer with a cache, the causal state and its
update, `estimate_trajectories` with a causal state (chunked and not), and
`OnlineTapirPredictor(device="cpu")` (init, predict, add_points) at small
widths, in float and in the int8 configurations a and c, and the quantized
streaming MixerBlock against Flax's `mlp_block_q8` path; the stream against
the port's own offline causal model; the trained
full-width model against the JAX stream in
tests/data/bootstapir_golden_online.npz. Inputs and weights come from numpy
seeds and Flax `init`, and reach both frameworks as numpy arrays.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu import inference as jax_inference
from tapnet_tpu.models import layers as jax_layers
from tapnet_tpu.models import tapir as jax_tapir
from tapnet_tpu_torch.checkpoints.convert import load_flax_params
from tapnet_tpu_torch.checkpoints.tapir_checkpoint import load_tapir_checkpoint
from tapnet_tpu_torch.inference import OnlineTapirPredictor
from tapnet_tpu_torch.models import layers, tapir
from tapnet_tpu_torch.utils.sampling import preprocess_frames
from tools import make_online_golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests/data/bootstapir_golden.npz")
GOLDEN_ONLINE = os.path.join(REPO, "tests/data/bootstapir_golden_online.npz")

# fp32 on both sides: summation order in convolutions and matmuls.
BLOCK_TOL = 1e-5
TOL = 1e-4
TRACK_TOL = 1e-4


def _perturbed(params, seed=0, scale=0.05):
  rng = np.random.RandomState(seed)
  return jax.tree_util.tree_map(
      lambda x: np.asarray(x) + scale * rng.randn(*x.shape).astype(np.float32),
      jax.device_get(params),
  )


def _np(x):
  if isinstance(x, torch.Tensor):
    return x.float().numpy()
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------- temporal block


def _temporal_pair(causal, c=8, k=3):
  flax_block = jax_layers.TemporalDepthwiseBlock(kernel_size=k, causal=causal,
                                                 features=c)
  x = jnp.zeros((2, 3, 4, c), jnp.float32)
  params = _perturbed(flax_block.init(jax.random.PRNGKey(0), x)["params"])
  block = layers.TemporalDepthwiseBlock(c, k)
  load_flax_params(block, params)
  return flax_block, params, block


def _cache(rng, lead, k, c, mult=4):
  return (rng.randn(*lead, k - 1, c).astype(np.float32),
          rng.randn(*lead, k - 1, mult * c).astype(np.float32))


@pytest.mark.parametrize("t", [1, 3], ids=["one_frame", "three_frames"])
def test_temporal_block_streaming_matches_flax(t):
  """[cache ++ x] in VALID mode, the hidden lanes expanded group-major: the
  output and the new cache, leading axes [B, N]."""
  flax_block, params, block = _temporal_pair(causal=True)
  rng = np.random.RandomState(t)
  x = rng.randn(2, 3, t, 8).astype(np.float32)
  pre, mid = _cache(rng, (2, 3), 3, 8)
  ref, ref_cache = flax_block.apply(
      {"params": params}, jnp.asarray(x),
      jax_layers.ConvCache(jnp.asarray(pre), jnp.asarray(mid)), True)
  with torch.no_grad():
    out, cache = block(torch.from_numpy(x),
                       layers.ConvCache(torch.from_numpy(pre),
                                        torch.from_numpy(mid)), True)
  np.testing.assert_allclose(_np(out), _np(ref), rtol=BLOCK_TOL, atol=BLOCK_TOL)
  for ours, theirs in zip(cache, ref_cache):
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(_np(ours), _np(theirs), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "same"])
def test_temporal_block_warm_up_matches_flax(causal):
  """No cache, `return_cache`: zero-padded convs over a clip, and the cache
  taken from its tail. The port streams causal blocks only, from a zero
  cache; a non-causal MixerBlock refuses a warm-up, whose SAME padding
  would read frames past the ones its cache keeps."""
  flax_block, params, block = _temporal_pair(causal=causal)
  x = np.random.RandomState(5).randn(6, 5, 8).astype(np.float32)
  ref, ref_cache = flax_block.apply({"params": params}, jnp.asarray(x), None,
                                    True)
  if not causal:
    with pytest.raises(ValueError, match="causal"):
      layers.MixerBlock(8, 3, causal=False)(torch.from_numpy(x), None, True)
    return
  with torch.no_grad():
    out, cache = block(torch.from_numpy(x), None, True)
  np.testing.assert_allclose(_np(out), _np(ref), rtol=BLOCK_TOL, atol=BLOCK_TOL)
  for ours, theirs in zip(cache, ref_cache):
    np.testing.assert_allclose(_np(ours), _np(theirs), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_temporal_block_bf16_with_fp32_state(param_dtype):
  """bf16 activations against a float32 cache: [cache ++ x] promotes to
  float32 in both frameworks, so the output and the new cache are float32
  and agree to float32 noise, whichever the parameters' dtype."""
  flax_block, params, block = _temporal_pair(causal=True)
  if param_dtype == "bfloat16":
    params = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.bfloat16), params)
    load_flax_params(block, jax.tree_util.tree_map(
        lambda v: np.array(v.astype(jnp.float32)), params))
    block = block.to(torch.bfloat16)
  rng = np.random.RandomState(2)
  x = rng.randn(4, 1, 8).astype(np.float32)
  pre, mid = _cache(rng, (4,), 3, 8)
  x_j = jnp.asarray(x, jnp.bfloat16)
  ref, ref_cache = flax_block.apply(
      {"params": params}, x_j,
      jax_layers.ConvCache(jnp.asarray(pre), jnp.asarray(mid)), True)
  with torch.no_grad():
    out, cache = block(torch.from_numpy(x).bfloat16(),
                       layers.ConvCache(torch.from_numpy(pre),
                                        torch.from_numpy(mid)), True)
  assert ref.dtype == jnp.float32 and out.dtype == torch.float32
  assert all(v.dtype == torch.float32 for v in cache)
  assert all(v.dtype == jnp.float32 for v in ref_cache)
  np.testing.assert_allclose(_np(out), _np(ref), rtol=BLOCK_TOL, atol=BLOCK_TOL)
  for ours, theirs in zip(cache, ref_cache):
    np.testing.assert_allclose(_np(ours), _np(theirs), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)


# ------------------------------------------------------------ PipsMixer


def _mixer_pair():
  flax_mixer = jax_layers.PipsMixer(output_channels=12, hidden_dim=16,
                                    num_blocks=2, causal=True)
  x = jnp.zeros((4, 3, 20), jnp.float32)
  params = _perturbed(flax_mixer.init(jax.random.PRNGKey(0), x)["params"])
  mixer = layers.PipsMixer(input_channels=20, output_channels=12,
                           hidden_dim=16, num_blocks=2, causal=True)
  load_flax_params(mixer, params)
  return flax_mixer, params, mixer


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_pips_mixer_streams_like_flax(x_dtype):
  """Warm-up on a 4-frame clip, then three one-frame steps with the cache
  threaded through: outputs and caches against Flax. In bf16 the cache
  stays float32 and so does everything after it."""
  flax_mixer, params, mixer = _mixer_pair()
  rng = np.random.RandomState(4)
  clip = rng.randn(4, 4, 20).astype(np.float32)
  steps = rng.randn(3, 4, 1, 20).astype(np.float32)
  jdt = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
  tdt = torch.bfloat16 if x_dtype == "bfloat16" else torch.float32
  ref, ref_cache = flax_mixer.apply({"params": params},
                                    jnp.asarray(clip, jdt), None, True)
  with torch.no_grad():
    out, cache = mixer(torch.from_numpy(clip).to(tdt), None, True)
  np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL, atol=TOL)
  for step in steps:
    ref, ref_cache = flax_mixer.apply({"params": params},
                                      jnp.asarray(step, jdt), ref_cache, True)
    with torch.no_grad():
      out, cache = mixer(torch.from_numpy(step).to(tdt), cache, True)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL, atol=TOL)
    for ours, theirs in zip(cache, ref_cache):
      assert tuple(ours.shape) == theirs.shape
      np.testing.assert_allclose(_np(ours), _np(theirs), rtol=TOL, atol=TOL)
  zero = mixer.init_cache((4,))
  ref_zero = flax_mixer.init_cache((4,))
  assert [tuple(v.shape) for v in zero] == [v.shape for v in ref_zero]
  assert all(v.dtype == torch.float32 and not v.any() for v in zero)


def test_quantized_streaming_mixer_block_matches_mlp_block_q8():
  """A w8a8 causal MixerBlock streaming with a cache (a 4-frame warm-up,
  then three one-frame steps) against Flax's MixerBlock(quantized=True),
  whose unfused path runs `mixer_math.mlp_block_q8`: outputs and caches.
  The int8 products are exact on both sides; float32 noise in the
  LayerNorm stays far from the int8 rounding boundaries of these inputs."""
  c = 16
  flax_block = jax_layers.MixerBlock(causal=True, quantized=True)
  x = jnp.zeros((4, 3, c), jnp.float32)
  params = _perturbed(flax_block.init(jax.random.PRNGKey(0), x)["params"],
                      seed=2, scale=0.1)
  block = layers.MixerBlock(c, causal=True, quantized=True)
  load_flax_params(block, params)
  apply = jax.jit(lambda x, cache: flax_block.apply({"params": params}, x,
                                                   cache, True))
  rng = np.random.RandomState(5)
  clip = rng.randn(4, 4, c).astype(np.float32)
  ref, ref_cache = apply(jnp.asarray(clip), None)
  with torch.no_grad():
    out, cache = block(torch.from_numpy(clip), None, True)
  np.testing.assert_allclose(_np(out), _np(ref), rtol=BLOCK_TOL, atol=BLOCK_TOL)
  # The int8 MLP really ran: the float block's output is elsewhere.
  float_block = layers.MixerBlock(c, causal=True)
  load_flax_params(float_block, params)
  with torch.no_grad():
    float_out, _ = float_block(torch.from_numpy(clip), None, True)
  assert np.abs(_np(float_out) - _np(ref)).max() > 1e-3
  for step in rng.randn(3, 4, 1, c).astype(np.float32):
    ref, ref_cache = apply(jnp.asarray(step), ref_cache)
    with torch.no_grad():
      out, cache = block(torch.from_numpy(step), cache, True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)
    for ours, theirs in zip(cache, ref_cache):
      np.testing.assert_allclose(_np(ours), _np(theirs), rtol=BLOCK_TOL,
                                 atol=BLOCK_TOL)


def test_pips_mixer_without_cache_returns_the_output_only():
  _, _, mixer = _mixer_pair()
  x = torch.from_numpy(np.random.RandomState(1).randn(4, 5, 20).astype(np.float32))
  with torch.no_grad():
    out = mixer(x)
    streamed, _ = mixer(x, mixer.init_cache((4,)), True)
  assert isinstance(out, torch.Tensor)
  # A zero cache is the causal zero padding of the offline block.
  np.testing.assert_allclose(_np(streamed), _np(out), rtol=TOL, atol=TOL)


# ------------------------------------------------------ tiny causal TAPIR

TINY = dict(
    num_mixer_blocks=2, blocks_per_group=(1, 1, 1, 1), highres_dim=16,
    lowres_dim=32, mixer_hidden_dim=32, initial_resolution=(64, 64),
    num_pips_iter=2,
)
B, T, H, W, N = 1, 5, 64, 64, 6


@pytest.fixture(scope="module")
def tiny_causal():
  """The causal BootsTAPIR at small widths (2 mixer blocks, one ResNet block
  per group, ExtraConvs), JAX params perturbed by numpy noise, a 5-frame
  64x64 clip (one refinement resolution) and 6 queries on frame 0."""
  cfg_j = jax_tapir.causal_bootstapir_config(**TINY)
  model = jax_tapir.TAPIR(config=cfg_j)
  rng = np.random.RandomState(0)
  video = (rng.rand(B, T, H, W, 3) * 2 - 1).astype(np.float32)
  qp = np.stack([np.zeros(N), rng.rand(N) * (H - 8) + 4,
                 rng.rand(N) * (W - 8) + 4], -1)[None].astype(np.float32)
  params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(video[:, :2]),
                               jnp.asarray(qp))["params"]
  params = _perturbed(params, seed=1, scale=0.02)
  port = tapir.TAPIR(tapir.causal_bootstapir_config(**TINY))
  load_flax_params(port, params)
  return model, params, port.eval(), video, qp


def test_causal_state_construction_and_update(tiny_causal):
  model, params, port, _, _ = tiny_causal
  ref = model.apply({"params": params}, 1, N, 1,
                    method=jax_tapir.TAPIR.construct_initial_causal_state)
  state = port.construct_initial_causal_state(1, N, 1)
  assert [tuple(v.shape) for v in state] == [v.shape for v in ref]
  assert state.pre.shape == (2, 2, 1, N, 2, 32)
  assert state.mid.shape == (2, 2, 1, N, 2, 128)
  assert all(v.dtype == torch.float32 and not v.any() for v in state)
  assert state.num_points() == N

  rng = np.random.RandomState(3)
  old = [rng.randn(1, N, 8).astype(np.float32) for _ in range(4)]
  new = [rng.randn(1, 2, 8).astype(np.float32) for _ in range(4)]
  st = [rng.randn(*v.shape).astype(np.float32) for v in state]
  fresh = [rng.randn(*(v.shape[:3] + (2,) + v.shape[4:])).astype(np.float32)
           for v in state]
  before = [a.copy() for a in old + st]
  qf_j = lambda a: jax_tapir.QueryFeatures(tuple(map(jnp.asarray, a[:2])),
                                           tuple(map(jnp.asarray, a[2:])), ())
  qf_t = lambda a: tapir.QueryFeatures(tuple(map(torch.from_numpy, a[:2])),
                                       tuple(map(torch.from_numpy, a[2:])), ())
  ref_qf, ref_state = jax_tapir.update_query_features(
      qf_j(old), qf_j(new), [4, 1],
      jax_tapir.TapirCausalState(*map(jnp.asarray, st)),
      jax_tapir.TapirCausalState(*map(jnp.asarray, fresh)))
  got_qf, got_state = tapir.update_query_features(
      qf_t(old), qf_t(new), [4, 1],
      tapir.TapirCausalState(*map(torch.from_numpy, st)),
      tapir.TapirCausalState(*map(torch.from_numpy, fresh)))
  for ours, theirs in zip(got_qf.lowres + got_qf.hires + tuple(got_state),
                          ref_qf.lowres + ref_qf.hires + tuple(ref_state)):
    np.testing.assert_array_equal(_np(ours), _np(theirs))
  for kept, was in zip(old + st, before):  # the inputs are not modified
    np.testing.assert_array_equal(kept, was)
  only_qf = tapir.update_query_features(qf_t(old), qf_t(new), [0, 2])
  assert isinstance(only_qf, tapir.QueryFeatures)
  with pytest.raises(ValueError, match="fresh_state"):
    tapir.update_query_features(qf_t(old), qf_t(new), [0, 2],
                                tapir.TapirCausalState(*map(torch.from_numpy, st)))


def _trajectories(tiny_causal, chunk, state):
  """JAX's and the port's estimate_trajectories on frame 1 of the clip with
  the causal state `state` and `get_causal_context`."""
  model, params, port, video, qp = tiny_causal
  frame = video[:, 1:2]

  def jax_run(params, frame, qp, pre, mid):
    grids = model.apply({"params": params}, frame,
                        method=jax_tapir.TAPIR.get_feature_grids)
    qf = model.apply({"params": params}, frame.shape, qp, grids,
                     method=jax_tapir.TAPIR.get_query_features)
    return model.apply(
        {"params": params}, frame.shape[-3:-1], grids, qf, None, chunk,
        jax_tapir.TapirCausalState(pre, mid), True,
        method=jax_tapir.TAPIR.estimate_trajectories)

  ref = jax.jit(jax_run)(params, jnp.asarray(frame), jnp.asarray(qp),
                         *map(jnp.asarray, state))
  with torch.no_grad():
    frame_t = torch.from_numpy(frame)
    grids = port.get_feature_grids(frame_t)
    qf = port.get_query_features(frame_t.shape, torch.from_numpy(qp), grids)
    out = port.estimate_trajectories(
        (H, W), grids, qf, None, chunk,
        tapir.TapirCausalState(*map(torch.from_numpy, state)), True)
  return out, ref


@pytest.fixture(scope="module")
def random_state(tiny_causal):
  rng = np.random.RandomState(7)
  return [rng.randn(*v.shape).astype(np.float32) * 0.5
          for v in tiny_causal[2].construct_initial_causal_state(1, N, 1)]


def test_estimate_trajectories_with_causal_state_matches_flax(tiny_causal,
                                                              random_state):
  """One frame with a random (non-zero) state, one query chunk: every
  iteration's tracks and logits and the new state against Flax."""
  out, ref = _trajectories(tiny_causal, None, random_state)
  assert len(out["tracks"]) == len(ref["tracks"]) == 3
  for key, tol in (("tracks", TRACK_TOL), ("occlusion", TOL),
                   ("expected_dist", TOL)):
    for ours, theirs in zip(out[key], ref[key]):
      np.testing.assert_allclose(_np(ours), _np(theirs), rtol=tol, atol=tol)
  for ours, theirs in zip(out["causal_context"], ref["causal_context"]):
    assert tuple(ours.shape) == theirs.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(_np(ours), _np(theirs), rtol=TOL, atol=TOL)


def test_chunked_causal_state_is_in_query_order(tiny_causal, random_state):
  """Two chunks of 4 (the 6 queries padded with query 0): tracks and logits
  against Flax, and the new state equal to the one-chunk state, in query
  order. JAX's chunked branch merges the state with
  `moveaxis(x, 0, 4)` (tapnet_tpu/models/tapir.py:956), which puts the
  chunk axis after the in-chunk axis: its state holds query ch*4 + i at
  slot i*2 + ch. The test pins that down rather than copy it."""
  chunk = 4
  out, ref = _trajectories(tiny_causal, chunk, random_state)
  whole, _ = _trajectories(tiny_causal, None, random_state)
  for key, tol in (("tracks", TRACK_TOL), ("occlusion", TOL),
                   ("expected_dist", TOL)):
    for ours, theirs in zip(out[key], ref[key]):
      np.testing.assert_allclose(_np(ours), _np(theirs), rtol=tol, atol=tol)
  chunks = -(-N // chunk)
  jax_slot = [ch * chunk + i for i in range(chunk) for ch in range(chunks)][:N]
  jax_slot = [q if q < N else 0 for q in jax_slot]  # padding repeats query 0
  for ours, one_chunk, theirs in zip(out["causal_context"],
                                     whole["causal_context"],
                                     ref["causal_context"]):
    np.testing.assert_allclose(_np(ours), _np(one_chunk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(ours)[:, :, :, jax_slot], _np(theirs),
                               rtol=TOL, atol=TOL)


def _stream(predictor, frames, qp, new_qp):
  return make_online_golden.run_stream(predictor.init, predictor.step,
                                       predictor.add_points, frames, qp, new_qp)


def test_online_predictor_matches_jax(tiny_causal):
  """init, a step per frame and add_points (slots 0 and 5 at frame 4)
  against JAX's OnlineTapirPredictor, fp32."""
  _, params, _, video, qp = tiny_causal
  new_qp = qp[:, [2, 3]] + np.float32([0, 3, -2])
  cfg_j = jax_tapir.causal_bootstapir_config(**TINY)
  jax_pred = jax_inference.OnlineTapirPredictor(params, cfg_j)

  def jax_step(frame):
    tracks, visibles = jax_pred.predict(frame)
    return dict(tracks=tracks, visibles=visibles)

  ref = make_online_golden.run_stream(jax_pred.init, jax_step,
                                      jax_pred.add_points, video, qp, new_qp)
  port = OnlineTapirPredictor(params, tapir.causal_bootstapir_config(**TINY),
                              device="cpu")
  out = _stream(port, video, qp, new_qp)
  assert out["tracks"].shape == ref["tracks"].shape == (T, B, N, 2)
  np.testing.assert_allclose(out["tracks"], ref["tracks"], rtol=0,
                             atol=TRACK_TOL)
  # Visibility flags equal wherever the port's probability is not within
  # float32 noise of the threshold.
  prob = ((1 - 1 / (1 + np.exp(-out["occlusion"])))
          * (1 - 1 / (1 + np.exp(-out["expected_dist"]))))
  clear = np.abs(prob - 0.5) > 1e-4
  np.testing.assert_array_equal(out["visibles"][clear], ref["visibles"][clear])


# The int8 stream against JAX's: both sides run the same exact integer
# products on bit-equal int8 values and differ by float32 noise, and where
# that noise moves a value across a rounding boundary, by one int8 step,
# carried through the stream. Limit on the tracks (px): each configuration's
# offline int8 limit of tests/test_torch_tapir.py (INT8_TOL); at least 95%
# of the visibility flags equal.
ONLINE_INT8_TRACK_TOL = {"a": 0.03, "c": 0.3}


@pytest.mark.parametrize("name", ["a", "c"])
def test_online_predictor_guards(tiny_causal, name):
  """A non-causal configuration is refused, and a card is required unless
  device="cpu"; an int8 configuration streams as JAX's OnlineTapirPredictor
  does, each step quantizing its own frame, add_points included (slots 0
  and 5 at frame 4): a, the w8a8 mixer and the per-frame int8 correlation;
  c, a with the per-frame int8 ExtraConvs and 2 refinement steps."""
  from tools.golden_clip import INT8_CONFIGS

  with pytest.raises(ValueError, match="use_causal_conv"):
    OnlineTapirPredictor({}, tapir.bootstapir_config(), device="cpu")
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="CUDA"):
      OnlineTapirPredictor({}, tapir.causal_tapir_config())
  _, params, _, video, qp = tiny_causal
  new_qp = qp[:, [2, 3]] + np.float32([0, 3, -2])
  overrides = dict(TINY, **INT8_CONFIGS[name])
  jax_pred = jax_inference.OnlineTapirPredictor(
      params, jax_tapir.causal_bootstapir_config(**overrides))

  def jax_step(frame):
    tracks, visibles = jax_pred.predict(frame)
    return dict(tracks=tracks, visibles=visibles)

  ref = make_online_golden.run_stream(jax_pred.init, jax_step,
                                      jax_pred.add_points, video, qp, new_qp)
  port = OnlineTapirPredictor(
      params, tapir.causal_bootstapir_config(**overrides), device="cpu")
  out = _stream(port, video, qp, new_qp)
  assert out["tracks"].shape == ref["tracks"].shape == (T, B, N, 2)
  np.testing.assert_allclose(out["tracks"], ref["tracks"], rtol=0,
                             atol=ONLINE_INT8_TRACK_TOL[name])
  assert np.mean(out["visibles"] == ref["visibles"]) >= 0.95


def test_stream_equals_offline_causal_model(tiny_causal):
  """The stream, frame by frame, against the port's offline causal model on
  the whole clip (queries on frame 0, no query points passed to stage 1, as
  the stream passes none)."""
  _, params, port, video, qp = tiny_causal
  online = OnlineTapirPredictor(params, port.config, device="cpu")
  online.init(video[:, 0], qp)
  steps = [online.step(video[:, t]) for t in range(T)]
  with torch.no_grad():
    v = torch.from_numpy(video)
    grids = port.get_feature_grids(v)
    qf = port.get_query_features(v.shape, torch.from_numpy(qp), grids)
    out = port.estimate_trajectories((H, W), grids, qf, None)
  p = port.config.num_pips_iter
  tracks = torch.stack(out["tracks"][p::p]).mean(0).numpy()  # [B, N, T, 2]
  occ = torch.stack(out["occlusion"][p::p]).mean(0).numpy()
  np.testing.assert_allclose(np.stack([s["tracks"] for s in steps], 2), tracks,
                             rtol=0, atol=TRACK_TOL)
  np.testing.assert_allclose(np.stack([s["occlusion"] for s in steps], 2), occ,
                             rtol=TOL, atol=TOL)


# ------------------------------------------------ trained, full width


@pytest.fixture(scope="module")
def trained_params():
  return load_tapir_checkpoint(os.path.join(
      REPO, "runs/bootstapir_synth/trained_params_f16.npy"))


def test_trained_tree_loads_into_the_causal_configs(trained_params):
  """Causality changes no parameter shape: the trained BootsTAPIR tree loads
  into causal_bootstapir_config() as it is, and without its ExtraConvs into
  causal_tapir_config()."""
  load_flax_params(tapir.TAPIR(tapir.causal_bootstapir_config()), trained_params)
  plain = {k: v for k, v in trained_params.items() if k != "extra"}
  assert len(plain) == len(trained_params) - 1
  load_flax_params(tapir.TAPIR(tapir.causal_tapir_config()), plain)
  with pytest.raises(ValueError, match="no model parameter"):
    load_flax_params(tapir.TAPIR(tapir.causal_tapir_config()), trained_params)


# The full-width trained model on the CPU against the JAX stream, fp32: the
# BootsTAPIR golden limits of PERF.md section 2 (0.05 px, 5e-3 on logits).
GOLDEN_FP32_TOL = dict(tracks=0.05, logits=5e-3)


def test_online_trained_model_matches_jax_golden(trained_params):
  golden = np.load(GOLDEN_ONLINE)
  frames = preprocess_frames(torch.from_numpy(np.load(GOLDEN)["video"])).numpy()
  predictor = OnlineTapirPredictor(trained_params,
                                   tapir.causal_bootstapir_config(),
                                   device="cpu")
  out = _stream(predictor, frames, golden["query_points"],
                golden["new_query_points"])
  assert out["tracks"].shape == golden["float32_tracks"].shape == (8, 1, 32, 2)
  np.testing.assert_allclose(out["tracks"], golden["float32_tracks"], rtol=0,
                             atol=GOLDEN_FP32_TOL["tracks"])
  for key in ("occlusion", "expected_dist"):
    np.testing.assert_allclose(out[key], golden[f"float32_{key}"], rtol=0,
                               atol=GOLDEN_FP32_TOL["logits"])
  assert np.mean(out["visibles"] == golden["float32_visibles"]) >= 0.99


# The port's int8 stream c on the card sits this far from JAX's in the
# logits on the golden clip (chip_smoke.py's online-golden-int8, on the
# queries within the offline limits; PERF.md section 6).
CARD_C_LOGIT_DISTANCE = 0.52


def test_int8_c_stream_sits_within_jaxs_own_spread():
  """JAX's own int8 stream c on the golden clip nudged by each of
  make_online_golden.SPREAD_ULPS float32 ulps (tests/data/
  bootstapir_golden_online_c_spread.npz) moves its logits, on the queries
  within the offline track limits, as far as the card's stream sits from
  JAX's: float32 noise, not a fault. The +16-ulp stream is the committed
  witness bit for bit, and the port's plain stream on the CPU lies within
  the spread too."""
  spread = np.load(make_online_golden.OUT_SPREAD)
  golden = np.load(make_online_golden.OUT_INT8)
  for key in ("tracks", "visibles", "occlusion", "expected_dist"):
    np.testing.assert_array_equal(spread[f"nudged16_{key}"],
                                  golden[f"c_nudged_{key}"])
  distances = make_online_golden.spread_distances(spread, golden)
  nudges = {k: v for k, v in distances.items() if k.startswith("nudged")}
  assert len(nudges) == len(make_online_golden.SPREAD_ULPS) >= 5
  jax_spread = max(v["logit_max_abs_kept"] for v in nudges.values())
  assert jax_spread >= CARD_C_LOGIT_DISTANCE, distances
  assert distances["port_cpu"]["logit_max_abs_kept"] <= jax_spread, distances

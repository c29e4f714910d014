"""PyTorch port, TRAJAN: the attention stack and the track autoencoder
against the JAX package with the same seed-made weights
(tools/trajan_weights.py) through the port's converter, and the example.

Narrow widths (examples/trajan_roundtrip.py's small model, with a decoder
of 384 channels so that the time window has room to clamp), float32,
outputs within 1e-5 (float32 sums in other orders). The cases: a support
track never visible and frames past `boundary_frame` (fully masked
attention rows, uniform weights in Flax), late query frames (JAX's dynamic
slice clamps the time window), the default 32 x 32 query grid, chunked
decoding, and the dither fed with JAX's own draw and its straight-through
gradient. JAX runs op by op (no jit), as tools/make_trajan_golden.py
explains. The decoder embeds the query's sinusoidal embedding again, at
frequencies up to 1290, so the last bit of the first embedding's sines
moves its outputs: where the decoder runs, the limit is 1e-5 or 3 x JAX's
own distance when that embedding is nudged one ulp, whichever is larger
(that tool's witness). The full-width model is held to that tool's
numbers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

import jax
import jax.numpy as jnp

from tapnet_tpu.trajan import attention as jax_attention
from tapnet_tpu.trajan import track_autoencoder as jax_tae
from tapnet_tpu_torch.checkpoints import convert
from tapnet_tpu_torch.examples import trajan_roundtrip
from tapnet_tpu_torch.trajan import attention, track_autoencoder
from tools import make_trajan_golden
from tools.trajan_weights import seeded_trajan_params

TOL = 1e-5
SMALL = dict(num_output_frames=24, num_latent_tokens=8, latent_token_dim=16,
             encoder_latent_dim=64, track_token_dim=32,
             decoder_num_channels=384, time_feat_dim=128)
B, Q, T, NQ = 1, 6, 24, 8
OUTPUTS = ("tracks", "visible_logits", "certain_logits")


def _close(port, ref, tol=TOL):
  np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                             rtol=tol, atol=tol)


def _inputs(seed=0):
  """One clip of support tracks, track 1 never visible, padded past frame
  15, and queries up to frame 59 (the window of a frame past 25 clamps at
  5 * 25.6 = 256 - 128 channels)."""
  rng = np.random.RandomState(seed)
  vis = (rng.rand(B, Q, T, 1) > 0.3).astype(np.float32)
  vis[0, 1] = 0.0
  qp = np.stack([rng.randint(0, 60, (B, NQ)).astype(np.float32),
                 rng.rand(B, NQ), rng.rand(B, NQ)], -1).astype(np.float32)
  qp[0, 0, 0] = 59.0
  return dict(support_tracks=rng.rand(B, Q, T, 2).astype(np.float32),
              support_tracks_visible=vis,
              boundary_frame=np.array([15], np.int32), query_points=qp)


def _noise(shape=(B, SMALL["num_latent_tokens"], SMALL["latent_token_dim"])):
  return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape))


@pytest.fixture(scope="module")
def small():
  params = seeded_trajan_params(0, **SMALL)
  model = track_autoencoder.TrackAutoEncoder(**SMALL)
  convert.load_trajan_params(model, params)
  return params, model


def _jax_forward(params, inputs):
  """JAX's forward (`decode(encode(x), context)`, as `__call__` runs it
  without chunks) and the decoder's limit: max(TOL, 3 x JAX's distance
  under a one-ulp nudge of the decoder's query embedding), per output."""
  jm = jax_tae.TrackAutoEncoder(**SMALL)
  apply = lambda *a, **k: jm.apply({"params": params}, *a, **k)
  latents = apply(inputs, method=jax_tae.TrackAutoEncoder.encode)
  ctx = apply(inputs, method=jax_tae.TrackAutoEncoder.get_decoder_context)
  nudged = ctx.replace(decoder_query=jnp.nextafter(ctx.decoder_query,
                                                   jnp.float32(jnp.inf)))
  base = apply(latents, ctx, method=jax_tae.TrackAutoEncoder.decode)
  moved = apply(latents, nudged, method=jax_tae.TrackAutoEncoder.decode)
  return base, {k: max(TOL, 3 * float(np.abs(np.asarray(getattr(base, k))
                                             - np.asarray(getattr(moved, k))
                                             ).max()))
                for k in OUTPUTS}


def _port_inputs(inputs):
  return {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}


# ------------------------------------------------------------- attention


def test_transformer_masked_rows_against_flax():
  """A mask of the tokens' rank gains the heads axis; a row with no key
  attends to every key uniformly (Flax's finfo.min), not NaN."""
  rng = np.random.RandomState(1)
  x = rng.randn(2, 3, 7, 32).astype(np.float32)
  kv = rng.randn(2, 3, 5, 16).astype(np.float32)
  qq = rng.rand(2, 3, 7, 7) > 0.5
  qq[0, 0] = False  # every row of one sequence fully masked
  qk = rng.rand(2, 3, 7, 5) > 0.5
  qk[1, 2, 3] = False
  module = jax_attention.ImprovedTransformer(qkv_size=64, num_heads=4,
                                             mlp_size=48, num_layers=2)
  variables = module.init(jax.random.PRNGKey(0), x, kv, qq, qk)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32) * 0.1,
      variables["params"])
  ref = module.apply({"params": params}, x, kv, qq, qk)
  port = attention.ImprovedTransformer(32, qkv_size=64, num_heads=4,
                                       mlp_size=48, num_layers=2, kv_width=16)
  convert.load_trajan_params(port, params)
  out = port(torch.from_numpy(x), torch.from_numpy(kv), torch.from_numpy(qq),
             torch.from_numpy(qk))
  assert torch.isfinite(out).all()
  _close(out, ref)


def test_fully_masked_row_is_uniform():
  q = torch.randn(1, 4, 2, 8)
  k = torch.randn(1, 5, 2, 8)
  v = torch.randn(1, 5, 2, 8)
  out = attention.dot_product_attention(q, k, v, torch.zeros(1, 1, 4, 5))
  _close(out, v.mean(1, keepdim=True).expand_as(out).numpy(), 1e-6)


# ------------------------------------------------------------ autoencoder


def test_encode_against_jax(small):
  params, model = small
  inputs = _inputs()
  ref = jax_tae.TrackAutoEncoder(**SMALL).apply(
      {"params": params}, inputs, method=jax_tae.TrackAutoEncoder.encode)
  _close(model.encode(_port_inputs(inputs)), ref)


@pytest.mark.parametrize("grid", [False, True])
def test_forward_against_jax(small, grid):
  """The whole model with JAX's dither fed: the given queries (with late
  frames), or the default 32 x 32 grid."""
  params, model = small
  inputs = _inputs()
  if grid:
    del inputs["query_points"]
  ref, limit = _jax_forward(params, inputs)
  out = model(_port_inputs(inputs), noise=torch.from_numpy(_noise()))
  for key in OUTPUTS:
    _close(getattr(out, key), getattr(ref, key), limit[key])
  if grid:
    assert out.tracks.shape == (B, 1024, T, 2)
  assert torch.equal(out.visible_and_certain,
                     torch.from_numpy(np.asarray(ref.visible_and_certain)))


def test_chunked_against_one_pass(small):
  params, model = small
  inputs = _inputs()
  ref, limit = _jax_forward(params, inputs)
  chunked = track_autoencoder.TrackAutoEncoder(**SMALL, decoder_chunk_size=4)
  chunked.load_state_dict(model.state_dict())
  noise = torch.from_numpy(_noise())
  out = chunked(_port_inputs(inputs), noise=noise)
  one = model(_port_inputs(inputs), noise=noise)
  for key in OUTPUTS:
    _close(getattr(out, key), getattr(one, key).detach())
    _close(getattr(out, key), getattr(ref, key), limit[key])
  with pytest.raises(ValueError, match="multiple"):
    track_autoencoder.TrackAutoEncoder(**SMALL, decoder_chunk_size=3)(
        _port_inputs(inputs), noise=noise)


def test_time_window_clamps_like_dynamic_slice():
  model = track_autoencoder.TrackAutoEncoder(**SMALL)
  latents = torch.arange(256, dtype=torch.float32).expand(1, 2, 256)
  frames = torch.tensor([[0, 3, 25, 26, 59, -4]])
  out = model._append_time_feat(latents, frames)  # pylint: disable=protected-access
  starts = out[0, :, 0, 256].long().tolist()
  assert starts == [0, 15, 125, 128, 128, 0]


def test_discretize_straight_through_gradient(small):
  """decode with JAX's dither: the outputs, and the gradient of their sum
  with respect to the latents through the straight-through quantizer,
  against jax.grad."""
  params, model = small
  inputs = _inputs()
  jm = jax_tae.TrackAutoEncoder(**SMALL)
  noise = _noise()
  latents = np.asarray(jm.apply({"params": params}, inputs,
                                method=jax_tae.TrackAutoEncoder.encode))

  def total(lat):
    ctx = jm.apply({"params": params}, inputs,
                   method=jax_tae.TrackAutoEncoder.get_decoder_context)
    res = jm.apply({"params": params}, lat, ctx, True, jax.random.PRNGKey(0),
                   method=jax_tae.TrackAutoEncoder.decode)
    return jnp.sum(res.tracks) + jnp.sum(res.visible_logits)

  ref_value, ref_grad = jax.value_and_grad(total)(jnp.asarray(latents))
  lat = torch.from_numpy(latents.copy()).requires_grad_()
  res = model.decode(lat, model.get_decoder_context(_port_inputs(inputs)),
                     noise=torch.from_numpy(noise))
  value = res.tracks.sum() + res.visible_logits.sum()
  value.backward()
  np.testing.assert_allclose(float(value), float(ref_value), rtol=1e-5)
  scale = float(np.abs(ref_grad).max())
  _close(lat.grad, ref_grad, 1e-4 * scale)
  assert float(lat.grad.abs().max()) > 0
  # Without discretize the decoder sees the clipped latents themselves.
  ctx = jm.apply({"params": params}, inputs,
                 method=jax_tae.TrackAutoEncoder.get_decoder_context)
  ref = jm.apply({"params": params}, jnp.asarray(latents), ctx, False,
                 method=jax_tae.TrackAutoEncoder.decode)
  out = model.decode(torch.from_numpy(latents),
                     model.get_decoder_context(_port_inputs(inputs)),
                     discretize=False)
  _close(out.tracks, ref.tracks)


def test_trajan_golden():
  """The published widths against tools/make_trajan_golden.py's JAX
  numbers, within that tool's limits."""
  golden = np.load(make_trajan_golden.OUT)
  r = make_trajan_golden.judge(golden,
                               *make_trajan_golden.run_port(golden, "cpu"))
  assert r["ok"], r


def test_converter_rejects_unknown_leaves(small):
  params, _ = small
  with pytest.raises(ValueError, match="Unmapped"):
    convert.trajan_to_state_dict({"compressor": {"offset": np.zeros(2)}})
  model = track_autoencoder.TrackAutoEncoder(**SMALL)
  with pytest.raises(ValueError, match="no model parameter"):
    convert.load_trajan_params(model, dict(params, extra={"bias": np.zeros(2)}))


def test_roundtrip_example_cpu(capsys):
  out = trajan_roundtrip.main(["--device", "cpu", "--num_tracks", "4"])
  assert out.tracks.shape == (1, 4, 150, 2)
  assert torch.isfinite(out.tracks).all()
  assert "mean reconstruction error" in capsys.readouterr().out


def test_roundtrip_example_checkpoint(tmp_path):
  """--checkpoint: the Flax tree saved with np.save, at the published
  widths."""
  path = str(tmp_path / "trajan.npy")
  np.save(path, seeded_trajan_params(0), allow_pickle=True)
  out = trajan_roundtrip.main(["--device", "cpu", "--num_tracks", "2",
                               "--checkpoint", path])
  assert out.tracks.shape == (1, 2, 150, 2)

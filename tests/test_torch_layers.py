"""PyTorch port, layers: ResNet, ExtraConvs (full precision and both int8
modes), PipsMixer (full precision and w8a8) and CostVolumeHead against the
Flax modules at narrow widths, in fp32. Params come from the Flax
`init`, are perturbed with numpy noise (so zero-initialised convs and unit
norms do real work), and reach the port through the weight bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.models import layers as jax_layers
from tapnet_tpu.models import resnet as jax_resnet
from tapnet_tpu.models import tapir as jax_tapir
from tapnet_tpu.ops import fused_extra_convs as jax_fec
from tapnet_tpu.ops import mixer_math as jax_mixer_math
from tapnet_tpu.ops import qconv as jax_qconv
from tapnet_tpu_torch.checkpoints.convert import load_flax_params
from tapnet_tpu_torch.models import layers, resnet, tapir
from tapnet_tpu_torch.ops import fused_extra_convs

# fp32 on both sides; the differences are summation order in convolutions
# and matmuls (~1e-6 relative), amplified a little through the norms.
TOL = 1e-4


def _perturbed(params, seed=0, scale=0.05):
  rng = np.random.RandomState(seed)
  return jax.tree_util.tree_map(
      lambda x: np.asarray(x) + scale * rng.randn(*x.shape).astype(np.float32),
      params,
  )


def _init(module, *args):
  params = jax.jit(module.init)(jax.random.PRNGKey(0), *args)["params"]
  return _perturbed(jax.device_get(params))


def _apply(module, params, *args):
  return jax.jit(module.apply)({"params": params}, *args)


def _nhwc(x):
  return x.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("hw", [(32, 32), (27, 29)], ids=["even", "odd"])
def test_resnet_matches_flax(hw):
  """Even and odd inputs exercise Flax's asymmetric SAME padding of the
  stride-2 convs (7x7 stem and the 3x3 group convs)."""
  cfg_kwargs = dict(
      blocks_per_group=(1, 1, 1, 1), channels_per_group=(8, 16, 16, 32),
      stem_channels=8,
  )
  flax_model = jax_resnet.ResNet(config=jax_resnet.ResNetConfig(**cfg_kwargs))
  x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
  params = _init(flax_model, jnp.asarray(x))
  ref = _apply(flax_model, params, jnp.asarray(x))

  model = resnet.ResNet(resnet.ResNetConfig(**cfg_kwargs))
  load_flax_params(model, params)
  with torch.no_grad():
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
  for g in range(4):
    key = f"group_{g}"
    np.testing.assert_allclose(
        _nhwc(out[key]), np.asarray(ref[key]), rtol=TOL, atol=TOL
    )


def test_extra_convs_matches_flax():
  flax_model = jax_layers.ExtraConvs(num_layers=2)
  x = np.random.RandomState(2).randn(3, 6, 5, 8).astype(np.float32)
  params = _init(flax_model, jnp.asarray(x))
  ref = _apply(flax_model, params, jnp.asarray(x))

  model = layers.ExtraConvs(channels=8, num_layers=2)
  load_flax_params(model, params)
  with torch.no_grad():
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
  np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=TOL, atol=TOL)


# The int8 ExtraConvs: bit-equal quantizers and exact integer products on
# both sides, so the layers differ by float32 noise and, where it moves a
# value across an int8 rounding boundary, a step of it carried through the
# second layer. Outputs are O(1) to O(10).
EXTRA_Q8_TOL = 5e-3


@pytest.mark.parametrize(
    "quantized,c,gate_open",
    [(True, 8, False), ("per_pixel", 8, False), (True, 128, True),
     ("per_pixel", 128, True), ("per_pixel", 128, False)],
    ids=["frame_c8", "pixel_c8_per_frame_math", "frame_c128_gate_open",
         "pixel_c128_fused", "pixel_c128_gate_closed"],
)
def test_quantized_extra_convs_match_flax(quantized, c, gate_open, monkeypatch):
  """Both int8 modes against the Flax ExtraConvs. The JAX gate
  `wants_fused` picks the per-pixel math only for 4-D inputs of at least
  4 * 1024 * 1024 elements with C % 128 == 0; `gate_open` lowers that size
  on both sides to 1, so the 2 x 6 x 5 x 128 input takes it. Elsewhere
  "per_pixel" is the per-frame scheme, in both packages."""
  if gate_open:
    monkeypatch.setattr(jax_fec, "_MIN_FUSED_ELEMENTS", 1)
    monkeypatch.setattr(fused_extra_convs, "_MIN_FUSED_ELEMENTS", 1)
  flax_model = jax_layers.ExtraConvs(num_layers=2, quantized=quantized)
  x = np.random.RandomState(4).randn(2, 6, 5, c).astype(np.float32)
  params = _init(flax_model, jnp.asarray(x))
  ref = _apply(flax_model, params, jnp.asarray(x))
  model = layers.ExtraConvs(channels=c, num_layers=2, quantized=quantized)
  load_flax_params(model, params)
  calls = []
  real = fused_extra_convs.extra_convs_layer
  monkeypatch.setattr(fused_extra_convs, "extra_convs_layer",
                      lambda *a, **k: calls.append(1) or real(*a, **k))
  with torch.no_grad():
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
  assert len(calls) == (2 if quantized == "per_pixel" and gate_open else 0)
  np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=EXTRA_Q8_TOL,
                             atol=EXTRA_Q8_TOL)
  # The int8 modes are not the float stack, and each is its own scheme.
  full = layers.ExtraConvs(channels=c, num_layers=2)
  load_flax_params(full, params)
  with torch.no_grad():
    ref_full = full(torch.from_numpy(x).permute(0, 3, 1, 2))
  diff = float((ref_full - out).abs().max())
  assert 0 < diff < 0.1 * float(ref_full.abs().max())


def test_quantized_extra_convs_weights_are_cached():
  """One set of int8 weights per layer, equal to JAX's bit for bit, made
  anew when the float weight changes; none in the state dict."""
  model = layers.ExtraConvs(channels=8, num_layers=2, quantized=True)
  torch.manual_seed(0)
  for p in model.parameters():
    torch.nn.init.normal_(p, std=0.1)
  wuq, su, woq, so = model.quantized_weights(1)
  assert model.quantized_weights(1)[0] is wuq
  assert model.quantized_weights(0)[0] is not wuq
  hwio = model.conv_up_1.weight.detach().permute(2, 3, 1, 0).numpy()
  ws = jax_fec._w_scales(jnp.asarray(hwio))
  np.testing.assert_array_equal(su.numpy(), np.asarray(ws))
  wq = np.clip(np.round(hwio / np.asarray(ws)), -127, 127).astype(np.int8)
  np.testing.assert_array_equal(wuq.numpy(), wq.transpose(3, 0, 1, 2))
  assert woq.shape == (8, 3, 3, 32) and so.shape == (8,)
  assert not any("q" in k.split(".")[-1] for k in model.state_dict())
  with torch.no_grad():
    model.conv_out_1.weight.mul_(2.0)
  torch.testing.assert_close(model.quantized_weights(1)[3], so * 2.0)
  assert model.quantized_weights(1)[0] is not wuq


@pytest.mark.parametrize("causal", [False, True])
def test_pips_mixer_matches_flax(causal):
  flax_model = jax_layers.PipsMixer(
      output_channels=12, hidden_dim=16, num_blocks=2, causal=causal
  )
  # T = 10 is not a multiple of 8.
  x = np.random.RandomState(3).randn(4, 10, 20).astype(np.float32)
  params = _init(flax_model, jnp.asarray(x))
  ref, _ = _apply(flax_model, params, jnp.asarray(x))

  model = layers.PipsMixer(
      input_channels=20, output_channels=12, hidden_dim=16, num_blocks=2,
      causal=causal,
  )
  load_flax_params(model, params)
  with torch.no_grad():
    out = model(torch.from_numpy(x))
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


# The w8a8 mixer: integer arithmetic is exact on both sides and the int8
# weights are bit equal, so most outputs agree to float32 noise; where that
# noise moves an activation across a rounding boundary, one int8 step of one
# value (about 1/127 of a row's largest hidden value times a weight) passes
# through the remaining blocks. Outputs are O(1).
Q8_TOL = 2e-2


def _quantized_mixer_pair(causal):
  flax_model = jax_layers.PipsMixer(
      output_channels=12, hidden_dim=16, num_blocks=2, causal=causal,
      quantized=True,
  )
  x = np.random.RandomState(3).randn(4, 10, 20).astype(np.float32)
  params = _init(flax_model, jnp.asarray(x))
  model = layers.PipsMixer(
      input_channels=20, output_channels=12, hidden_dim=16, num_blocks=2,
      causal=causal, quantized=True,
  )
  load_flax_params(model, params)
  return flax_model, params, model, x


@pytest.mark.parametrize("causal", [False, True])
def test_quantized_pips_mixer_matches_flax(causal):
  flax_model, params, model, x = _quantized_mixer_pair(causal)
  ref, _ = _apply(flax_model, params, jnp.asarray(x))
  with torch.no_grad():
    out = model(torch.from_numpy(x))
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=Q8_TOL, atol=Q8_TOL)
  assert np.mean(np.abs(out.numpy() - np.asarray(ref)) > 1e-4) < 0.2
  # It is the full-precision mixer up to quantization noise, and not equal.
  full = layers.PipsMixer(
      input_channels=20, output_channels=12, hidden_dim=16, num_blocks=2,
      causal=causal,
  )
  load_flax_params(full, params)
  with torch.no_grad():
    diff = (full(torch.from_numpy(x)) - out).abs().max()
  assert 0 < float(diff) < 0.3


def test_quantized_weights_are_cached_and_follow_the_weights():
  """The int8 weights are made once per module, equal JAX's bit for bit,
  and are made anew after load_state_dict, an in-place update or .to()."""
  _, params, model, x = _quantized_mixer_pair(False)
  block = model.block_0
  w1q, s1, w2q, s2 = block.quantized_weights()
  assert block.quantized_weights()[0] is w1q
  up = params["block_0"]["fc_up"]["kernel"]
  jq, js = jax_mixer_math.quantize_weight_cols(jnp.asarray(up))
  np.testing.assert_array_equal(w1q.numpy(), np.asarray(jq))
  np.testing.assert_array_equal(s1.numpy(), np.asarray(js))
  assert w1q.shape == (16, 64) and w1q.t().is_contiguous()
  assert w2q.shape == (64, 16) and w2q.t().is_contiguous()
  assert "_qweights" not in "".join(model.state_dict())

  with torch.no_grad():
    before = model(torch.from_numpy(x))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    state["block_0.fc_up.weight"] *= 0.5
    model.load_state_dict(state)
    assert block.quantized_weights()[0] is not w1q
    torch.testing.assert_close(block.quantized_weights()[1], s1 * 0.5)
    assert not torch.equal(model(torch.from_numpy(x)), before)
    block.fc_down.weight.mul_(2.0)
    torch.testing.assert_close(block.quantized_weights()[3], s2 * 2.0)
    cached = block.quantized_weights()[0]
    model.to(torch.bfloat16)
    assert block.quantized_weights()[0] is not cached
    assert block.quantized_weights()[1].dtype == torch.float32


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)], ids=["even", "odd"])
def test_cost_volume_head_matches_flax(hw):
  b, n, t, c = 1, 3, 4, 8
  h, w = hw
  rng = np.random.RandomState(4)
  qf = rng.randn(b, n, c).astype(np.float32)
  grid = rng.randn(b, t, h, w, c).astype(np.float32)
  im_shape = (b, t, h * 8, w * 8, 3)
  qp = np.stack(
      [rng.randint(0, t, n), rng.rand(n) * h * 8, rng.rand(n) * w * 8], -1
  )[None].astype(np.float32)
  flax_model = jax_tapir.CostVolumeHead(softmax_temperature=10.0)
  jargs = (jnp.asarray(qf), jnp.asarray(grid), jnp.asarray(qp))
  params = jax.jit(lambda k, *a: flax_model.init(k, *a, im_shape))(
      jax.random.PRNGKey(0), *jargs)["params"]
  params = _perturbed(jax.device_get(params))
  ref = jax.jit(lambda p, *a: flax_model.apply({"params": p}, *a, im_shape))(
      params, *jargs)

  model = tapir.CostVolumeHead(softmax_temperature=10.0)
  load_flax_params(model, params)
  with torch.no_grad():
    out = model(torch.from_numpy(qf), torch.from_numpy(grid),
                torch.from_numpy(qp), im_shape)
  for o, r in zip(out, ref):
    np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=TOL, atol=TOL)


def _mixer_params():
  flax_model = jax_layers.PipsMixer(output_channels=6, hidden_dim=8,
                                    num_blocks=1)
  return _init(flax_model, jnp.zeros((1, 5, 7)))


def _torch_mixer():
  return layers.PipsMixer(input_channels=7, output_channels=6, hidden_dim=8,
                          num_blocks=1)


def test_bridge_layouts():
  params = _mixer_params()
  model = _torch_mixer()
  load_flax_params(model, params)
  up = params["block_0"]["fc_up"]["kernel"]
  dw = params["block_0"]["temporal"]["dw_up"]["kernel"]
  np.testing.assert_array_equal(model.block_0.fc_up.weight.detach().numpy(), up.T)
  np.testing.assert_array_equal(model.block_0.temporal.dw_up.weight.detach().numpy(), dw)


@pytest.mark.parametrize("fault", ["unknown_leaf", "missing", "shape"])
def test_bridge_raises(fault):
  params = _mixer_params()
  if fault == "unknown_leaf":
    params["ln_out"]["mystery"] = np.zeros(8, np.float32)
  elif fault == "missing":
    del params["block_0"]["fc_down"]
  else:
    params["in_proj"]["bias"] = np.zeros(9, np.float32)
  with pytest.raises(ValueError):
    load_flax_params(_torch_mixer(), params)

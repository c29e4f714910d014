"""PyTorch port, the gradients of the hand-written kernels' entries against
the JAX package's custom VJPs: `jax.vjp` of each JAX entry (on the CPU its
plain reference forward and its `_bwd`) against `torch.autograd.grad`
through the port's entry (`ops._vjp.PlainVjp`: the VJP of the plain math,
recomputed from the inputs), on the same inputs and cotangent from a numpy
seed. K1 (corr-tents), K2 and K2b (its int8 modes, straight-through), K3
and K4 (the mixer block, w8a8 straight-through), K6f and K6 (the ExtraConvs
layer), X (the per-frame int8 conv) and the streaming w8a8 MLP.

Limits: float32, 1e-5 of the largest |g| of each input (sums in another
order through the same plain math); bfloat16 (K1 and K3 only; the other
entries train in float32), the forward's own bf16 limits per unit of the
largest |g| (tests/test_torch_ops.py: corr-tents 2e-2, a bf16 step of
|corr| <= 1; the mixer 5e-2, a few bf16 steps). The int8 forms are held to
the float32 limit: their backward reads only the inputs and the cotangent.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

import jax
import jax.numpy as jnp

from tapnet_tpu.ops import corr_tents as jax_corr
from tapnet_tpu.ops import fused_extra_convs as jax_fec
from tapnet_tpu.ops import fused_mixer_block as jax_mixer
from tapnet_tpu.ops import mixer_math as jax_mm
from tapnet_tpu.ops import qconv as jax_qconv
from tapnet_tpu_torch.ops import (
    _vjp, corr_tents, fused_extra_convs, fused_mixer_block, mixer_math, qconv,
)

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
FP32_REL = 1e-5
BF16_REL = {"corr": 2e-2, "mixer": 5e-2}


def _both(arrays, dtype, float_index=None):
  """(jax arrays, torch tensors requiring grad) of `arrays` in `dtype`
  (float32 for the indices not in `float_index`, when given)."""
  jargs, targs = [], []
  for i, a in enumerate(arrays):
    d = dtype if float_index is None or i in float_index else "float32"
    jargs.append(jnp.asarray(a).astype(JDT[d]))
    targs.append(torch.from_numpy(a).to(TDT[d]).requires_grad_())
  return jargs, targs


def _check(jax_fn, torch_fn, arrays, dtype="float32", rel=FP32_REL,
           float_index=None, seed=99):
  """Gradients of every input under one cotangent, port against JAX, each
  within rel * max|g| of that input."""
  jargs, targs = _both(arrays, dtype, float_index)
  out = jax.eval_shape(jax_fn, *jargs)
  rng = np.random.RandomState(seed)
  cot = rng.randn(*out.shape).astype(np.float32)
  want = jax.jit(lambda c, *a: jax.vjp(jax_fn, *a)[1](c))(
      jnp.asarray(cot).astype(out.dtype), *jargs)
  got_out = torch_fn(*targs)
  assert got_out.grad_fn is not None
  got = torch.autograd.grad(got_out, targs,
                            torch.from_numpy(cot).to(got_out.dtype))
  for i, (g, w) in enumerate(zip(got, want)):
    w = np.asarray(w.astype(jnp.float32))
    g = g.float().numpy()
    assert g.shape == w.shape, i
    scale = float(np.abs(w).max())
    assert scale > 0, i
    err = float(np.abs(g - w).max())
    assert err <= rel * scale, (i, err, scale)


def corr_inputs(seed=0, bt=3, h=12, w=10, c=8, n=5):
  rng = np.random.RandomState(seed)
  grid = rng.randn(bt, h, w, c).astype(np.float32)
  grid /= np.linalg.norm(grid, axis=-1, keepdims=True)
  query = rng.randn(bt, n, c).astype(np.float32)
  query /= np.linalg.norm(query, axis=-1, keepdims=True)
  cy = (rng.rand(bt, n) * (h + 6) - 3).astype(np.float32)
  cx = (rng.rand(bt, n) * (w + 6) - 3).astype(np.float32)
  return [grid, query, cy, cx]


@pytest.mark.parametrize(
    "quantized,dtype",
    [(False, "float32"), (False, "bfloat16"), ("per_frame", "float32"),
     (True, "float32")], ids=["K1", "K1_bf16", "K2", "K2b"])
def test_corr_tents_vjp_matches_jax(quantized, dtype):
  """K1's VJP, and K2's and K2b's straight-through (JAX `_bwd`: the VJP of
  `_math_reference` whatever the mode), in grid, query, cy and cx."""
  _check(lambda g, q, y, x: jax_corr.corr_tent_patches(g, q, y, x, 7, quantized),
         lambda g, q, y, x: corr_tents.corr_tent_patches(g, q, y, x, 7, quantized),
         corr_inputs(), dtype,
         FP32_REL if dtype == "float32" else BF16_REL["corr"],
         float_index=(0, 1))


def mixer_inputs(seed=0, b=3, t=10, c=16, hid=64, k=3, mult=4):
  rng = np.random.RandomState(seed)
  f = lambda *s: rng.randn(*s).astype(np.float32)
  return [f(b, t, c) * 0.5, f(c) * 0.2 + 1.0, f(k, 1, mult * c) * 0.3,
          f(mult * c) * 0.1, f(k, 1, mult * c) * 0.3, f(mult * c) * 0.1,
          f(c) * 0.2 + 1.0, f(c, hid) * 0.1, f(hid) * 0.1, f(hid, c) * 0.1,
          f(c) * 0.1]


@pytest.mark.parametrize("quantized", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("causal", [False, True])
def test_mixer_block_vjp_matches_jax(quantized, causal):
  """K3's VJP and K4's straight-through (JAX `_bwd`: the VJP of the
  full-precision `_math_reference`), in x and all ten parameters."""
  _check(lambda *a: jax_mixer.mixer_block(*a, causal, None, quantized),
         lambda *a: fused_mixer_block.mixer_block(*a, causal,
                                                  quantized=quantized),
         mixer_inputs(seed=int(causal)))


def test_mixer_block_vjp_bf16_matches_jax():
  _check(lambda *a: jax_mixer.mixer_block(*a, False, None, False),
         lambda *a: fused_mixer_block.mixer_block(*a, False),
         mixer_inputs(seed=2), "bfloat16", BF16_REL["mixer"])


def test_mixer_block_q8_gradient_needs_float_weights():
  args = [torch.from_numpy(a).requires_grad_() for a in mixer_inputs()]
  w1, w2 = args[7], args[9]
  qweights = (*mixer_math.quantize_weight_cols(w1.detach()),
              *mixer_math.quantize_weight_cols(w2.detach()))
  args[7] = args[9] = None
  out = fused_mixer_block.mixer_block(*args, quantized=True, qweights=qweights)
  with pytest.raises(ValueError, match="needs w1 and w2"):
    out.sum().backward()


def extra_convs_inputs(seed=0, n=2, h=6, w=5, c=8, mult=4):
  rng = np.random.RandomState(seed)
  f = lambda *s: rng.randn(*s).astype(np.float32)
  return [f(n, h, w, c) * 0.5, f(c) * 0.2 + 1.0, f(c) * 0.1,
          f(3, 3, c, mult * c) * 0.2, f(mult * c) * 0.1,
          f(3, 3, mult * c, c) * 0.1, f(c) * 0.1]


@pytest.mark.parametrize("quantized", [False, True], ids=["K6f", "K6"])
def test_extra_convs_vjp_matches_jax(quantized):
  """K6f's VJP and K6's straight-through (JAX `_bwd`: the VJP of
  `_math_reference(quantized=False)`)."""
  _check(lambda *a: jax_fec.extra_convs_layer(*a, quantized),
         lambda *a: fused_extra_convs.extra_convs_layer(*a, quantized),
         extra_convs_inputs())


def test_conv2d_q8_vjp_matches_jax():
  """X straight-through (JAX `_q8_bwd`: the VJP of `conv2d_fp_math`); the
  port's layouts are NCHW and OIHW."""
  rng = np.random.RandomState(3)
  x = rng.randn(2, 7, 6, 8).astype(np.float32)
  k = (rng.randn(3, 3, 8, 12) * 0.2).astype(np.float32)
  b = (rng.randn(12) * 0.1).astype(np.float32)
  _check(lambda x, k, b: jax_qconv.conv2d_q8(x, k, b).transpose(0, 3, 1, 2),
         lambda x, k, b: qconv.conv2d_q8(x.permute(0, 3, 1, 2),
                                         k.permute(3, 2, 0, 1), b),
         [x, k, b])


def test_mlp_block_q8_vjp_matches_jax():
  """The streaming w8a8 MLP straight-through (JAX `mlp_block_q8`)."""
  args = mixer_inputs(seed=4)
  ln, w1, b1, w2, b2 = args[6:]
  _check(jax_mm.mlp_block_q8, mixer_math.mlp_block_q8,
         [args[0], ln, w1, b1, w2, b2])


def test_plain_vjp_is_the_plain_gradient_and_runs_alone_without_one():
  """Through `_vjp.apply` the gradient is the plain function's, bit for bit,
  whatever the forward computes; without a gradient to record, nothing is
  saved and the output has no grad_fn."""
  x = torch.randn(4, 3, requires_grad=True)
  plain = lambda v: (v * v).sum(-1)
  out = _vjp.apply(lambda v: torch.zeros(4), plain, x)
  (g,) = torch.autograd.grad(out, x, torch.arange(4.0))
  (want,) = torch.autograd.grad(plain(x), x, torch.arange(4.0))
  assert torch.equal(g, want)
  with torch.no_grad():
    assert _vjp.apply(lambda v: v.sum(-1), plain, x).grad_fn is None
  assert _vjp.apply(lambda v: v.sum(-1), plain, x.detach()).grad_fn is None


def test_prequantized_routes_refuse_a_gradient():
  grid, query, cy, cx = (torch.from_numpy(a) for a in corr_inputs())
  query.requires_grad_()
  with pytest.raises(ValueError, match="no gradient"):
    corr_tents.corr_tent_patches_prequantized(
        *corr_tents.quantize_per_frame(grid), query, cy, cx)
  with pytest.raises(ValueError, match="no gradient"):
    corr_tents.corr_tent_patches_prequantized_per_position(
        *corr_tents.quantize_per_position(grid), query, cy, cx)

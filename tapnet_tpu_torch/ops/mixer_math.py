"""Plain PyTorch math of the PIPs-mixer sub-blocks.

Port of tapnet_tpu/ops/mixer_math.py: the depthwise temporal conv pair, the
residual channel MLP, and its w8a8 int8 form with its quantizers. These are
the plain versions that `ops.fused_mixer_block.mixer_block` runs on CPU
tensors and that its CUDA kernels are held against. Layouts are the JAX ones: depthwise kernels
[k, 1, mult*C] with c-major flat index c*mult + m, dense weights [in, out].
GELU is the tanh approximation; accumulations are float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tapnet_tpu_torch.ops import _vjp

_LN_EPS = 1e-5


def gelu(x: torch.Tensor) -> torch.Tensor:
  """GELU, tanh approximation (the JAX default)."""
  return F.gelu(x, approximate="tanh")


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None, eps: float = _LN_EPS,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
  """LayerNorm over the last axis, as Flax nn.LayerNorm and the JAX mixer
  kernels' `_fast_ln`: float32 single-pass statistics (variance clamped at
  0), (x - mean) * (rsqrt(var + eps) * scale) + bias (scale-only without
  `bias`), output in `dtype` (default: the promoted dtype of x and scale)."""
  xf = x.float()
  mean = xf.mean(-1, keepdim=True)
  var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
  y = (xf - mean) * (torch.rsqrt(var + eps) * scale.float())
  if bias is not None:
    y = y + bias.float()
  return y.to(dtype or torch.promote_types(x.dtype, scale.dtype))


def temporal_depthwise_math(
    x: torch.Tensor,
    w_up: torch.Tensor,
    b_up: torch.Tensor,
    w_mix: torch.Tensor,
    b_mix: torch.Tensor,
    causal: bool,
) -> torch.Tensor:
  """Depthwise conv (multiplier `mult`) -> GELU -> depthwise conv -> fold.

  Args:
    x: [B, T, C].
    w_up / w_mix: [k, 1, mult*C] conv-layout kernels.
    b_up / b_mix: [mult*C] biases.
    causal: causal (left-only) vs SAME zero padding over time.

  Returns:
    [B, T, C] in x.dtype (computed in float32).
  """
  k = w_up.shape[0]
  b, t, c = x.shape
  mult = w_up.shape[-1] // c
  wu = w_up.float().reshape(k, c, mult)
  wm = w_mix.float().reshape(k, c, mult)
  bu = b_up.float().reshape(c, mult)
  bm = b_mix.float().reshape(c, mult)

  left = k - 1 if causal else (k - 1) // 2
  right = 0 if causal else k - 1 - left
  xf = x.float()
  xp = F.pad(xf, (0, 0, left, right))

  y = torch.zeros_like(xf) + bm.sum(-1)
  for m in range(mult):
    h = torch.zeros_like(xf) + bu[:, m]
    for j in range(k):
      h = h + xp[:, j : j + t] * wu[j, :, m]
    h = gelu(h)
    hp = F.pad(h, (0, 0, left, right))
    for j in range(k):
      y = y + hp[:, j : j + t] * wm[j, :, m]
  return y.to(x.dtype)


def mlp_math(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    matmul=torch.matmul,
) -> torch.Tensor:
  """x + Dense(gelu(Dense(LN(x)))): scale-only LN with float32 two-pass
  statistics, float32 matmul accumulation, IO in x.dtype.

  Args:
    x: [..., C]; ln_scale: [C]; w1: [C, H]; b1: [H]; w2: [H, C]; b2: [C].
    matmul: the product of the float32 operands (another one emulates a
      kernel's products, `fused_mixer_block.tf32x3_matmul`).
  """
  xf = x.float()
  mu = xf.mean(-1, keepdim=True)
  var = (xf - mu).square().mean(-1, keepdim=True)
  xn = (xf - mu) * torch.rsqrt(var + _LN_EPS)
  xn = (xn * ln_scale.float()).to(x.dtype)
  h = matmul(xn.float(), w1.float()) + b1.float()
  h = gelu(h).to(x.dtype)
  y = matmul(h.float(), w2.float()) + b2.float()
  return x + y.to(x.dtype)


def quantize_rows(x: torch.Tensor):
  """Symmetric per-row int8 quantization of float32 activations.

  Returns (q int8 [..., C], scale float32 [..., 1]) with q * scale ~= x.
  Rounds half to even; a zero row gets amax 1e-8.
  """
  amax = torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-8)
  # One rounding of 127 / amax, as JAX and the kernels (`127.0 / amax` in
  # PyTorch is reciprocal(amax) * 127: two).
  q = torch.clamp(torch.round(x * torch.div(127.0, amax)), -127.0, 127.0)
  return q.to(torch.int8), amax * (1.0 / 127.0)


def quantize_weight_cols(w: torch.Tensor):
  """Symmetric per-output-column int8 quantization of an [in, out] weight.

  Returns (q int8 [in, out], scale float32 [out]).
  """
  wf = w.float()
  scale = torch.clamp(wf.abs().amax(0), min=1e-8) * (1.0 / 127.0)
  q = torch.clamp(torch.round(wf / scale), -127.0, 127.0).to(torch.int8)
  return q, scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """int8 [M, K] x int8 [K, N] -> int32 [M, N], exact.

  The product runs in float64, which holds every partial sum (at most
  K * 127^2) exactly in any order: integer matmuls have no CUDA
  implementation in PyTorch, and on the CPU float64 matmuls are much faster
  than int32 ones.
  """
  return torch.matmul(a.double(), b.double()).to(torch.int32)


def mlp_math_q8_parts(x, ln_scale, w1q, s1, b1, w2q, s2, b2):
  """`mlp_math_q8` with its integer intermediates: (output, int8 operand
  [..., C], int8 hidden [..., H], hidden row scale [..., 1])."""
  xf = x.float()
  mu = xf.mean(-1, keepdim=True)
  var = (xf - mu).square().mean(-1, keepdim=True)
  xn = (xf - mu) * torch.rsqrt(var + _LN_EPS)
  xn = xn * ln_scale.float()
  xq, xs = quantize_rows(xn)
  acc = int8_matmul(xq, w1q)
  h = acc.float() * (xs * s1) + b1.float()
  h = gelu(h)
  hq, hs = quantize_rows(h)
  acc2 = int8_matmul(hq, w2q)
  y = acc2.float() * (hs * s2) + b2.float()
  return x + y.to(x.dtype), xq, hq, hs


def mlp_math_q8(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    w1q: torch.Tensor,
    s1: torch.Tensor,
    b1: torch.Tensor,
    w2q: torch.Tensor,
    s2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
  """Quantized (w8a8) residual channel MLP: LN in float32, symmetric per-row
  dynamic activation scales, per-output-column weight scales, int32
  accumulation, dequantization + bias + GELU in float32. The hidden is
  quantized from its float32 value.

  Args:
    x: [..., C] tokens, any float dtype.
    ln_scale: [C] scale-only LayerNorm scale.
    w1q / w2q: int8 [C, H] / [H, C] pre-quantized weights.
    s1 / s2: float32 [H] / [C] per-column weight scales.
    b1 / b2: [H] / [C] biases (float).

  Returns:
    [..., C], same dtype as x.
  """
  return mlp_math_q8_parts(x, ln_scale, w1q, s1, b1, w2q, s2, b2)[0]


def mlp_block_q8(x, ln_scale, w1, b1, w2, b2, qweights=None):
  """`mlp_math_q8` on the weights quantized per output column (`qweights`
  = (w1q, s1, w2q, s2) made once by the caller, else from w1 and w2 here),
  differentiable straight-through as JAX's `mlp_block_q8`: its backward is
  the VJP of the full-precision `mlp_math` (`ops._vjp`).

  Args:
    x: [..., C]; ln_scale: [C]; w1: [C, H]; b1: [H]; w2: [H, C]; b2: [C].
  """
  if qweights is None:
    qweights = (*quantize_weight_cols(w1), *quantize_weight_cols(w2))
  w1q, s1, w2q, s2 = qweights
  return _vjp.apply(
      lambda x, ln_scale, w1, b1, w2, b2: mlp_math_q8(
          x, ln_scale, w1q, s1, b1, w2q, s2, b2),
      mlp_math, x, ln_scale, w1, b1, w2, b2)

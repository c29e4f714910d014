"""Plain PyTorch math of the PIPs-mixer sub-blocks.

Port of tapnet_tpu/ops/mixer_math.py (float path): the depthwise temporal
conv pair and the residual channel MLP. These are the plain versions that
`ops.fused_mixer_block.mixer_block` runs on CPU tensors and that its CUDA
kernel is held against. Layouts are the JAX ones: depthwise kernels
[k, 1, mult*C] with c-major flat index c*mult + m, dense weights [in, out].
GELU is the tanh approximation; accumulations are float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_LN_EPS = 1e-5


def gelu(x: torch.Tensor) -> torch.Tensor:
  """GELU, tanh approximation (the JAX default)."""
  return F.gelu(x, approximate="tanh")


def layer_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
  """Scale-only LayerNorm over the last axis, as Flax
  nn.LayerNorm(use_bias=False) and the JAX mixer kernels' `_fast_ln`: float32
  single-pass statistics (variance clamped at 0), eps 1e-5, output in the
  promoted dtype of x and scale."""
  xf = x.float()
  mean = xf.mean(-1, keepdim=True)
  var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
  y = (xf - mean) * (torch.rsqrt(var + _LN_EPS) * scale.float())
  return y.to(torch.promote_types(x.dtype, scale.dtype))


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
) -> torch.Tensor:
  """x + Dense(gelu(Dense(LN(x)))): scale-only LN with float32 two-pass
  statistics, float32 matmul accumulation, IO in x.dtype.

  Args:
    x: [..., C]; ln_scale: [C]; w1: [C, H]; b1: [H]; w2: [H, C]; b2: [C].
  """
  xf = x.float()
  mu = xf.mean(-1, keepdim=True)
  var = (xf - mu).square().mean(-1, keepdim=True)
  xn = (xf - mu) * torch.rsqrt(var + _LN_EPS)
  xn = (xn * ln_scale.float()).to(x.dtype)
  h = torch.matmul(xn.float(), w1.float()) + b1.float()
  h = gelu(h).to(x.dtype)
  y = torch.matmul(h.float(), w2.float()) + b2.float()
  return x + y.to(x.dtype)

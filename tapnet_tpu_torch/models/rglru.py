"""Griffin recurrent block: RG-LRU + causal conv + gated MLP (port of
tapnet_tpu/models/rglru.py).

Module and parameter names follow the Flax tree
(`checkpoints/convert.tapnext_to_state_dict`): `temporal_pre_norm.scale`,
`recurrent_block.rg_lru.a_param`, `recurrent_block.conv_1d.w`,
`mlp_block.ffw_up.w` and so on. Dense layers are `nn.Linear` ([out, in]);
the block-diagonal gates (`w` [H, bw, bw]), the temporal conv (`w` [k, C])
and the paired up-projection (`w` [2, d, D], `b` [2, 1, 1, D]) keep the Flax
tensors as they are.

Activations are [batch, time, channels]. The linear recurrence runs
`ops.scan.linear_scan` (K5 on the card, K5b in its backward). The input
normalisation sqrt(1 - a^2) has the JAX module's clipped gradient
(`sqrt_bound_derivative`).

Sequence parallelism: each module's forward takes an optional `sp`, a
(`parallel.mesh.Mesh`, time axis) pair, and then runs on this rank's part of
the time axis through `parallel/sequence.py` (the JAX modules' `sp`
attribute; here the caller decides per call, with `sp_active` on the global
length, so that a streaming step of one frame takes the local path).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from tapnet_tpu_torch.models.layers import _param, linear
from tapnet_tpu_torch.ops import scan
from tapnet_tpu_torch.ops.mixer_math import gelu
from tapnet_tpu_torch.parallel import sequence

_MAX_SQRT_GRADIENT = 1000.0


class _SqrtBoundDerivative(torch.autograd.Function):
  """sqrt(x) with the backward g / sqrt(max(4x, 1 / 1000^2)): the gradient is
  clipped at 1000 where x nears 0 (a near 1), as in the JAX module."""

  @staticmethod
  def forward(ctx, x):
    ctx.save_for_backward(x)
    return torch.sqrt(x)

  @staticmethod
  def backward(ctx, g):
    x, = ctx.saved_tensors
    return g / torch.sqrt(torch.clamp(4.0 * x, min=1 / _MAX_SQRT_GRADIENT**2))


def sqrt_bound_derivative(x: torch.Tensor) -> torch.Tensor:
  """sqrt(x) with the backward pass clipped at `_MAX_SQRT_GRADIENT`."""
  return _SqrtBoundDerivative.apply(x)


class RMSNorm(nn.Module):
  """RMSNorm with a (1 + scale) multiplier (Griffin convention)."""

  def __init__(self, width: int, eps: float = 1e-6):
    super().__init__()
    self.eps = eps
    self.scale = _param(width)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    normed = x * torch.rsqrt(var + self.eps).to(x.dtype)
    return normed * (self.scale + 1)


class BlockDiagonalLinear(nn.Module):
  """Per-head linear layer: w [H, bw, bw], b [H, bw]."""

  def __init__(self, width: int, num_blocks: int):
    super().__init__()
    self.num_blocks = num_blocks
    bw = width // num_blocks
    self.w = _param(num_blocks, bw, bw)
    self.b = _param(num_blocks, bw)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    xb = x.reshape(x.shape[:-1] + (self.num_blocks, -1))
    y = torch.einsum("...hi,hij->...hj", xb, self.w) + self.b
    return y.reshape(x.shape)


def linear_recurrence(
    x: torch.Tensor, a: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
  """h[t] = a[t] * h[t-1] + x[t] over axis 1; returns (y in x.dtype, h_last
  [B, C] float32). h0: optional [B, C] float32 initial state."""
  if h0 is None:
    h0 = torch.zeros((x.shape[0], x.shape[-1]), dtype=torch.float32,
                     device=x.device)
  return scan.linear_scan(x.contiguous(), a.contiguous(), h0.contiguous())


def sp_active(sp, t: int) -> bool:
  """Whether the sequence-parallel path applies to a sequence of global
  length t. `sp` is an optional (Mesh, time axis) pair. A streaming step
  (t == 1) takes the local path; a longer sequence whose length the axis does
  not divide is a configuration error."""
  if sp is None:
    return False
  mesh, axis = sp
  p = mesh.size(axis)
  if p <= 1 or t == 1:
    return False
  if t % p:
    raise ValueError(
        f"sequence length {t} not divisible by mesh axis {axis!r} ({p})")
  return True


class RGLRU(nn.Module):
  """Real-Gated Linear Recurrent Unit.

  a[t] = exp(-8 * sigmoid(a_gate(x)) * softplus(a_param)); the input is
  gated by sigmoid(input_gate(x)) and normalized by sqrt(1 - a^2), except at
  t = 0 of a fresh sequence (no cache). Under `sp` that is the global frame
  0, which only the first rank along the time axis holds.
  """

  def __init__(self, width: int, num_heads: int):
    super().__init__()
    self.a_param = _param(width)
    self.input_gate = BlockDiagonalLinear(width, num_heads)
    self.a_gate = BlockDiagonalLinear(width, num_heads)

  def forward(
      self, x: torch.Tensor, cache: Optional[torch.Tensor] = None, sp=None
  ) -> Tuple[torch.Tensor, torch.Tensor]:
    gate_x = torch.sigmoid(self.input_gate(x))
    gate_a = torch.sigmoid(self.a_gate(x))
    softplus = torch.logaddexp(self.a_param, torch.zeros_like(self.a_param))
    log_a = -8.0 * gate_a * softplus
    a = torch.exp(log_a.float()).to(x.dtype)
    a_square = torch.exp(2 * log_a.float())

    gated_x = x * gate_x
    multiplier = sqrt_bound_derivative(1 - a_square)
    if cache is None:
      # Fresh sequence: no normalization at the (global) first step. Every
      # rank builds the same graph (the order of the collectives in the
      # backward depends on it), with a global index.
      t0 = 0 if sp is None else sp[0].index(sp[1]) * x.shape[1]
      t_idx = torch.arange(t0, t0 + x.shape[1], device=x.device)[None, :, None]
      multiplier = torch.where(t_idx == 0, 1.0, multiplier)
    normalized_x = gated_x * multiplier.to(x.dtype)
    if sp is not None:
      return sequence.sequence_parallel_linear_scan(
          normalized_x, a, cache, sp[0], sp[1])
    return linear_recurrence(normalized_x, a, cache)


class CausalConv1D(nn.Module):
  """Depthwise temporal conv of width `temporal_width` with a streaming
  cache: w [temporal_width, C], b [C]."""

  def __init__(self, width: int, temporal_width: int = 4):
    super().__init__()
    self.temporal_width = temporal_width
    self.w = _param(temporal_width, width)
    self.b = _param(width)

  def forward(
      self, x: torch.Tensor, cache: Optional[torch.Tensor] = None, sp=None
  ) -> Tuple[torch.Tensor, torch.Tensor]:
    if sp is not None:
      return sequence.sequence_parallel_causal_conv(
          x, self.w, self.b, cache, sp[0], sp[1])
    k = self.temporal_width
    if cache is None:
      cache = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    full = torch.cat([cache.to(x.dtype), x], dim=1)
    if x.shape[1] == 1:
      y = torch.einsum("btc,tc->bc", full, self.w)[:, None] + self.b
    else:
      # k shifted elementwise multiply-adds, in the JAX module's order.
      t_out = full.shape[1] - (k - 1)
      y = torch.zeros_like(x) + self.b
      for j in range(k):
        y = y + full[:, j:j + t_out] * self.w[j]
    new_cache = full[:, full.shape[1] - (k - 1):]
    return y, new_cache


class RecurrentBlockCache(NamedTuple):
  """Streaming state of one recurrent block, or of a stack of them with a
  leading layer axis: the float32 LRU state and the conv window."""

  rg_lru_state: torch.Tensor  # [..., B, lru_width] float32
  conv1d_state: torch.Tensor  # [..., B, temporal_width - 1, lru_width]


class RecurrentBlock(nn.Module):
  """linear_y (GELU gate) || linear_x -> causal conv -> RG-LRU; product;
  linear_out."""

  def __init__(self, width: int, num_heads: int,
               lru_width: Optional[int] = None,
               conv1d_temporal_width: int = 4):
    super().__init__()
    lru_width = lru_width or width
    self.linear_y = nn.Linear(width, lru_width)
    self.linear_x = nn.Linear(width, lru_width)
    self.conv_1d = CausalConv1D(lru_width, conv1d_temporal_width)
    self.rg_lru = RGLRU(lru_width, num_heads)
    self.linear_out = nn.Linear(lru_width, width)

  def forward(
      self, x: torch.Tensor, cache: Optional[RecurrentBlockCache] = None,
      sp=None) -> Tuple[torch.Tensor, RecurrentBlockCache]:
    y = gelu(linear(x, self.linear_y))
    h = linear(x, self.linear_x)
    h, conv_state = self.conv_1d(
        h, None if cache is None else cache.conv1d_state, sp)
    h, lru_state = self.rg_lru(
        h, None if cache is None else cache.rg_lru_state, sp)
    out = linear(h * y, self.linear_out)
    return out, RecurrentBlockCache(rg_lru_state=lru_state,
                                    conv1d_state=conv_state)


class _FfwUp(nn.Module):
  """Paired up-projection: w [2, d, D], b [2, 1, 1, D]; returns [2, ..., D]."""

  def __init__(self, width: int, expanded_width: int):
    super().__init__()
    self.w = _param(2, width, expanded_width)
    self.b = _param(2, 1, 1, expanded_width)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...td,cdD->c...tD", x, self.w) + self.b


class GriffinMLP(nn.Module):
  """Gated feed-forward: ffw_up emits (gate, act); gelu(gate) * act ->
  ffw_down."""

  def __init__(self, width: int, expanded_width: int):
    super().__init__()
    self.ffw_up = _FfwUp(width, expanded_width)
    self.ffw_down = nn.Linear(expanded_width, width)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    up = self.ffw_up(x)
    return linear(gelu(up[0]) * up[1], self.ffw_down)


class GriffinResidualBlock(nn.Module):
  """RMSNorm -> recurrent block -> + residual; RMSNorm -> MLP -> + residual."""

  def __init__(self, width: int, mlp_expanded_width: int, num_heads: int,
               lru_width: Optional[int] = None,
               conv1d_temporal_width: int = 4):
    super().__init__()
    self.temporal_pre_norm = RMSNorm(width)
    self.recurrent_block = RecurrentBlock(
        width, num_heads, lru_width, conv1d_temporal_width)
    self.channel_pre_norm = RMSNorm(width)
    self.mlp_block = GriffinMLP(width, mlp_expanded_width)

  def forward(
      self, x: torch.Tensor, cache: Optional[RecurrentBlockCache] = None,
      sp=None) -> Tuple[torch.Tensor, RecurrentBlockCache]:
    raw = x
    h = self.temporal_pre_norm(x)
    h, new_cache = self.recurrent_block(h, cache, sp)
    residual = h + raw
    h = self.channel_pre_norm(residual)
    h = self.mlp_block(h)
    return h + residual, new_cache

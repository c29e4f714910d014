"""ViT-22B-style transformer used by TRAJAN (port of
tapnet_tpu/trajan/attention.py).

Scale-only LayerNorm pre-norm, RMSNorm on the per-head queries and keys,
parallel self- and cross-attention into one residual, then a tanh-GELU MLP.
Module names follow the Flax tree (`checkpoints/convert.py`,
`trajan_to_state_dict`). Flax's norms default to eps 1e-6 (torch's 1e-5).

The attention is Flax's `dot_product_attention`: the query scaled by
1/sqrt(head_dim) before the product, masked logits set to float32's lowest
value (not -inf) before a float32 softmax, so a fully masked row attends
uniformly to every key instead of giving NaN. It runs as explicit matrix
products and a softmax, which keeps that rule and PyTorch's TF32 settings on
any device. The JAX version is plain XLA, not a Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tapnet_tpu_torch.ops import mixer_math

EPS = 1e-6


class RMSNorm(nn.Module):
  """Flax nn.RMSNorm over the last axis: x * rsqrt(mean(x^2) + eps) * scale,
  float32 statistics."""

  def __init__(self, channels: int):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(channels))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mul = torch.rsqrt(xf.square().mean(-1, keepdim=True) + EPS) * self.scale
    return (xf * mul).to(torch.promote_types(x.dtype, self.scale.dtype))


class LayerNorm(nn.Module):
  """Flax nn.LayerNorm(use_bias=False): scale only, eps 1e-6."""

  def __init__(self, channels: int):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(channels))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return mixer_math.layer_norm(x, self.scale, eps=EPS)


def dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                          value: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Flax's dot_product_attention on [..., L, heads, D] operands; `mask`
  (nonzero = attend) broadcasts against the [..., heads, Lq, Lk] logits."""
  query = query / math.sqrt(query.shape[-1])
  logits = torch.matmul(query.transpose(-3, -2), key.transpose(-3, -2)
                        .transpose(-2, -1))
  if mask is not None:
    logits = torch.where(mask != 0, logits,
                         torch.finfo(logits.dtype).min)
  weights = torch.softmax(logits.float(), -1).to(value.dtype)
  return torch.matmul(weights, value.transpose(-3, -2)).transpose(-3, -2)


class ImprovedMHDPAttention(nn.Module):
  """Multi-head attention with RMS-normalized queries and keys."""

  def __init__(self, q_width: int, kv_width: int, num_heads: int,
               qk_size: int, v_size: Optional[int] = None):
    super().__init__()
    v_size = v_size or qk_size
    if qk_size % num_heads or v_size % num_heads:
      raise ValueError("qk/v sizes must divide num_heads.")
    self.num_heads = num_heads
    self.dense_query = nn.Linear(q_width, qk_size, bias=False)
    self.dense_key = nn.Linear(kv_width, qk_size, bias=False)
    self.norm_query = RMSNorm(qk_size // num_heads)
    self.norm_key = RMSNorm(qk_size // num_heads)
    self.dense_value = nn.Linear(kv_width, v_size, bias=False)
    self.dense_out = nn.Linear(v_size, q_width)

  def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    heads = lambda x: x.unflatten(-1, (self.num_heads, -1))
    query = self.norm_query(heads(self.dense_query(inputs_q)))
    key = self.norm_key(heads(self.dense_key(inputs_kv)))
    value = heads(self.dense_value(inputs_kv))
    x = dot_product_attention(query, key, value, mask)
    return self.dense_out(x.flatten(-2))


class ImprovedTransformerBlock(nn.Module):
  """One block: parallel self(+cross) attention into the residual, then the
  MLP. `kv_width`: the cross-attention's input width (None: no
  cross-attention)."""

  def __init__(self, width: int, mlp_size: int, num_heads: int, qkv_size: int,
               kv_width: Optional[int] = None):
    super().__init__()
    self.norm_q = LayerNorm(width)
    self.self_att = ImprovedMHDPAttention(width, width, num_heads, qkv_size)
    self.cross_att = (None if kv_width is None else ImprovedMHDPAttention(
        width, kv_width, num_heads, qkv_size))
    self.norm_attn = LayerNorm(width)
    self.MLP_in = nn.Linear(width, mlp_size)  # pylint: disable=invalid-name
    self.MLP_out = nn.Linear(mlp_size, width)  # pylint: disable=invalid-name

  def forward(self, queries: torch.Tensor,
              inputs_kv: Optional[torch.Tensor] = None,
              qq_mask: Optional[torch.Tensor] = None,
              qk_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    normed = self.norm_q(queries)
    out = queries + self.self_att(normed, normed, mask=qq_mask)
    if inputs_kv is not None:
      out = out + self.cross_att(normed, inputs_kv, mask=qk_mask)
    h = F.gelu(self.MLP_in(self.norm_attn(out)), approximate="tanh")
    return out + self.MLP_out(h)


class ImprovedTransformer(nn.Module):
  """Stack of blocks + a final scale-only LayerNorm."""

  def __init__(self, width: int, qkv_size: int, num_heads: int, mlp_size: int,
               num_layers: int, kv_width: Optional[int] = None):
    super().__init__()
    self.num_layers = num_layers
    for i in range(num_layers):
      self.add_module(f"layer_{i}", ImprovedTransformerBlock(
          width, mlp_size, num_heads, qkv_size, kv_width))
    self.norm_encoder = LayerNorm(width)

  def forward(self, queries: torch.Tensor,
              inputs_kv: Optional[torch.Tensor] = None,
              qq_mask: Optional[torch.Tensor] = None,
              qk_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    # A mask of the tokens' rank gains the heads axis.
    if qk_mask is not None and qk_mask.ndim == inputs_kv.ndim:
      qk_mask = qk_mask[..., None, :, :]
    if qq_mask is not None and qq_mask.ndim == queries.ndim:
      qq_mask = qq_mask[..., None, :, :]
    for i in range(self.num_layers):
      queries = getattr(self, f"layer_{i}")(queries, inputs_kv, qq_mask,
                                            qk_mask)
    return self.norm_encoder(queries)

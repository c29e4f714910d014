"""Neural-net layers of TAPIR (port of tapnet_tpu/models/layers.py): the
offline path, and the streaming caches of the causal (online) mixer.

Module and parameter names follow the Flax tree (`checkpoints/convert.py`
maps `kernel` to `weight` and keeps the rest), so `ln_temporal.scale`,
`temporal.dw_up.weight` or `conv_up_0.weight` hold what the Flax modules of
the same names hold. Activations of the mixer are [batch*points, time,
channels]; convolutional layers take NCHW.

Dtypes follow Flax's promotion: a layer computes in the promoted type of its
input and its parameters, with float32 normalization statistics. A streaming
cache is float32 (`PipsMixer.init_cache`), so in bf16 mode `[cache ++ x]`
promotes the temporal half, and the blocks after it, to float32, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tapnet_tpu_torch.ops import fused_extra_convs, fused_mixer_block, mixer_math, qconv
from tapnet_tpu_torch.ops.qconv import conv2d_fp_math

_EPS = 1e-5


def _param(*shape, fill: Optional[float] = None) -> nn.Parameter:
  """A parameter to be filled from a checkpoint (ones/zeros for norms)."""
  if fill is None:
    return nn.Parameter(torch.empty(*shape))
  return nn.Parameter(torch.full(shape, fill))


def linear(x: torch.Tensor, layer: nn.Module, dtype=None) -> torch.Tensor:
  """Flax nn.Dense semantics: input and parameters (`layer.weight` [out, in],
  `layer.bias`) cast to `dtype`, by default their promoted dtype."""
  if dtype is None:
    dtype = torch.promote_types(x.dtype, layer.weight.dtype)
  return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _derived(cache: dict, slot, weights, make):
  """make(*weights), kept in `cache[slot]` until one of the weights changes:
  the key holds each weight's storage, version, device and dtype, so
  `load_state_dict`, `.to()` and in-place updates make it anew."""
  key = tuple(
      (w.data_ptr(), w._version, w.device, w.dtype)  # pylint: disable=protected-access
      for w in weights
  )
  hit = cache.get(slot)
  if hit is None or hit[0] != key:
    hit = cache[slot] = (key, make(*(w.detach() for w in weights)))
  return hit[1]


class Conv(nn.Module):
  """Holds a conv's params (`weight` OIHW, optional `bias`); SAME padding."""

  def __init__(self, in_ch: int, out_ch: int, kernel: int, bias: bool = True):
    super().__init__()
    self.weight = _param(out_ch, in_ch, kernel, kernel)
    self.bias = _param(out_ch, fill=0.0) if bias else None

  def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    dtype = torch.promote_types(x.dtype, self.weight.dtype)
    return conv2d_fp_math(x.to(dtype), self.weight, self.bias, stride)


class InstanceNorm(nn.Module):
  """Per-sample, per-channel normalization over (H, W) of NCHW input.

  Matches hk.InstanceNorm(create_scale=True, create_offset=True): float32
  two-pass statistics.
  """

  def __init__(self, channels: int, eps: float = 1e-5):
    super().__init__()
    self.eps = eps
    self.scale = _param(channels, fill=1.0)
    self.offset = _param(channels, fill=0.0)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(2, 3), unbiased=False, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + self.eps)
    out = out * self.scale.float()[:, None, None] + self.offset.float()[:, None, None]
    return out.to(x.dtype)


class LayerNormScale(nn.Module):
  """Holds a scale-only LayerNorm's `scale` (Flax nn.LayerNorm(use_bias=False))."""

  def __init__(self, channels: int):
    super().__init__()
    self.scale = _param(channels, fill=1.0)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return mixer_math.layer_norm(x, self.scale)


class _Depthwise(nn.Module):
  """Depthwise temporal conv params: `weight` [k, 1, D] (c-major lanes),
  `bias` [D], as the Flax conv-layout params."""

  def __init__(self, features: int, kernel_size: int):
    super().__init__()
    self.weight = _param(kernel_size, 1, features)
    self.bias = _param(features, fill=0.0)


class ConvCache(NamedTuple):
  """Streaming cache of one temporal-mixing block: `pre` the last (k-1)
  input frames of the first depthwise conv, `mid` the last (k-1) post-GELU
  frames feeding the second. Leading axes are the caller's batch layout."""

  pre: torch.Tensor  # [..., k-1, hidden]
  mid: torch.Tensor  # [..., k-1, hidden * multiplier]


class MixerCache(NamedTuple):
  """Streaming cache of every mixer block, stacked on a leading
  `num_blocks` axis: pre [L, ..., k-1, hidden], mid [L, ..., k-1, 4*hidden]."""

  pre: torch.Tensor
  mid: torch.Tensor


def _shifted_fma(v, w, b):
  """VALID depthwise conv over time as the sum of k shifted slices, in the
  promoted type of its operands: v [..., T + k - 1, D], w [k, 1, D], b [D]
  -> [..., T, D]."""
  k = w.shape[0]
  t_out = v.shape[-2] - (k - 1)
  out = b
  for j in range(k):
    out = out + v[..., j : j + t_out, :] * w[j, 0]
  return out


class TemporalDepthwiseBlock(nn.Module):
  """Depthwise temporal mixing params: per-channel conv (multiplier 4) ->
  GELU -> per-channel conv, the 4 lanes of each channel folded back by
  summation. Offline, `MixerBlock` runs the math through
  `ops.fused_mixer_block.mixer_block`; `forward` is the causal streaming
  form, which materializes the hidden lanes the caches hold."""

  def __init__(self, features: int = 512, kernel_size: int = 3,
               multiplier: int = 4):
    super().__init__()
    self.multiplier = multiplier
    self.dw_up = _Depthwise(features * multiplier, kernel_size)
    self.dw_mix = _Depthwise(features * multiplier, kernel_size)

  def forward(self, x: torch.Tensor, cache: Optional[ConvCache] = None,
              return_cache: bool = False
              ) -> Tuple[torch.Tensor, Optional[ConvCache]]:
    """x [..., T, C] -> (y [..., T, C], the new cache or None).

    Both convolutions run VALID over [cache ++ x] (exact causal streaming).
    Without a cache they start from a zero one in x's dtype: the causal
    block's zero padding of a clip, whose new cache is the clip's tail
    (warm-up). Input channel c expands to lanes [4c, 4c+3].
    """
    k = self.dw_up.weight.shape[0]
    c = x.shape[-1]
    if cache is None:
      lead = x.shape[:-2] + (k - 1,)
      cache = ConvCache(pre=x.new_zeros(lead + (c,)),
                        mid=x.new_zeros(lead + (c * self.multiplier,)))
    w_up, b_up = self.dw_up.weight, self.dw_up.bias
    w_mix, b_mix = self.dw_mix.weight, self.dw_mix.bias
    dtype = torch.promote_types(cache.pre.dtype, x.dtype)
    pre_in = torch.cat([cache.pre.to(dtype), x.to(dtype)], dim=-2)
    h = mixer_math.gelu(_shifted_fma(
        pre_in.repeat_interleave(self.multiplier, dim=-1), w_up, b_up))
    dtype = torch.promote_types(cache.mid.dtype, h.dtype)
    mid_in = torch.cat([cache.mid.to(dtype), h.to(dtype)], dim=-2)
    y = _shifted_fma(mid_in, w_mix, b_mix)
    new_cache = None
    if return_cache:
      new_cache = ConvCache(pre=pre_in[..., -(k - 1):, :],
                            mid=mid_in[..., -(k - 1):, :])
    y = y.reshape(y.shape[:-1] + (c, self.multiplier)).sum(-1)
    return y, new_cache


class MixerBlock(nn.Module):
  """One PIPs-mixer block: temporal depthwise mixing + channel MLP, both with
  pre-LayerNorm residuals, as one `ops.fused_mixer_block.mixer_block` call
  offline, and as the unfused blocks with a streaming cache online.

  `quantized` runs the channel MLP in w8a8 int8 (the temporal conv and the
  LayerNorms stay in full precision). The int8 weights are derived from
  `fc_up` / `fc_down` once and kept beside them, not in the state dict, and
  made anew when the weights change (`_derived`).
  """

  def __init__(self, features: int, kernel_size: int = 3,
               causal: bool = False, expansion: int = 4,
               quantized: bool = False):
    super().__init__()
    self.causal = causal
    self.quantized = quantized
    self._qcache = {}
    self.ln_temporal = LayerNormScale(features)
    self.temporal = TemporalDepthwiseBlock(features, kernel_size)
    self.ln_channel = LayerNormScale(features)
    self.fc_up = nn.Linear(features, features * expansion)
    self.fc_down = nn.Linear(features * expansion, features)

  def quantized_weights(self):
    """(w1q [C, H], s1 [H], w2q [H, C], s2 [C]) of `fc_up` and `fc_down`,
    quantized per output column. The int8 tensors are transposed views of
    contiguous [out, in] storage, the layout the CUDA kernel reads."""
    def make(*weights):
      packed = []
      for w in weights:
        q, scale = mixer_math.quantize_weight_cols(w.t())
        packed += [q.t().contiguous().t(), scale]
      return tuple(packed)

    return _derived(self._qcache, 0, (self.fc_up.weight, self.fc_down.weight),
                    make)

  def forward(self, x: torch.Tensor, cache: Optional[ConvCache] = None,
              return_cache: bool = False
              ) -> Tuple[torch.Tensor, Optional[ConvCache]]:
    """x [B, T, C] -> (y, the new cache or None). Without a cache and
    `return_cache`, the whole block is one `fused_mixer_block.mixer_block`
    call; otherwise the JAX unfused path: scale-only LayerNorm, the
    streaming or warm-up temporal half, the residual, then the channel MLP
    (`mixer_math.mlp_math`, plain matmuls, or for a quantized block the w8a8
    `mixer_math.mlp_block_q8` of JAX's `mlp_block_q8`, straight-through, its
    int8 products as exact float64 matmuls: JAX computes both outside any
    Pallas kernel).
    Only a causal block streams."""
    t = self.temporal
    if cache is None and not return_cache:
      return fused_mixer_block.mixer_block(
          x, self.ln_temporal.scale, t.dw_up.weight, t.dw_up.bias,
          t.dw_mix.weight, t.dw_mix.bias, self.ln_channel.scale,
          self.fc_up.weight.t(), self.fc_up.bias,
          self.fc_down.weight.t(), self.fc_down.bias, self.causal,
          quantized=self.quantized,
          qweights=self.quantized_weights() if self.quantized else None,
      ), None
    if not self.causal:
      raise ValueError("MixerBlock: a streaming cache needs a causal block")
    h = mixer_math.layer_norm(x, self.ln_temporal.scale, dtype=x.dtype)
    h, new_cache = t(h, cache, return_cache)
    x = x + h
    if self.quantized:
      return mixer_math.mlp_block_q8(
          x, self.ln_channel.scale, self.fc_up.weight.t(), self.fc_up.bias,
          self.fc_down.weight.t(), self.fc_down.bias,
          self.quantized_weights()), new_cache
    return mixer_math.mlp_math(
        x, self.ln_channel.scale, self.fc_up.weight.t(), self.fc_up.bias,
        self.fc_down.weight.t(), self.fc_down.bias), new_cache


class PipsMixer(nn.Module):
  """Depthwise-conv MLP-Mixer over trajectories: input projection, N mixer
  blocks, LayerNorm, output projection."""

  def __init__(self, input_channels: int, output_channels: int,
               hidden_dim: int = 512, num_blocks: int = 12,
               kernel_size: int = 3, causal: bool = False,
               quantized: bool = False):
    super().__init__()
    self.num_blocks = num_blocks
    self.in_proj = nn.Linear(input_channels, hidden_dim)
    for i in range(num_blocks):
      self.add_module(
          f"block_{i}",
          MixerBlock(hidden_dim, kernel_size, causal, quantized=quantized),
      )
    self.ln_out = LayerNormScale(hidden_dim)
    self.out_proj = nn.Linear(hidden_dim, output_channels)

  def forward(self, x: torch.Tensor, cache: Optional[MixerCache] = None,
              return_cache: bool = False):
    """x: [B*N, T, input_channels] -> [B*N, T, output_channels], and with
    `return_cache` also the new MixerCache. `cache` (a MixerCache of
    [L, B*N, k-1, ...]) streams: each block's temporal convs continue from
    it."""
    x = linear(x, self.in_proj)
    new_pre, new_mid = [], []
    for i in range(self.num_blocks):
      block_cache = (None if cache is None
                     else ConvCache(pre=cache.pre[i], mid=cache.mid[i]))
      x, block_cache = getattr(self, f"block_{i}")(x, block_cache, return_cache)
      if return_cache:
        new_pre.append(block_cache.pre)
        new_mid.append(block_cache.mid)
    out = linear(self.ln_out(x), self.out_proj)
    if not return_cache:
      return out
    return out, MixerCache(pre=torch.stack(new_pre), mid=torch.stack(new_mid))

  def init_cache(self, batch_shape, dtype=torch.float32,
                 device=None) -> MixerCache:
    """Zero streaming cache for `batch_shape` leading dims."""
    block = self.block_0.temporal
    k = block.dw_up.weight.shape[0] - 1
    hidden = self.in_proj.weight.shape[0]
    lead = (self.num_blocks,) + tuple(batch_shape) + (k,)
    return MixerCache(
        pre=torch.zeros(lead + (hidden,), dtype=dtype, device=device),
        mid=torch.zeros(lead + (hidden * block.multiplier,), dtype=dtype,
                        device=device),
    )


class _LnBias(nn.Module):
  """LayerNorm params with offset, `scale` and `bias` [C]."""

  def __init__(self, channels: int):
    super().__init__()
    self.scale = _param(channels, fill=1.0)
    self.bias = _param(channels, fill=0.0)


def _ln_with_bias_nchw(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
  """LayerNorm over the channels of NCHW input, with scale AND bias: float32
  single-pass statistics, output in x.dtype."""
  xf = x.float()
  mu = xf.mean(1, keepdim=True)
  var = (xf * xf).mean(1, keepdim=True) - mu * mu
  out = (xf - mu) * torch.rsqrt(var + eps) * scale.float()[:, None, None]
  return (out + bias.float()[:, None, None]).to(x.dtype)


class ExtraConvs(nn.Module):
  """BootsTAPIR's residual conv stack after the backbone: per layer
  x = LN(x); x = x + conv_out(gelu(conv_up(x))), 4x expansion. The LayerNorm
  (with offset) sits in the main path.

  `quantized` selects the int8 inference mode (JAX: layers.ExtraConvs):
    False        full-precision convolutions.
    True         per-frame activation scales: `ops.qconv.conv2d_q8` for both
                 convolutions, GELU between them in x.dtype.
    "per_pixel"  per-pixel activation scales: the whole layer as
                 `ops.fused_extra_convs.extra_convs_layer` (K6) where the JAX
                 gate `wants_fused` holds; elsewhere the per-frame scheme, as
                 in the JAX package.
  The int8 weights are derived from the float ones once per layer and kept
  beside them, not in the state dict (`quantized_weights`).
  """

  def __init__(self, channels: int = 256, num_layers: int = 5,
               channel_multiplier: int = 4, quantized: "bool | str" = False):
    super().__init__()
    self.num_layers = num_layers
    self.quantized = quantized
    self._qcache = {}
    hidden = channels * channel_multiplier
    for i in range(num_layers):
      self.add_module(f"ln_{i}", _LnBias(channels))
      self.add_module(f"conv_up_{i}", Conv(channels, hidden, 3))
      self.add_module(f"conv_out_{i}", Conv(hidden, channels, 3))

  def quantized_weights(self, i: int):
    """(wuq [M, 3, 3, C] int8, su [M], woq [C, 3, 3, M] int8, so [C]) of
    layer i, quantized per output channel (`qconv.quantize_conv_weight`)."""
    weights = (getattr(self, f"conv_up_{i}").weight,
               getattr(self, f"conv_out_{i}").weight)
    return _derived(
        self._qcache, i, weights,
        lambda wu, wo: (*qconv.quantize_conv_weight(wu),
                        *qconv.quantize_conv_weight(wo)))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    """x: [N, C, H, W] -> [N, C, H, W]."""
    per_pixel = self.quantized == "per_pixel"
    for i in range(self.num_layers):
      ln = getattr(self, f"ln_{i}")
      up, down = getattr(self, f"conv_up_{i}"), getattr(self, f"conv_out_{i}")
      nhwc = x.permute(0, 2, 3, 1)
      if fused_extra_convs.wants_fused(nhwc, per_pixel):
        y = fused_extra_convs.extra_convs_layer(
            nhwc, ln.scale, ln.bias, up.weight.permute(2, 3, 1, 0), up.bias,
            down.weight.permute(2, 3, 1, 0), down.bias, True,
            qweights=self.quantized_weights(i))
        x = y.permute(0, 3, 1, 2)
        continue
      x = _ln_with_bias_nchw(x, ln.scale, ln.bias)
      if self.quantized:
        wuq, su, woq, so = self.quantized_weights(i)
        resid = mixer_math.gelu(
            qconv.conv2d_q8(x, up.weight, up.bias, (wuq, su)))
        x = x + qconv.conv2d_q8(resid, down.weight, down.bias, (woq, so))
      else:
        resid = mixer_math.gelu(up(x))
        x = x + down(resid)
    return x

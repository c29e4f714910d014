"""Neural-net layers of TAPIR (port of tapnet_tpu/models/layers.py, offline
path).

Module and parameter names follow the Flax tree (`checkpoints/convert.py`
maps `kernel` to `weight` and keeps the rest), so `ln_temporal.scale`,
`temporal.dw_up.weight` or `conv_up_0.weight` hold what the Flax modules of
the same names hold. Activations of the mixer are [batch*points, time,
channels]; convolutional layers take NCHW.

Dtypes follow Flax's promotion: a layer computes in the promoted type of its
input and its parameters, with float32 normalization statistics.
"""

from __future__ import annotations

from typing import Optional

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


class TemporalDepthwiseBlock(nn.Module):
  """Depthwise temporal mixing params: per-channel conv (multiplier 4) ->
  GELU -> per-channel conv, the 4 lanes of each channel folded back by
  summation. The math is `ops.mixer_math.temporal_depthwise_math`, run by
  `MixerBlock` through `ops.fused_mixer_block.mixer_block`."""

  def __init__(self, features: int = 512, kernel_size: int = 3,
               multiplier: int = 4):
    super().__init__()
    self.dw_up = _Depthwise(features * multiplier, kernel_size)
    self.dw_mix = _Depthwise(features * multiplier, kernel_size)


class MixerBlock(nn.Module):
  """One PIPs-mixer block: temporal depthwise mixing + channel MLP, both with
  pre-LayerNorm residuals, as one `ops.fused_mixer_block.mixer_block` call.

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

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    t = self.temporal
    return fused_mixer_block.mixer_block(
        x, self.ln_temporal.scale, t.dw_up.weight, t.dw_up.bias,
        t.dw_mix.weight, t.dw_mix.bias, self.ln_channel.scale,
        self.fc_up.weight.t(), self.fc_up.bias,
        self.fc_down.weight.t(), self.fc_down.bias, self.causal,
        quantized=self.quantized,
        qweights=self.quantized_weights() if self.quantized else None,
    )


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

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    """x: [B*N, T, input_channels] -> [B*N, T, output_channels]."""
    x = linear(x, self.in_proj)
    for i in range(self.num_blocks):
      x = getattr(self, f"block_{i}")(x)
    x = self.ln_out(x)
    return linear(x, self.out_proj)


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
            nhwc, ln.scale, ln.bias, None, up.bias, None, down.bias, True,
            qweights=self.quantized_weights(i))
        x = y.permute(0, 3, 1, 2)
        continue
      x = _ln_with_bias_nchw(x, ln.scale, ln.bias)
      if self.quantized:
        wuq, su, woq, so = self.quantized_weights(i)
        resid = mixer_math.gelu(qconv.conv2d_q8(x, None, up.bias, (wuq, su)))
        x = x + qconv.conv2d_q8(resid, None, down.bias, (woq, so))
      else:
        resid = mixer_math.gelu(up(x))
        x = x + down(resid)
    return x

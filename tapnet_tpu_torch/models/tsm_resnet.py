"""TSM-ResNet: ResNet-V2 with Temporal Shift Modules (port of
tapnet_tpu/models/tsm_resnet.py).

A fraction of the channels is shifted one frame forward and one back before
the residual convolutions, which gives a temporal receptive field without 3D
convolutions. Activations are time-major NCHW, [T*B, C, H, W], so the shift
is a slice along the leading axis, as in the JAX version; the channel order
[future-shifted | static | past-shifted] is the JAX package's (and the
reference's), so converted checkpoints load as they are.

Module and parameter names follow the Flax tree (`checkpoints/convert.py`
maps `kernel` to `weight`). `BatchNorm` is Flax's: `scale`, `bias` and the
running statistics `mean`, `var` (Flax's `batch_stats` collection, buffers
here); momentum 0.9 means `ra <- 0.9 ra + 0.1 batch`, and the batch
variance is the biased E[x^2] - E[x]^2 in float32 (or wider), clamped at 0
(Flax's `use_fast_variance`), stored as it is.

Convolutions pad as XLA's SAME does: for an even input and stride 2 the low
side gets the smaller half (the 7x7/2 stem, the 3x3/2 block convolutions),
and the SAME max-pool pads with -inf.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from tapnet_tpu_torch.ops.qconv import same_padding

ENDPOINTS = ("stem", "unit_0", "unit_1", "unit_2", "unit_3", "last_conv",
             "embeddings")


def temporal_shift(x: torch.Tensor, num_frames: int,
                   channel_shift_fraction: float = 0.125,
                   dim: int = -1) -> torch.Tensor:
  """Shifts channels across time; x is time-major, [T*B, ...] with the
  channels on `dim` (the JAX version's [T*B, H, W, C] by default).

  Output channels: [last n channels from t+1 | middle channels from t |
  first n channels from t-1], zeros past either end, n = int(C * fraction).
  """
  c = x.shape[dim]
  b = x.shape[0] // num_frames
  n = int(c * channel_shift_fraction)
  if n == 0:
    return x
  zeros_shape = list(x.shape)
  zeros_shape[0] = b
  zeros_shape[dim] = n
  zeros = x.new_zeros(zeros_shape)
  future = torch.cat([x[b:].narrow(dim, c - n, n), zeros], 0)
  past = torch.cat([zeros, x[:-b].narrow(dim, 0, n)], 0)
  return torch.cat([future, x.narrow(dim, n, c - 2 * n), past], dim)


def temporal_shift_image_mode(x: torch.Tensor,
                              channel_shift_fraction: float = 0.125,
                              alpha: float = 0.3,
                              dim: int = -1) -> torch.Tensor:
  """Single-image ("deflated") TSM: emulates a static video."""
  c = x.shape[dim]
  n = int(c * channel_shift_fraction)
  if n == 0:
    return x
  return torch.cat([alpha * x.narrow(dim, c - n, n), x.narrow(dim, n, c - 2 * n),
                    alpha * x.narrow(dim, 0, n)], dim)


@dataclasses.dataclass(frozen=True)
class TSMResNetConfig:
  depth: int = 18
  channel_shift_fraction: Union[float, Sequence[float]] = (
      0.125, 0.125, 0.0, 0.0)
  width_mult: int = 1
  output_stride: int = 8

  def resolved(self):
    """(blocks per unit, shift fractions, strides, dilation rates,
    bottleneck)."""
    num_blocks = {
        18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
        101: (3, 4, 23, 3), 152: (3, 8, 36, 3), 200: (3, 24, 36, 3),
    }[self.depth]
    fractions = self.channel_shift_fraction
    if isinstance(fractions, float):
      fractions = (fractions,) * 4
    strides = {4: (1, 1, 1, 1), 8: (1, 2, 1, 1), 16: (1, 2, 2, 1),
               32: (1, 2, 2, 2)}[self.output_stride]
    rates = {4: (1, 2, 4, 8), 8: (1, 1, 2, 4), 16: (1, 1, 1, 2),
             32: (1, 1, 1, 1)}[self.output_stride]
    return num_blocks, tuple(fractions), strides, rates, self.depth >= 50


class SameConv(nn.Module):
  """Flax nn.Conv with SAME padding: `weight` OIHW, optional `bias`,
  computed in the promoted dtype of the input and the weights."""

  def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
               dilation: int = 1, bias: bool = True):
    super().__init__()
    self.stride, self.dilation = stride, dilation
    self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
    self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = torch.promote_types(x.dtype, self.weight.dtype)
    x = x.to(dtype)
    k = (self.weight.shape[-1] - 1) * self.dilation + 1
    top, bottom = same_padding(x.shape[2], k, self.stride)
    left, right = same_padding(x.shape[3], k, self.stride)
    if (top, left) != (bottom, right):
      x = F.pad(x, (left, right, top, bottom))
      top = left = 0
    return F.conv2d(x, self.weight.to(dtype),
                    None if self.bias is None else self.bias.to(dtype),
                    stride=self.stride, padding=(top, left),
                    dilation=self.dilation)


class BatchNorm(nn.Module):
  """Flax nn.BatchNorm over the channels of NCHW input (see the module
  docstring). `is_training`: normalize by the batch's statistics and move
  the running ones; else normalize by the running ones.

  `sync` (a (parallel.mesh.Mesh, axis) pair, set by `sync_batch_norm`):
  the batch is split over that axis of ranks and its statistics are the
  global batch's, as GSPMD computes them in the JAX package: the ranks'
  equal-sized means of x and x^2 are all-gathered (the gather carries the
  gradient) and averaged."""

  def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
    super().__init__()
    self.momentum, self.eps = momentum, eps
    self.scale = nn.Parameter(torch.ones(channels))
    self.bias = nn.Parameter(torch.zeros(channels))
    self.register_buffer("mean", torch.zeros(channels))
    self.register_buffer("var", torch.ones(channels))
    self.sync = None

  def forward(self, x: torch.Tensor, is_training: bool) -> torch.Tensor:
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if is_training:
      mean, mean2 = xf.mean((0, 2, 3)), xf.square().mean((0, 2, 3))
      if self.sync is not None:
        mesh, axis = self.sync
        mean, mean2 = mesh.all_gather(torch.stack([mean, mean2]),
                                      axis).mean(0)
      var = torch.clamp(mean2 - mean.square(), min=0.0)
      with torch.no_grad():
        self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
        self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
    else:
      mean, var = self.mean, self.var
    mul = torch.rsqrt(var + self.eps) * self.scale
    y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
    return y.to(torch.promote_types(x.dtype, self.scale.dtype))


def sync_batch_norm(model: nn.Module, mesh=None, axis: str = "data") -> None:
  """Makes every `BatchNorm` of `model` take the global batch's statistics
  over `axis` of `mesh` (None: each rank's own batch)."""
  for module in model.modules():
    if isinstance(module, BatchNorm):
      module.sync = None if mesh is None else (mesh, axis)


class TSMBlock(nn.Module):
  """Pre-activation residual block, temporal shift on the residual path
  (after the shortcut is taken from the pre-activation)."""

  def __init__(self, in_channels: int, output_channels: int, stride: int,
               use_projection: bool, bottleneck: bool,
               channel_shift_fraction: float, rate: int = 1):
    super().__init__()
    out_c = output_channels if bottleneck else output_channels // 4
    mid_c = output_channels // 4
    self.bottleneck = bottleneck
    self.channel_shift_fraction = channel_shift_fraction
    self.norm_pre = BatchNorm(in_channels)
    self.proj_conv = (SameConv(in_channels, out_c, 1, stride, bias=False)
                      if use_projection else None)
    if bottleneck:
      self.conv_0 = SameConv(in_channels, mid_c, 1, bias=False)
      self.norm_0 = BatchNorm(mid_c)
      self.conv_1 = SameConv(mid_c, mid_c, 3, stride, rate, bias=False)
    else:
      self.conv_0 = SameConv(in_channels, mid_c, 3, stride, bias=False)
    self.norm_1 = BatchNorm(mid_c)
    self.conv_2 = SameConv(mid_c, out_c, 1 if bottleneck else 3, bias=False)

  def forward(self, x: torch.Tensor, num_frames: int, is_training: bool,
              deflation_alpha: Optional[float] = None) -> torch.Tensor:
    preact = torch.relu(self.norm_pre(x, is_training))
    shortcut = x if self.proj_conv is None else self.proj_conv(preact)
    if self.channel_shift_fraction != 0:
      if deflation_alpha is not None:
        preact = temporal_shift_image_mode(
            preact, self.channel_shift_fraction, deflation_alpha, dim=1)
      else:
        preact = temporal_shift(preact, num_frames,
                                self.channel_shift_fraction, dim=1)
    h = self.conv_0(preact)
    if self.bottleneck:
      h = self.conv_1(torch.relu(self.norm_0(h, is_training)))
    h = self.conv_2(torch.relu(self.norm_1(h, is_training)))
    return shortcut + h


class TSMResNetV2(nn.Module):
  """TSM ResNet-V2 over time-major frames.

  Holds the modules up to `final_endpoint` (as the Flax tree of a model
  called up to it holds no others). `forward` takes [B, T, H, W, 3] video
  (made time-major inside) or pre-flattened time-major [T*B, H, W, 3] with
  `num_frames`, and returns the endpoint as [B, T, H', W', C'] (channels
  last, as the JAX version), or [B, C'] for "embeddings".
  """

  def __init__(self, config: TSMResNetConfig = TSMResNetConfig(),
               final_endpoint: str = "embeddings"):
    super().__init__()
    self.config = config
    self.final_endpoint = final_endpoint
    last = ENDPOINTS.index(final_endpoint)
    num_blocks, fractions, strides, rates, bottleneck = config.resolved()
    channels = tuple(c * config.width_mult for c in (256, 512, 1024, 2048))
    in_ch = 64 * config.width_mult
    self.stem_conv = SameConv(3, in_ch, 7, 2, bias=False)
    self.block_names = []
    for unit in range(4):
      if last < ENDPOINTS.index(f"unit_{unit}"):
        break
      names = []
      for block in range(num_blocks[unit]):
        name = f"unit_{unit}_block_{block}"
        self.add_module(name, TSMBlock(
            in_ch, channels[unit],
            stride=strides[unit] if block == 0 else 1,
            use_projection=block == 0, bottleneck=bottleneck,
            channel_shift_fraction=fractions[unit],
            rate=max(rates[unit] // 2, 1) if block == 0 else rates[unit]))
        in_ch = channels[unit] if bottleneck else channels[unit] // 4
        names.append(name)
      self.block_names.append(names)
    if last >= ENDPOINTS.index("last_conv"):
      self.final_norm = BatchNorm(in_ch)

  def forward(self, video: torch.Tensor, is_training: bool = False,
              final_endpoint: Optional[str] = None,
              num_frames: Optional[int] = None,
              deflation_alpha: Optional[float] = None) -> torch.Tensor:
    final_endpoint = final_endpoint or self.final_endpoint
    if final_endpoint not in ENDPOINTS:
      raise ValueError(f"Unknown endpoint {final_endpoint!r}")
    if ENDPOINTS.index(final_endpoint) > ENDPOINTS.index(self.final_endpoint):
      raise ValueError(f"endpoint {final_endpoint!r} lies past the modules "
                       f"built (up to {self.final_endpoint!r})")
    if video.ndim == 5:
      b, t = video.shape[:2]
      x = video.transpose(0, 1).reshape((t * b,) + video.shape[2:])
    else:
      if num_frames is None:
        raise ValueError("num_frames required for pre-flattened input.")
      t = num_frames
      b = video.shape[0] // t
      x = video
    x = self.stem_conv(x.permute(0, 3, 1, 2))
    top, bottom = same_padding(x.shape[2], 3, 2)
    left, right = same_padding(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")),
                     3, 2)

    def unflatten(v):
      v = v.permute(0, 2, 3, 1)
      return v.reshape((t, b) + v.shape[1:]).transpose(0, 1)

    if final_endpoint == "stem":
      return unflatten(x)
    for unit, names in enumerate(self.block_names):
      for name in names:
        x = getattr(self, name)(x, t, is_training, deflation_alpha)
      if final_endpoint == f"unit_{unit}":
        return unflatten(x)
    x = torch.relu(self.final_norm(x, is_training))
    if final_endpoint == "last_conv":
      return unflatten(x)
    return x.mean((2, 3)).reshape(t, b, -1).mean(0)

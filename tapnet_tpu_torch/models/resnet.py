"""ResNet feature backbone (port of tapnet_tpu/models/resnet.py): v1
(post-activation) or v2 (pre-activation) residual blocks, plain or
bottleneck, with instance, layer, batch or no normalization, an optional
stem max-pool, and every group's output.

TAPIR builds the v2 ResNet with InstanceNorm, strides (1, 2, 2, 1), channels
(64, highres, 256, lowres) and no max-pool, giving a stride-4 "hires" map
(group 1) and a stride-8 "lowres" map (group 3). Activations are NCHW.

Norms, as the Flax modules of the JAX package compute them:
  * "instancenorm": `layers.InstanceNorm` (per sample and channel over H, W);
  * "layernorm": Flax's nn.LayerNorm(reduction_axes=(-3, -2, -1)), the
    statistics of each sample over H, W and C jointly (float32, the variance
    E[x^2] - E[x]^2 clamped at 0), eps 1e-5, a per-channel `scale` and
    `bias`;
  * "batchnorm": `tsm_resnet.BatchNorm` (Flax's, momentum 0.9, running
    statistics `mean`/`var` as buffers, the global batch's statistics over a
    mesh axis after `tsm_resnet.sync_batch_norm`);
  * None: no norm.
The v1 stem is conv, norm, ReLU. The max-pool is Flax's 3x3 / 2 SAME pool:
padded with -inf as XLA pads SAME (an even size gets nothing before and one
cell after), then pooled.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tapnet_tpu_torch.models.layers import Conv, InstanceNorm
from tapnet_tpu_torch.models.tsm_resnet import BatchNorm
from tapnet_tpu_torch.ops.qconv import same_padding

NORMALIZATIONS = ("instancenorm", "layernorm", "batchnorm", None)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
  blocks_per_group: Sequence[int] = (2, 2, 2, 2)
  channels_per_group: Sequence[int] = (64, 128, 256, 256)
  use_projection: Sequence[bool] = (True, True, True, True)
  strides: Sequence[int] = (1, 2, 2, 1)
  bottleneck: bool = False
  resnet_v2: bool = True
  normalization: Optional[str] = "instancenorm"
  use_max_pool: bool = False
  stem_channels: int = 64
  stem_kernel: int = 7
  stem_stride: int = 2

  def __post_init__(self):
    if self.normalization not in NORMALIZATIONS:
      raise ValueError(f"Unknown normalization: {self.normalization!r}")


class LayerNorm(nn.Module):
  """Flax's nn.LayerNorm(epsilon=1e-5, reduction_axes=(-3, -2, -1)) on NCHW
  input: each sample normalized over (C, H, W), then a per-channel `scale`
  and `bias`."""

  def __init__(self, channels: int, eps: float = 1e-5):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.ones(channels))
    self.bias = nn.Parameter(torch.zeros(channels))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean((1, 2, 3), keepdim=True)
    mean2 = xf.square().mean((1, 2, 3), keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    mul = torch.rsqrt(var + self.eps) * self.scale[:, None, None]
    y = (xf - mean) * mul + self.bias[:, None, None]
    return y.to(torch.promote_types(x.dtype, self.scale.dtype))


def _make_norm(normalization: Optional[str], channels: int):
  if normalization == "instancenorm":
    return InstanceNorm(channels)
  if normalization == "layernorm":
    return LayerNorm(channels)
  if normalization == "batchnorm":
    return BatchNorm(channels)
  return None


def _apply_norm(norm, x: torch.Tensor, is_training: bool) -> torch.Tensor:
  if norm is None:
    return x
  if isinstance(norm, BatchNorm):
    return norm(x, is_training)
  return norm(x)


def _conv_specs(in_channels, channels, stride, bottleneck):
  """(in, out, kernel, stride) of a block's convolutions conv_0, conv_1(,
  conv_2); a bottleneck's inner width is channels // 4."""
  if bottleneck:
    inner = channels // 4
    return ((in_channels, inner, 1, 1), (inner, inner, 3, stride),
            (inner, channels, 1, 1))
  return ((in_channels, channels, 3, stride), (channels, channels, 3, 1))


class BlockV2(nn.Module):
  """Pre-activation residual block (norm -> relu -> conv), the projection
  taken from the first post-activation input."""

  def __init__(self, in_channels: int, channels: int, stride: int,
               use_projection: bool, bottleneck: bool = False,
               normalization: Optional[str] = "instancenorm"):
    super().__init__()
    self.stride = stride
    self.specs = _conv_specs(in_channels, channels, stride, bottleneck)
    for i, (cin, cout, k, _) in enumerate(self.specs):
      self.add_module(f"norm_{i}", _make_norm(normalization, cin))
      self.add_module(f"conv_{i}", Conv(cin, cout, k, bias=False))
    self.proj_conv = (
        Conv(in_channels, channels, 1, bias=False) if use_projection else None
    )

  def forward(self, x: torch.Tensor, is_training: bool = False) -> torch.Tensor:
    shortcut = h = x
    for i, (_, _, _, stride) in enumerate(self.specs):
      h = torch.relu(_apply_norm(getattr(self, f"norm_{i}"), h, is_training))
      if i == 0 and self.proj_conv is not None:
        shortcut = self.proj_conv(h, self.stride)
      h = getattr(self, f"conv_{i}")(h, stride)
    return h + shortcut


class BlockV1(nn.Module):
  """Post-activation residual block (conv -> norm -> relu), the projection
  (conv, then `proj_norm`) taken from the block's input."""

  def __init__(self, in_channels: int, channels: int, stride: int,
               use_projection: bool, bottleneck: bool = False,
               normalization: Optional[str] = "instancenorm"):
    super().__init__()
    self.stride = stride
    self.specs = _conv_specs(in_channels, channels, stride, bottleneck)
    self.proj_conv = self.proj_norm = None
    if use_projection:
      self.proj_conv = Conv(in_channels, channels, 1, bias=False)
      self.proj_norm = _make_norm(normalization, channels)
    for i, (cin, cout, k, _) in enumerate(self.specs):
      self.add_module(f"conv_{i}", Conv(cin, cout, k, bias=False))
      self.add_module(f"norm_{i}", _make_norm(normalization, cout))

  def forward(self, x: torch.Tensor, is_training: bool = False) -> torch.Tensor:
    shortcut = x
    if self.proj_conv is not None:
      shortcut = _apply_norm(self.proj_norm,
                             self.proj_conv(x, self.stride), is_training)
    h = x
    last = len(self.specs) - 1
    for i, (_, _, _, stride) in enumerate(self.specs):
      h = getattr(self, f"conv_{i}")(h, stride)
      h = _apply_norm(getattr(self, f"norm_{i}"), h, is_training)
      if i < last:
        h = torch.relu(h)
    return torch.relu(h + shortcut)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
  """Flax's nn.max_pool(window 3x3, strides 2, "SAME") on NCHW input."""
  top, bottom = same_padding(x.shape[2], 3, 2)
  left, right = same_padding(x.shape[3], 3, 2)
  return F.max_pool2d(F.pad(x, (left, right, top, bottom),
                            value=float("-inf")), 3, 2)


class ResNet(nn.Module):
  """ResNet returning {"group_0": ..., "group_3": ...} NCHW feature maps."""

  def __init__(self, config: ResNetConfig = ResNetConfig()):
    super().__init__()
    self.config = config
    self.stem_conv = Conv(3, config.stem_channels, config.stem_kernel,
                          bias=False)
    self.stem_norm = (None if config.resnet_v2 else
                      _make_norm(config.normalization, config.stem_channels))
    block_cls = BlockV2 if config.resnet_v2 else BlockV1
    in_ch = config.stem_channels
    self.block_names = []
    for g, (channels, num_blocks, stride, proj) in enumerate(
        zip(config.channels_per_group, config.blocks_per_group,
            config.strides, config.use_projection)
    ):
      names = []
      for b in range(num_blocks):
        name = f"group_{g}_block_{b}"
        self.add_module(
            name,
            block_cls(in_ch, channels, stride if b == 0 else 1,
                      proj if b == 0 else False, config.bottleneck,
                      config.normalization),
        )
        in_ch = channels
        names.append(name)
      self.block_names.append(names)

  def forward(self, x: torch.Tensor,
              is_training: bool = False) -> Dict[str, torch.Tensor]:
    """`is_training`: BatchNorm normalizes by the batch's statistics and
    moves its running ones (else by the running ones)."""
    cfg = self.config
    x = self.stem_conv(x, cfg.stem_stride)
    if not cfg.resnet_v2:
      x = torch.relu(_apply_norm(self.stem_norm, x, is_training))
    if cfg.use_max_pool:
      x = max_pool_same(x)
    outputs = {}
    for g, names in enumerate(self.block_names):
      for name in names:
        x = getattr(self, name)(x, is_training)
      outputs[f"group_{g}"] = x
    return outputs

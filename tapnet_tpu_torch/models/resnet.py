"""ResNet feature backbone (port of tapnet_tpu/models/resnet.py, TAPIR's v2
configuration).

TAPIR builds the pre-activation (v2) ResNet with InstanceNorm, strides
(1, 2, 2, 1), channels (64, highres, 256, lowres) and no max-pool, giving a
stride-4 "hires" map (group 1) and a stride-8 "lowres" map (group 3). Only that
configuration is ported; the post-activation BlockV1 and the other
normalizations wait for a later slice. Activations are NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch
from torch import nn

from tapnet_tpu_torch.models.layers import Conv, InstanceNorm


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
  blocks_per_group: Sequence[int] = (2, 2, 2, 2)
  channels_per_group: Sequence[int] = (64, 128, 256, 256)
  use_projection: Sequence[bool] = (True, True, True, True)
  strides: Sequence[int] = (1, 2, 2, 1)
  stem_channels: int = 64
  stem_kernel: int = 7
  stem_stride: int = 2


class BlockV2(nn.Module):
  """Pre-activation residual block (norm -> relu -> conv), projection taken
  from the post-activation input."""

  def __init__(self, in_channels: int, channels: int, stride: int,
               use_projection: bool):
    super().__init__()
    self.stride = stride
    self.norm_0 = InstanceNorm(in_channels)
    self.conv_0 = Conv(in_channels, channels, 3, bias=False)
    self.norm_1 = InstanceNorm(channels)
    self.conv_1 = Conv(channels, channels, 3, bias=False)
    self.proj_conv = (
        Conv(in_channels, channels, 1, bias=False) if use_projection else None
    )

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(self.norm_0(x))
    shortcut = x if self.proj_conv is None else self.proj_conv(h, self.stride)
    h = self.conv_0(h, self.stride)
    h = torch.relu(self.norm_1(h))
    return self.conv_1(h) + shortcut


class ResNet(nn.Module):
  """ResNet returning {"group_0": ..., "group_3": ...} NCHW feature maps."""

  def __init__(self, config: ResNetConfig = ResNetConfig()):
    super().__init__()
    self.config = config
    self.stem_conv = Conv(3, config.stem_channels, config.stem_kernel,
                          bias=False)
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
            BlockV2(in_ch, channels, stride if b == 0 else 1,
                    proj if b == 0 else False),
        )
        in_ch = channels
        names.append(name)
      self.block_names.append(names)

  def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    x = self.stem_conv(x, self.config.stem_stride)
    outputs = {}
    for g, names in enumerate(self.block_names):
      for name in names:
        x = getattr(self, name)(x)
      outputs[f"group_{g}"] = x
    return outputs

"""TAP-Net: the original cost-volume baseline tracker (port of
tapnet_tpu/models/tapnet.py).

TSM-ResNet-18 features (stride 8, the unit_2 endpoint, each feature vector
L2-normalized) -> a float32 cost volume of each query's feature against
every frame's grid -> a convolutional position head with a soft-argmax and
an occlusion head; no refinement. The cost volume is time-major,
[T * B * N, heads, H, W], and queries run in memory-bounding chunks.

The JAX version's convolutions and einsum are XLA operations, not Pallas
kernels, so this module runs on PyTorch's convolutions and matrix products.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tapnet_tpu_torch.models import tapir, tsm_resnet
from tapnet_tpu_torch.utils import sampling, transforms


@dataclasses.dataclass(frozen=True)
class TapNetConfig:
  feature_grid_stride: int = 8
  num_heads: int = 1
  softmax_temperature: float = 10.0
  depth: int = 18


class TapNetHeads(nn.Module):
  """Position and occlusion heads over a [T * BN, heads, H, W] cost volume.
  The Flax heads' (1, 3, 3) kernels act on each frame alone, so they are 2D
  convolutions here."""

  def __init__(self, num_heads: int = 1, softmax_temperature: float = 10.0):
    super().__init__()
    self.softmax_temperature = softmax_temperature
    self.pos_conv = tsm_resnet.SameConv(num_heads, 16, 3)
    self.pos_out = tsm_resnet.SameConv(16, 1, 3)
    self.occ_conv = tsm_resnet.SameConv(16, 32, 3, stride=2)
    self.occ_dense = nn.Linear(32, 16)
    self.occ_out = nn.Linear(16, 1)

  def forward(self, cost_volume: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (position heatmaps [TBN, H, W], occlusion logits [TBN])."""
    hid = torch.relu(self.pos_conv(cost_volume))
    pos = self.pos_out(hid)[:, 0]
    n, h, w = pos.shape
    pos = torch.softmax((pos * self.softmax_temperature).reshape(n, h * w),
                        -1).reshape(n, h, w)
    occ = self.occ_conv(hid).mean((2, 3))
    occ = self.occ_out(torch.relu(self.occ_dense(occ)))
    return pos, occ[:, 0]


class TAPNet(nn.Module):
  """TAP-Net tracker."""

  def __init__(self, config: TapNetConfig = TapNetConfig()):
    super().__init__()
    self.config = config
    self.backbone = tsm_resnet.TSMResNetV2(
        tsm_resnet.TSMResNetConfig(
            depth=config.depth,
            channel_shift_fraction=(0.125, 0.125, 0.0, 0.0),
            output_stride=config.feature_grid_stride),
        final_endpoint="unit_2")
    self.heads = TapNetHeads(config.num_heads, config.softmax_temperature)

  def forward(
      self,
      video: torch.Tensor,
      query_points: torch.Tensor,
      query_chunk_size: Optional[int] = None,
      is_training: bool = False,
      get_query_feats: bool = False,
      feature_grid: Optional[torch.Tensor] = None,
      generator: Optional[torch.Generator] = None,
  ) -> Dict[str, torch.Tensor]:
    """Args:
      video: [B, T, H, W, 3] in [-1, 1].
      query_points: [B, N, 3] (t, y, x) raster points.
      query_chunk_size: memory-bounding chunk over queries.
      is_training: normalize by the batch's statistics and move the running
        ones.
      get_query_feats: also return the sampled per-query features.
      feature_grid: optionally reuse a grid computed before.
      generator: unused (TAP-Net draws no query order; the training loss
        passes the step's generator to every tracker).

    Returns:
      dict with tracks [B, N, T, 2], occlusion logits [B, N, T],
      feature_grid [B, T, h, w, C], and optionally query_feats [B, N, C].
    """
    del generator
    cfg = self.config
    if feature_grid is None:
      latent = self.backbone(video, is_training=is_training,
                             final_endpoint="unit_2")
      feature_grid = latent * torch.rsqrt(torch.clamp(
          latent.square().sum(-1, keepdim=True), min=1e-12))
    shape = video.shape
    position_in_grid = transforms.convert_grid_coordinates(
        query_points, shape[1:4], feature_grid.shape[1:4],
        coordinate_format="tyx")
    interp_features = sampling.sample_grid_batched(feature_grid,
                                                   position_in_grid)
    out = {"feature_grid": feature_grid}
    if get_query_feats:
      out["query_feats"] = interp_features

    b, t, h, w, c = feature_grid.shape
    d = cfg.num_heads
    grid_heads = feature_grid.reshape(b, t, h, w, c // d, d).float()
    query_heads = interp_features.reshape(b, -1, c // d, d).float()
    num_queries = query_points.shape[1]
    chunk = query_chunk_size or num_queries
    all_pts, all_occ = [], []
    for start in range(0, num_queries, chunk):
      q = query_heads[:, start:start + chunk]
      qp = query_points[:, start:start + chunk]
      n = q.shape[1]
      # Time-major cost volume [T, B, N, heads, H, W] -> [T*B*N, heads, H, W].
      cost = torch.einsum("bncd,bthwcd->tbndhw", q, grid_heads)
      pos, occ = self.heads(cost.reshape(t * b * n, d, h, w))
      pos = pos.reshape(t, b, n, h, w).permute(1, 2, 0, 3, 4)
      all_pts.append(sampling.heatmaps_to_points(pos, shape, query_points=qp))
      all_occ.append(occ.reshape(t, b, n).permute(1, 2, 0))
    out["tracks"] = torch.cat(all_pts, 1)
    out["occlusion"] = torch.cat(all_occ, 1)
    return out


def init_tapnet_params(config: TapNetConfig, generator: torch.Generator
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
  """The (params, batch_stats) trees of a fresh TAP-Net, in the Flax layout
  with numpy leaves, drawn from `generator` (a CPU generator): Flax's
  initialisers' distributions (every kernel LeCun's truncated normal over
  its fan-in, biases 0, norm scales 1; running means 0 and variances 1). The heads' kernels are Flax's
  (1, 3, 3, C_in, C_out)."""
  model = TAPNet(config)
  params: Dict[str, Any] = {}
  for name, p in model.named_parameters():
    path = name.split(".")
    leaf, shape = path[-1], tuple(p.shape)
    if leaf == "weight":
      leaf = "kernel"
      if len(shape) == 4:
        shape = (shape[2], shape[3], shape[1], shape[0])
        if path[0] == "heads":
          shape = (1,) + shape
      else:
        shape = shape[::-1]
      value = tapir.lecun_normal(shape, int(np.prod(shape[:-1])), generator)
    else:
      value = np.full(shape, 1.0 if leaf == "scale" else 0.0, np.float32)
    _set(params, path[:-1] + [leaf], value)
  stats: Dict[str, Any] = {}
  for name, buf in model.named_buffers():
    path = name.split(".")
    _set(stats, path, np.full(tuple(buf.shape),
                              1.0 if path[-1] == "var" else 0.0, np.float32))
  return params, stats


def _set(tree: Dict[str, Any], path, value) -> None:
  for part in path[:-1]:
    tree = tree.setdefault(part, {})
  tree[path[-1]] = value

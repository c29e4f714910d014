"""Bilinear sampling and soft-argmax (port of tapnet_tpu/utils/sampling.py).

Conventions, as in the JAX version:
  * Raster coordinates: (0, 0) is the corner of the top-left pixel, so
    sampling subtracts 0.5 before indexing.
  * Time ("t" of tyx) is in frame coordinates: no 0.5 shift.
  * mode="nearest": out-of-range corner indices are clamped.
  * mode="constant": out-of-range corners contribute zero.
"""

from __future__ import annotations

import functools
import itertools
import operator
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tapnet_tpu_torch.utils import transforms


def _corner_weights_1d(coord: torch.Tensor, size: int, mode: str):
  """((idx0, w0), (idx1, w1)) for linear interpolation on one axis.

  `coord` is in index space (0 = center of the first element).
  """
  lower = torch.floor(coord)
  frac = coord - lower
  i0 = lower.to(torch.int64)
  i1 = i0 + 1
  w0 = 1.0 - frac
  w1 = frac
  if mode == "nearest":
    return (i0.clamp(0, size - 1), w0), (i1.clamp(0, size - 1), w1)
  if mode == "constant":
    v0 = (i0 >= 0) & (i0 < size)
    v1 = (i1 >= 0) & (i1 < size)
    return (
        (i0.clamp(0, size - 1), w0 * v0),
        (i1.clamp(0, size - 1), w1 * v1),
    )
  raise ValueError(f"Unknown mode: {mode!r}")


def sample_grid_batched(
    grid: torch.Tensor, points: torch.Tensor, mode: str = "nearest"
) -> torch.Tensor:
  """Multilinear sampling of a batch of grids.

  Args:
    grid: [B, H, W, C] (points are (y, x)) or [B, T, H, W, C] (points are
      (t, y, x), t in frame coordinates).
    points: [B, ..., 2] or [B, ..., 3] raster points.
    mode: "nearest" or "constant".

  Returns:
    [B, ..., C]; float32 when the grid is bf16 (the corner weights are
    float32), as in the JAX version.
  """
  b, c = grid.shape[0], grid.shape[-1]
  spatial = grid.shape[1:-1]
  nd = points.shape[-1]
  if len(spatial) != nd:
    raise ValueError(f"grid {tuple(grid.shape)} vs points {tuple(points.shape)}")
  pts = points.reshape(b, -1, nd)
  # No 0.5 shift on the time axis (frame coordinates).
  shifts = (0.0,) * (nd - 2) + (0.5, 0.5)
  corners = [
      _corner_weights_1d(pts[..., d] - shifts[d], spatial[d], mode)
      for d in range(nd)
  ]
  flat = grid.reshape(b, -1, c)
  out = None
  for combo in itertools.product(*corners):
    idx = combo[0][0]
    for d in range(1, nd):
      idx = idx * spatial[d] + combo[d][0]
    weight = functools.reduce(operator.mul, [wgt for _, wgt in combo])
    vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
    term = vals * weight[..., None]
    out = term if out is None else out + term
  return out.reshape(points.shape[:-1] + (c,))


def sample_grid_2d(
    grid: torch.Tensor, points_yx: torch.Tensor, mode: str = "nearest"
) -> torch.Tensor:
  """Bilinear-samples one [H, W, C] grid at [..., 2] (y, x) raster points."""
  return sample_grid_batched(grid[None], points_yx[None], mode)[0]


def soft_argmax_heatmap(
    softmax_val: torch.Tensor, threshold: float = 5.0
) -> torch.Tensor:
  """Thresholded soft-argmax over [..., H, W] heatmaps -> [..., 2] (x, y).

  Averages the raster coordinates of the cells within `threshold` of the
  hard argmax, weighted by the heatmap values.
  """
  h, w = softmax_val.shape[-2:]
  batch_shape = softmax_val.shape[:-2]
  flat = softmax_val.reshape(-1, h * w)
  dev, dt = softmax_val.device, softmax_val.dtype

  ys = torch.arange(h, device=dev, dtype=dt) + 0.5
  xs = torch.arange(w, device=dev, dtype=dt) + 0.5
  coord_y = ys[:, None].expand(h, w).reshape(-1)
  coord_x = xs[None, :].expand(h, w).reshape(-1)

  argmax_idx = torch.argmax(flat, dim=-1)
  peak_y = coord_y[argmax_idx][:, None]
  peak_x = coord_x[argmax_idx][:, None]

  dist2 = (coord_y[None, :] - peak_y) ** 2 + (coord_x[None, :] - peak_x) ** 2
  valid = (dist2 < threshold**2).to(dt)

  weights = flat * valid
  denom = torch.clamp(weights.sum(-1), min=1e-12)
  out_x = (weights * coord_x[None, :]).sum(-1) / denom
  out_y = (weights * coord_y[None, :]).sum(-1) / denom
  return torch.stack([out_x, out_y], dim=-1).reshape(batch_shape + (2,))


def heatmaps_to_points(
    all_pairs_softmax: torch.Tensor,
    image_shape: Sequence[int],
    threshold: float = 5.0,
    query_points: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """Soft-argmax [B, N, T, H, W] heatmaps into [B, N, T, 2] (x, y) points.

  Args:
    all_pairs_softmax: [B, N, T, H, W] heatmaps.
    image_shape: [B, T, H_im, W_im, C] of the source video.
    threshold: soft-argmax radius.
    query_points: optional [B, N, 3] (t, y, x) raster points reproduced
      verbatim on their query frames.
  """
  out_points = soft_argmax_heatmap(all_pairs_softmax, threshold)

  feat_shape = tuple(all_pairs_softmax.shape[1:])  # (N, T, H, W)
  if feat_shape[1] != image_shape[1]:
    raise ValueError("Heatmap frame count must match image frame count.")
  out_points = transforms.convert_grid_coordinates(
      out_points, feat_shape[3:1:-1], tuple(image_shape)[3:1:-1]
  )

  if query_points is not None:
    query_frame = transforms.convert_grid_coordinates(
        query_points,
        tuple(image_shape)[1:4],
        feat_shape[1:4],
        coordinate_format="tyx",
    )[..., 0]
    query_frame = torch.round(query_frame).to(torch.int32)
    frame_ids = torch.arange(
        image_shape[1], dtype=torch.int32, device=query_frame.device
    )
    is_query = (query_frame[..., None] == frame_ids[None, None, :]).to(
        out_points.dtype
    )[..., None]
    query_xy = query_points[:, :, None, [2, 1]]
    out_points = out_points * (1.0 - is_query) + query_xy * is_query

  return out_points


def generate_default_resolutions(
    full_size: Tuple[int, int],
    train_size: Tuple[int, int],
    num_levels: Optional[int] = None,
) -> Sequence[Tuple[int, int]]:
  """Log-spaced (height, width) resolutions from train_size up to full_size."""
  if all(x == y for x, y in zip(train_size, full_size)):
    return [tuple(train_size)]

  if num_levels is None:
    size_ratio = np.array(full_size) / np.array(train_size)
    num_levels = int(np.ceil(np.max(np.log2(size_ratio))) + 1)
  if num_levels <= 1:
    return [tuple(train_size)]

  h, w = full_size[:2]
  ll_h, ll_w = train_size[:2]
  sizes = []
  for i in range(num_levels):
    frac = i / (num_levels - 1)
    sizes.append((
        int(round((ll_h * (h / ll_h) ** frac) // 8)) * 8,
        int(round((ll_w * (w / ll_w) ** frac) // 8)) * 8,
    ))
  return sizes


def preprocess_frames(frames: torch.Tensor) -> torch.Tensor:
  """uint8 [0, 255] frames -> float32 [-1, 1]."""
  return frames.to(torch.float32) / 255.0 * 2.0 - 1.0


def postprocess_occlusions(
    occlusions: torch.Tensor, expected_dist: torch.Tensor
) -> torch.Tensor:
  """Combines occlusion + uncertainty logits into a boolean visible flag."""
  return (1.0 - torch.sigmoid(occlusions)) * (
      1.0 - torch.sigmoid(expected_dist)
  ) > 0.5

"""TAPVid-3D metrics: 3D AJ / APD / OA with depth-aware thresholds (the
port's own copy of tapnet_tpu/tapvid3d/metrics.py; numpy only).

Behavioral parity: tapnet/tapvid3d/evaluation/metrics.py:23-328. Predictions
are metric 3D tracks (x, y, z in camera space); thresholds are either
depth-adaptive back-projected pixel radii (thresh * z / focal) or fixed
metric bubbles; several global-scale alignment strategies reconcile the
unknown monocular scale of predictions.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np

THRESHOLDS = (1, 2, 4, 8, 16)

PIXEL_TO_FIXED_METRIC_THRESH = {1: 0.01, 2: 0.04, 4: 0.16, 8: 0.64, 16: 2.56}


def _to_bnt(x: np.ndarray, order: str, has_channel: bool) -> np.ndarray:
  """Normalizes input order ('n t', 't n', 'b n t', 'b t n') to [b, n, t]."""
  parts = order.split(" ")
  if len(parts) == 2:
    x = x[None]
    parts = ["b"] + parts
  if parts != ["b", "n", "t"]:
    if parts == ["b", "t", "n"]:
      axes = (0, 2, 1) + ((3,) if has_channel else ())
      x = np.transpose(x, axes)
    else:
      raise ValueError(f"Unknown order {order!r}")
  return x


def threshold_multiplier(
    gt_tracks: np.ndarray, intrinsics_params: np.ndarray
) -> np.ndarray:
  """Depth-adaptive threshold scale: z / sqrt(fx * fy)."""
  focal = np.sqrt(intrinsics_params[..., 0] * intrinsics_params[..., 1])
  return gt_tracks[..., -1] / focal[..., None, None]


def _gather_local_neighborhoods(
    gt_occluded, gt_tracks, pred_occluded, pred_tracks, thresh
):
  """For each track, pool every (track, frame) sample within `thresh` of it
  into a pseudo-track; weights keep per-track averages comparable
  (reference: metrics.py:41-87)."""
  n = gt_occluded.shape[0]
  flat_gt = gt_tracks.reshape(-1, 3)
  flat_pr = pred_tracks.reshape(-1, 3)
  flat_gt_occ = gt_occluded.reshape(-1)
  flat_pr_occ = pred_occluded.reshape(-1)

  rows_gt, rows_pr, rows_gt_occ, rows_pr_occ = [], [], [], []
  for idx in range(n):
    diffs = gt_tracks - gt_tracks[idx : idx + 1]
    neighbor = (np.square(diffs).sum(-1) < thresh * thresh).reshape(-1)
    rows_gt.append(flat_gt[neighbor])
    rows_pr.append(flat_pr[neighbor])
    rows_gt_occ.append(flat_gt_occ[neighbor])
    rows_pr_occ.append(flat_pr_occ[neighbor])

  longest = max(r.shape[0] for r in rows_gt)

  def pad2(rows, width):
    out = np.zeros((n, longest, width), rows[0].dtype)
    for i, r in enumerate(rows):
      out[i, : r.shape[0]] = r.reshape(-1, width)
    return out

  out_gt = pad2(rows_gt, 3)
  out_pr = pad2(rows_pr, 3)
  out_gt_occ = pad2([r[:, None] for r in rows_gt_occ], 1)[..., 0]
  out_pr_occ = pad2([r[:, None] for r in rows_pr_occ], 1)[..., 0]
  valid = np.zeros((n, longest))
  for i, r in enumerate(rows_gt):
    valid[i, : r.shape[0]] = 1.0

  weighting = (1.0 - gt_occluded).sum(axis=1, keepdims=True) / np.maximum(
      1.0, ((1.0 - out_gt_occ) * valid).sum(axis=1, keepdims=True)
  )
  return out_gt_occ, out_gt, out_pr_occ, out_pr, valid * weighting


def _compute_scale_factor(
    gt_occluded, gt_tracks, pred_occluded, pred_tracks, scaling, query_points
):
  """Global scale aligning predicted tracks to ground truth."""
  if scaling == "none":
    return 1.0
  if scaling == "reproduce_2d":
    return gt_tracks[..., -1:] / pred_tracks[..., -1:]
  if scaling in ("per_trajectory", "local_neighborhood"):
    qf = np.round(query_points[..., 0]).astype(np.int32)[..., None]

    def depth_at_query(tracks):
      took = np.take_along_axis(tracks[..., -1], qf, axis=-1)
      return np.maximum(took, 1e-12)[..., None]

    return depth_at_query(gt_tracks) / depth_at_query(pred_tracks)

  pred_norms = np.sqrt(np.maximum(1e-12, np.square(pred_tracks).sum(-1)))
  gt_norms = np.sqrt(np.maximum(1e-12, np.square(gt_tracks).sum(-1)))
  either_occ = gt_occluded | pred_occluded
  pred_norms = np.where(either_occ, np.nan, pred_norms)
  gt_norms = np.where(either_occ, np.nan, gt_norms)

  if scaling == "median":
    return np.nanmedian(gt_norms, (-2, -1), keepdims=True) / np.nanmedian(
        pred_norms, (-2, -1), keepdims=True
    )
  if scaling == "mean":
    return np.nanmean(gt_norms, (-2, -1), keepdims=True) / np.nanmean(
        pred_norms, (-2, -1), keepdims=True
    )
  if scaling == "median_on_queries":
    idx = np.arange(pred_norms.shape[-2])
    qf = np.round(query_points[..., 0]).astype(np.int32).squeeze()
    pred_q = pred_norms[:, idx, qf][..., None]
    gt_q = gt_norms[:, idx, qf][..., None]
    return np.nanmedian(gt_q, (-2, -1), keepdims=True) / np.nanmedian(
        pred_q, (-2, -1), keepdims=True
    )
  raise ValueError(f"Unknown scaling: {scaling}")


def compute_tapvid3d_metrics(
    gt_occluded: np.ndarray,
    gt_tracks: np.ndarray,
    pred_occluded: np.ndarray,
    pred_tracks: np.ndarray,
    intrinsics_params: np.ndarray,
    get_trackwise_metrics: bool = False,
    scaling: str = "median",
    query_points: Optional[np.ndarray] = None,
    use_fixed_metric_threshold: bool = False,
    local_neighborhood_thresh: Optional[float] = 0.05,
    order: str = "n t",
) -> Mapping[str, np.ndarray]:
  """3D occlusion accuracy, <delta (APD), Jaccard and their averages.

  Args:
    gt_occluded / pred_occluded: [.. n, t] bool (layout per `order`).
    gt_tracks / pred_tracks: [..., 3] camera-space (x, y, z) tracks.
    intrinsics_params: [fx, fy, cx, cy].
    get_trackwise_metrics: keep the track axis.
    scaling: "median" | "mean" | "per_trajectory" | "local_neighborhood" |
      "median_on_queries" | "reproduce_2d" | "none".
    query_points: [.., n, 3] (t, y, x); required by per-trajectory scalings.
    use_fixed_metric_threshold: metric bubbles instead of depth-adaptive.
    local_neighborhood_thresh: pooling radius for local_neighborhood.
    order: input axis order ("n t", "t n", "b n t", "b t n").

  Returns:
    dict of metrics in [0, 1].
  """
  batched = len(order.split(" ")) == 3
  if scaling == "local_neighborhood" and batched:
    raise ValueError("local_neighborhood does not support batched inputs.")

  gt_occluded = _to_bnt(np.asarray(gt_occluded, bool), order, False)
  pred_occluded = _to_bnt(np.asarray(pred_occluded, bool), order, False)
  gt_tracks = _to_bnt(np.asarray(gt_tracks), order, True)
  pred_tracks = _to_bnt(np.asarray(pred_tracks), order, True)
  if query_points is not None:
    query_points = np.asarray(query_points)
    if query_points.ndim == 2:
      query_points = query_points[None]

  scale = _compute_scale_factor(
      gt_occluded, gt_tracks, pred_occluded, pred_tracks, scaling,
      query_points,
  )

  weights = np.ones(gt_occluded.shape)
  if scaling == "local_neighborhood":
    (
        gt_occluded_n,
        gt_tracks_n,
        pred_occluded_n,
        pred_tracks_n,
        weights_n,
    ) = _gather_local_neighborhoods(
        gt_occluded[0],
        gt_tracks[0],
        pred_occluded[0],
        pred_tracks[0],
        local_neighborhood_thresh,
    )
    gt_occluded, gt_tracks = gt_occluded_n[None], gt_tracks_n[None]
    pred_occluded, pred_tracks = pred_occluded_n[None], pred_tracks_n[None]
    weights = weights_n[None]
    # local_neighborhood consumed the [b] axis structure; scale is [n, 1, 1].
    scale = scale  # already per-trajectory shaped

  pred_tracks = pred_tracks * scale

  reduce_axes = (-1,) if get_trackwise_metrics else (-2, -1)
  metrics = {}
  metrics["occlusion_accuracy"] = (
      (pred_occluded == gt_occluded) * weights
  ).sum(reduce_axes) / weights.sum(reduce_axes)

  visible = ~gt_occluded
  pred_visible = ~pred_occluded
  err2 = np.square(pred_tracks - gt_tracks).sum(-1)

  all_within, all_jaccard = [], []
  for thresh in THRESHOLDS:
    if use_fixed_metric_threshold:
      pointwise = PIXEL_TO_FIXED_METRIC_THRESH[thresh]
    else:
      pointwise = thresh * threshold_multiplier(
          gt_tracks, intrinsics_params
      )
    within = err2 < np.square(pointwise)
    correct = within & visible

    count_correct = (correct * weights).sum(reduce_axes)
    count_visible = (visible * weights).sum(reduce_axes)
    frac = count_correct / count_visible
    metrics[f"pts_within_{thresh}"] = frac
    all_within.append(frac)

    tp = ((correct & pred_visible) * weights).sum(reduce_axes)
    fp = ((~visible) & pred_visible) | ((~within) & pred_visible)
    fp = (fp * weights).sum(reduce_axes)
    gt_pos = (visible * weights).sum(reduce_axes)
    jac = tp / (gt_pos + fp)
    metrics[f"jaccard_{thresh}"] = jac
    all_jaccard.append(jac)

  metrics["average_jaccard"] = np.mean(np.stack(all_jaccard, -2), axis=-2)
  metrics["average_pts_within_thresh"] = np.mean(
      np.stack(all_within, -2), axis=-2
  )
  return metrics


def project_to_pixels(
    tracks_xyz: np.ndarray, intrinsics_params: np.ndarray
) -> np.ndarray:
  """Perspective-project camera-space (x, y, z) to pixel (u, v)."""
  fx, fy, cx, cy = intrinsics_params
  u = tracks_xyz[..., 0] / tracks_xyz[..., 2] * fx + cx
  v = tracks_xyz[..., 1] / tracks_xyz[..., 2] * fy + cy
  return np.stack([u, v], axis=-1)


def unproject_pixels(
    tracks_uv: np.ndarray, depth: np.ndarray, intrinsics_params: np.ndarray
) -> np.ndarray:
  """Lift pixel (u, v) + depth z to camera-space (x, y, z)."""
  fx, fy, cx, cy = intrinsics_params
  x = (tracks_uv[..., 0] - cx) / fx * depth
  y = (tracks_uv[..., 1] - cy) / fy * depth
  return np.stack([x, y, depth], axis=-1)

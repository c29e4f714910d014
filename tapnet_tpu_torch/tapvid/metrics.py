"""TAP-Vid metrics: occlusion accuracy, <delta^x, Jaccard, AJ (the port's own
copy of tapnet_tpu/tapvid/metrics.py; numpy only).

Behavioral parity: tapnet/tapvid/evaluation_datasets.py:48-227. All positions
are raster coordinates scaled to 256x256 by benchmark convention; metrics are
averaged per video and then across videos. The predictors hand back numpy
arrays, and the metrics are host-side bookkeeping.

The five pixel thresholds are one vectorized axis instead of a Python loop.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

THRESHOLDS = (1, 2, 4, 8, 16)


def compute_tapvid_metrics(
    query_points: np.ndarray,
    gt_occluded: np.ndarray,
    gt_tracks: np.ndarray,
    pred_occluded: np.ndarray,
    pred_tracks: np.ndarray,
    query_mode: str,
    get_trackwise_metrics: bool = False,
) -> Mapping[str, np.ndarray]:
  """Computes the TAP-Vid benchmark metrics for a batch of videos.

  Args:
    query_points: [b, n, 3] (t, y, x) query points.
    gt_occluded: [b, n, t] boolean, True = occluded.
    gt_tracks: [b, n, t, 2] (x, y) ground-truth positions (256x256 scale).
    pred_occluded: [b, n, t] boolean predictions.
    pred_tracks: [b, n, t, 2] predicted positions.
    query_mode: "first" (evaluate frames after the query only) or "strided"
      (evaluate all frames except the query frame).
    get_trackwise_metrics: keep the per-track axis instead of averaging over
      tracks within each video.

  Returns:
    dict of metrics, each [b] (or [b, n] if trackwise): occlusion_accuracy,
    pts_within_{k} / jaccard_{k} for k in 1,2,4,8,16, average_pts_within_thresh
    and average_jaccard.
  """
  query_points = np.asarray(query_points)
  gt_occluded = np.asarray(gt_occluded).astype(bool)
  gt_tracks = np.asarray(gt_tracks)
  pred_occluded = np.asarray(pred_occluded).astype(bool)
  pred_tracks = np.asarray(pred_tracks)

  num_frames = gt_tracks.shape[2]
  reduce_axes = (2,) if get_trackwise_metrics else (1, 2)

  # Valid evaluation frames per query.
  query_frame = np.round(query_points[..., 0]).astype(np.int32)  # [b, n]
  frame_ids = np.arange(num_frames)[None, None, :]
  if query_mode == "first":
    evaluation_points = frame_ids > query_frame[..., None]
  elif query_mode == "strided":
    evaluation_points = frame_ids != query_frame[..., None]
  else:
    raise ValueError(f"Unknown query mode {query_mode!r}")

  metrics = {}

  occ_match = (pred_occluded == gt_occluded) & evaluation_points
  metrics["occlusion_accuracy"] = occ_match.sum(reduce_axes) / (
      evaluation_points.sum(reduce_axes)
  )

  visible = ~gt_occluded
  pred_visible = ~pred_occluded

  # [b, n, t] squared error; thresholds vectorized as a leading axis.
  err2 = np.square(pred_tracks - gt_tracks).sum(axis=-1)
  thresh = np.asarray(THRESHOLDS, err2.dtype).reshape(
      (-1,) + (1,) * err2.ndim
  )
  within = err2[None] < np.square(thresh)  # [k, b, n, t]

  correct = within & visible[None]
  count_correct = (correct & evaluation_points[None]).sum(
      axis=tuple(a + 1 for a in reduce_axes)
  )
  count_visible = (visible & evaluation_points).sum(reduce_axes)
  frac_within = count_correct / count_visible[None]

  true_pos = (correct & pred_visible[None] & evaluation_points[None]).sum(
      axis=tuple(a + 1 for a in reduce_axes)
  )
  # FP: predicted visible but GT occluded, or too far from GT.
  false_pos = (~visible[None]) & pred_visible[None]
  false_pos = false_pos | ((~within) & pred_visible[None])
  false_pos = (false_pos & evaluation_points[None]).sum(
      axis=tuple(a + 1 for a in reduce_axes)
  )
  gt_pos = (visible & evaluation_points).sum(reduce_axes)
  jaccard = true_pos / (gt_pos[None] + false_pos)

  for i, k in enumerate(THRESHOLDS):
    metrics[f"pts_within_{k}"] = frac_within[i]
    metrics[f"jaccard_{k}"] = jaccard[i]
  metrics["average_pts_within_thresh"] = frac_within.mean(axis=0)
  metrics["average_jaccard"] = jaccard.mean(axis=0)
  return metrics


TABLE_FIELDS = (
    "average_jaccard",
    "average_pts_within_thresh",
    "occlusion_accuracy",
) + tuple(f"jaccard_{k}" for k in THRESHOLDS) + tuple(
    f"pts_within_{k}" for k in THRESHOLDS
)


def latex_table(mean_scalars: Mapping[str, float]) -> str:
  """LaTeX row of the standard TAP-Vid metric table (AJ, <d_avg, OA, ...)."""
  if "average_jaccard" in mean_scalars:
    fields = TABLE_FIELDS
    header = (
        "AJ & $<\\delta^{x}_{avg}$ & OA & "
        + " & ".join(f"Jac. $\\delta^{{{i}}}$" for i in range(5))
        + " & "
        + " & ".join(f"$<\\delta^{{{i}}}$" for i in range(5))
    )
  else:
    fields = tuple(f"PCK@0.{k}" for k in range(1, 6))
    header = " & ".join(fields)
  body = " & ".join(
      f"{float(np.asarray(mean_scalars[f]) * 100):.3}" for f in fields
  )
  return "\n".join([header, body])


def compute_pck_metrics(
    dist: np.ndarray,
    scale: np.ndarray,
    thresholds: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5),
) -> Mapping[str, float]:
  """PCK@k for JHMDB-style pose evaluation.

  Args:
    dist: [...] pixel distances between prediction and ground truth.
    scale: broadcastable person-size normalizer.
    thresholds: PCK fractions.

  Returns:
    {"PCK@0.1": ..., ...}
  """
  out = {}
  for t in thresholds:
    out[f"PCK@{t}"] = float(np.mean(dist < t * scale))
  return out

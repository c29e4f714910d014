"""AJ_RD: re-detection Average Jaccard (TAPNext++ metric; the port's own copy
of tapnet_tpu/tapvid/aj_rd.py; numpy only).

Behavioral parity: tapnet/tapnextpp/metrics/aj_rd.py. A reappearance event is
a frame where a ground-truth point becomes visible after d >= 1 invisible
frames; an event is *eligible* if its invisibility duration exceeds every
earlier event's duration on the same track. For each eligible event, Jaccard
is computed from the reappearance frame to the end of the video, then
averaged over events with duration >= d_min, over d_min in {1, 4, 16, 64,
256} and distance thresholds {1, 2, 4, 8, 16} px.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

DIST_THRESHOLDS = (1, 2, 4, 8, 16)
DMIN_THRESHOLDS = (1, 4, 16, 64, 256)


def segment_jaccard(
    pred_track: np.ndarray,
    pred_vis: np.ndarray,
    gt_track: np.ndarray,
    gt_vis: np.ndarray,
    dist_threshold: float,
) -> float:
  """Jaccard over one [L]-frame segment (NaN if no GT or predictions)."""
  within = (
      np.linalg.norm(pred_track - gt_track, axis=-1) <= dist_threshold
  )
  correct = within & gt_vis
  tp = np.sum(correct & pred_vis)
  fp = np.sum(((~gt_vis) & pred_vis) | ((~within) & pred_vis))
  denom = np.sum(gt_vis) + fp
  return float(tp) / denom if denom else float("nan")


def consecutive_invisibility(is_visible: np.ndarray) -> np.ndarray:
  """d[b, t, n]: number of consecutive invisible frames ending at t-1."""
  b, t, n = is_visible.shape
  d = np.zeros((b, t, n), np.int32)
  for ti in range(1, t):
    d[:, ti] = np.where(~is_visible[:, ti - 1], d[:, ti - 1] + 1, 0)
  return d


def find_eligible_reappearances(gt_visible: np.ndarray):
  """Returns (indices (b, t, n) arrays, durations) of eligible events:
  reappearances whose invisibility duration exceeds all earlier events on
  the same track."""
  gt_visible = gt_visible.astype(bool)
  reapp = np.zeros_like(gt_visible)
  reapp[:, 1:] = gt_visible[:, 1:] & ~gt_visible[:, :-1]
  durations_all = consecutive_invisibility(gt_visible)

  bs, ts, ns = np.nonzero(reapp)
  if bs.size == 0:
    return None
  durs = durations_all[bs, ts, ns]

  eligible = np.zeros(bs.size, bool)
  # Events from nonzero() are already sorted by (b, t, n); regroup per track.
  order = np.lexsort((ts, ns, bs))
  max_seen: Dict[tuple, int] = {}
  for idx in order:
    key = (bs[idx], ns[idx])
    if durs[idx] > max_seen.get(key, -1):
      eligible[idx] = True
      max_seen[key] = durs[idx]
  if not eligible.any():
    return None
  return (bs[eligible], ts[eligible], ns[eligible]), durs[eligible]


def compute_redetection_metrics(
    pred_tracks: np.ndarray,  # [B, T, N, 2]
    pred_visible: np.ndarray,  # [B, T, N]
    gt_tracks: np.ndarray,
    gt_visible: np.ndarray,
    dist_thresholds: Optional[Sequence[int]] = None,
    d_min_thresholds: Optional[Sequence[int]] = None,
) -> Dict[str, float]:
  """AJ_RD metric family. Returns {AJ_RD, AJ_RD_dmin{d}, AJ_RD_D{k}_dmin{d}}."""
  dist_thresholds = list(dist_thresholds or DIST_THRESHOLDS)
  d_min_thresholds = list(d_min_thresholds or DMIN_THRESHOLDS)
  pred_visible = np.asarray(pred_visible).astype(bool)
  gt_visible = np.asarray(gt_visible).astype(bool)
  pred_tracks = np.asarray(pred_tracks)
  gt_tracks = np.asarray(gt_tracks)

  found = find_eligible_reappearances(gt_visible)
  metrics: Dict[str, float] = {}
  if found is None:
    for d_min in d_min_thresholds:
      for k in dist_thresholds:
        metrics[f"AJ_RD_D{k}_dmin{d_min}"] = float("nan")
      metrics[f"AJ_RD_dmin{d_min}"] = float("nan")
    metrics["AJ_RD"] = float("nan")
    return metrics

  (bs, ts, ns), durations = found
  per_dist: Dict[int, np.ndarray] = {}
  for k in dist_thresholds:
    vals = np.full(bs.size, np.nan)
    for i in range(bs.size):
      b, t_r, n = bs[i], ts[i], ns[i]
      vals[i] = segment_jaccard(
          pred_tracks[b, t_r:, n],
          pred_visible[b, t_r:, n],
          gt_tracks[b, t_r:, n],
          gt_visible[b, t_r:, n],
          k,
      )
    per_dist[k] = vals

  for d_min in d_min_thresholds:
    mask = durations >= d_min
    if not mask.any():
      for k in dist_thresholds:
        metrics[f"AJ_RD_D{k}_dmin{d_min}"] = float("nan")
      metrics[f"AJ_RD_dmin{d_min}"] = float("nan")
      continue
    row: List[float] = []
    for k in dist_thresholds:
      vals = per_dist[k][mask]
      vals = vals[~np.isnan(vals)]
      v = float(vals.mean()) if vals.size else float("nan")
      metrics[f"AJ_RD_D{k}_dmin{d_min}"] = v
      row.append(v)
    metrics[f"AJ_RD_dmin{d_min}"] = (
        float(np.nanmean(row)) if np.any(~np.isnan(row)) else float("nan")
    )

  final = [
      metrics[f"AJ_RD_dmin{d}"]
      for d in d_min_thresholds
      if f"AJ_RD_dmin{d}" in metrics
  ]
  metrics["AJ_RD"] = (
      float(np.nanmean(final)) if np.any(~np.isnan(final)) else float("nan")
  )
  return metrics

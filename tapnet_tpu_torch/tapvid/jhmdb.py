"""JHMDB pose-tracking PCK evaluation (the port's own copy of
tapnet_tpu/tapvid/jhmdb.py; numpy only).

Behavioral parity: tapnet/training/supervised_point_prediction.py:735-837.
Per video, predicted joint tracks are rescaled to the original resolution and
normalized by 0.6x the per-frame GT person bounding-box diagonal; PCK@alpha
is the fraction of visible joints within alpha of that normalizer, averaged
per joint and then over the 15 joints.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping

import numpy as np

NUM_JOINTS = 15
PCK_ALPHAS = (0.1, 0.2, 0.3, 0.4, 0.5)


def pck_evaluate(
    results: List[Mapping[str, np.ndarray]],
) -> Dict[str, float]:
  """Aggregates PCK over accumulated per-video results.

  Each result dict holds: pred_pose [1, J, T, 2] at original resolution,
  gt_pose_orig [1, J, T, 2], im_size (height, width).
  """
  dist_all: List[List[float]] = [[] for _ in range(NUM_JOINTS)]
  for sample in results:
    pred = np.transpose(sample["pred_pose"][0], (2, 0, 1))  # [2, J, T]
    gt = sample["gt_pose_orig"][0]  # [J, T, 2]
    height, width = sample["im_size"][:2]

    invalid = (
        (gt[:, 0:1, 0] < 0)
        | (gt[:, 0:1, 0] >= width)
        | (gt[:, 0:1, 1] < 0)
        | (gt[:, 0:1, 1] >= height)
    )
    visible = ~np.tile(invalid, [1, gt.shape[1]])  # [J, T]
    gt = np.transpose(gt, (2, 0, 1))  # [2, J, T]

    # Per-frame person box from visible joints.
    gt_max = gt.copy()
    gt_max[:, ~visible] = -1
    gt_min = gt.copy()
    gt_min[:, ~visible] = 1e6
    boxes = np.stack(
        [
            gt_max[0].max(0) - gt_min[0].min(0),
            gt_max[1].max(0) - gt_min[1].min(0),
        ]
    )
    norm = 0.6 * np.linalg.norm(boxes, axis=0)  # [T]

    err = np.linalg.norm(pred - gt, axis=0) / np.maximum(norm, 1e-12)  # [J,T]
    for j in range(NUM_JOINTS):
      dist_all[j].extend(err[j, visible[j]].tolist())

  out = {}
  for alpha in PCK_ALPHAS:
    per_joint = [
        100.0 * np.mean(np.asarray(d) <= alpha) if d else 0.0
        for d in dist_all
    ]
    out[f"PCK@{alpha}"] = float(np.mean(per_joint))
  return out


def evaluate_jhmdb(
    predict_fn: Callable,
    dataset: Iterable,
    verbose: bool = True,
) -> Dict[str, float]:
  """Runs a tracker over the JHMDB reader and reports PCK.

  Args:
    predict_fn: (video [1,T,H,W,3] in [-1,1], query_points [1,Q,3]) ->
      {"tracks" [1,Q,T,2] (x, y) at video resolution, ...}.
    dataset: generator from tapvid.datasets.create_jhmdb_dataset.

  Returns:
    {"PCK@0.1": ..., ..., "PCK@0.5": ...}
  """
  results = []
  for i, element in enumerate(dataset):
    ex = element["jhmdb"]
    video = ex["video"]
    out = predict_fn(video, ex["query_points"])
    # Rescale predictions from inference resolution to original pixels.
    h, w = video.shape[2:4]
    oh, ow = ex["im_size"][:2]
    pred = np.asarray(out["tracks"]) * np.array([ow / w, oh / h])
    # [1, Q, T, 2] -> [1, J, T, 2]
    results.append({
        "pred_pose": pred,
        "gt_pose_orig": np.asarray(ex["gt_pose_orig"]),
        "im_size": np.asarray(ex["im_size"]),
    })
    if verbose:
      running = pck_evaluate(results)
      print(f"[{i + 1}] {ex.get('fname', '')} PCK@0.2="
            f"{running['PCK@0.2']:.2f}")
  return pck_evaluate(results)

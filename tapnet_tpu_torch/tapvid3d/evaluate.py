"""TAPVid-3D evaluation CLI of the port (its own copy of
tapnet_tpu/tapvid3d/evaluate.py; numpy, with PIL imported lazily).

Behavioral parity: tapnet/tapvid3d/evaluation/evaluate_model.py. Compares a
directory of ground-truth npz files (images_jpeg_bytes, queries_xyt,
tracks_XYZ, visibility, fx_fy_cx_cy) against a directory of prediction npz
files (tracks_XYZ, visibility), per data source (adt / pstudio / drivetrack),
with intrinsics rescaled so the short image side is 256.

CLI:
  python -m tapnet_tpu_torch.tapvid3d.evaluate --gt_dir ... --pred_dir ... \
      --data_sources adt,pstudio --depth_scalings median
"""

from __future__ import annotations

import argparse
import glob
import io
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from tapnet_tpu_torch.tapvid3d import metrics as metrics3d


def rescale_factor_for_short_side(
    height: int, width: int, short_side: int = 256
) -> float:
  return short_side / min(height, width)


def _jpeg_hw(jpeg_bytes: bytes):
  from PIL import Image

  with io.BytesIO(jpeg_bytes) as b:
    img = Image.open(b).convert("RGB")
  return np.array(img).shape[:2]


def evaluate_npz_pair(
    gt_path: str,
    pred_path: str,
    depth_scalings: Sequence[str],
    metric_eval_resolution: int = 256,
) -> Dict[str, Mapping[str, np.ndarray]]:
  """Metrics for one (ground truth, prediction) npz pair, per scaling."""
  with open(gt_path, "rb") as f:
    gt = np.load(f, allow_pickle=True)
    images = gt["images_jpeg_bytes"]
    queries_xyt = gt["queries_xyt"]
    tracks_xyz = gt["tracks_XYZ"]
    visibles = gt["visibility"]
    intrinsics = gt["fx_fy_cx_cy"]

  h, w = _jpeg_hw(images[0])
  scale = rescale_factor_for_short_side(h, w, metric_eval_resolution)
  intrinsics_resized = intrinsics * scale

  with open(pred_path, "rb") as f:
    pred = np.load(f, allow_pickle=True)
    pred_tracks = pred["tracks_XYZ"]
    pred_vis = pred["visibility"]

  out = {}
  for scaling in depth_scalings:
    out[scaling] = metrics3d.compute_tapvid3d_metrics(
        gt_occluded=~visibles.astype(bool),
        gt_tracks=tracks_xyz,
        pred_occluded=~pred_vis.astype(bool),
        pred_tracks=pred_tracks,
        intrinsics_params=intrinsics_resized,
        scaling=scaling,
        query_points=queries_xyt[..., ::-1],  # xyt -> (t, y, x)
        order="t n",
    )
  return out


def evaluate_directory(
    gt_dir: str,
    pred_dir: str,
    depth_scalings: Sequence[str] = ("median",),
    npz_filenames: Optional[List[str]] = None,
    verbose: bool = True,
) -> Dict[str, Dict[str, float]]:
  """Averages per-video metrics over a directory pair."""
  if npz_filenames is None:
    npz_filenames = sorted(
        os.path.basename(p) for p in glob.glob(os.path.join(gt_dir, "*.npz"))
    )
  if not npz_filenames:
    raise ValueError(f"No npz files found in {gt_dir}")

  sums: Dict[str, Dict[str, float]] = {
      s: {} for s in depth_scalings
  }
  count = 0
  for i, name in enumerate(npz_filenames):
    video_metrics = evaluate_npz_pair(
        os.path.join(gt_dir, name),
        os.path.join(pred_dir, name),
        depth_scalings,
    )
    count += 1
    for scaling, md in video_metrics.items():
      for k, v in md.items():
        sums[scaling][k] = sums[scaling].get(k, 0.0) + float(np.mean(v))
    if verbose:
      aj = float(np.mean(video_metrics[depth_scalings[0]]["average_jaccard"]))
      print(f"[{i + 1}/{len(npz_filenames)}] {name}: AJ={aj:.4f}")

  return {
      scaling: {k: v / count for k, v in md.items()}
      for scaling, md in sums.items()
  }


def main(argv=None):
  parser = argparse.ArgumentParser(description="TAPVid-3D evaluation")
  parser.add_argument("--gt_dir", required=True,
                      help="root dir; may contain per-source subdirs")
  parser.add_argument("--pred_dir", required=True)
  parser.add_argument(
      "--data_sources", default="",
      help="comma-separated subdirs (adt, pstudio, drivetrack); empty = "
      "evaluate gt_dir directly",
  )
  parser.add_argument("--depth_scalings", default="median")
  parser.add_argument("--use_minival", action="store_true")
  parser.add_argument("--output_json", default=None)
  args = parser.parse_args(argv)

  scalings = args.depth_scalings.split(",")
  results = {}
  sources = [s for s in args.data_sources.split(",") if s]
  if not sources:
    results["all"] = evaluate_directory(args.gt_dir, args.pred_dir, scalings)
  else:
    for source in sources:
      names = None
      if args.use_minival:
        try:
          from tapnet_tpu_torch.tapvid3d import splits

          names = splits.get_minival_files(source)
        except (ImportError, AttributeError):
          pass
      results[source] = evaluate_directory(
          os.path.join(args.gt_dir, source),
          os.path.join(args.pred_dir, source),
          scalings,
          npz_filenames=names,
      )

  print(json.dumps(results, indent=2))
  if args.output_json:
    with open(args.output_json, "w") as f:
      json.dump(results, f, indent=2)
  return results


if __name__ == "__main__":
  main()

"""Converts Kubric point-tracking examples to the npz ingest layout (port
of tapnet_tpu/data/kubric_convert.py; numpy only).

The reference trains on the external Kubric MOVi point-tracking TF pipeline
(`tapnet/training/experiment.py:263`, `kubric.challenges.point_tracking
.dataset.create_point_tracking_dataset`). The port ingests plain npz files
instead (`tapnet_tpu_torch/data/kubric.py::KubricNpzReader`) so the
training loop has no TensorFlow dependency; this module is the bridge that
exports the TF pipeline ONCE into that layout:

  python -m tapnet_tpu_torch.data.kubric_convert --out_dir /data/kubric_npz \
      --num_examples 10000 --train_size 256

Each output file `kubric_NNNNNN.npz` holds:

  video          [T, H, W, 3] uint8
  target_points  [N, T, 2] float32 (x, y) raster at video resolution
  occluded       [N, T] bool

The conversion core (`write_examples`) takes any iterator of example dicts,
so it also covers exports from custom Kubric renders or other pipelines
that produce the same keys; the kubric/TF import is only needed by the CLI
source and is gated with a clear error when absent.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, Iterator, Mapping, Optional

import numpy as np


def example_to_npz_arrays(
    example: Mapping[str, np.ndarray],
) -> Mapping[str, np.ndarray]:
  """Normalizes one pipeline example to the npz ingest schema.

  Accepts the kubric pipeline conventions: video either uint8 or float in
  [-1, 1]; an optional leading singleton batch dim on every array (the TF
  pipeline yields unbatched, but exported iterators sometimes carry B=1).
  """
  out = {}
  for key in ("video", "target_points", "occluded"):
    if key not in example:
      raise KeyError(
          f"example is missing {key!r}; got keys {sorted(example)}"
      )
    out[key] = np.asarray(example[key])

  video = out["video"]
  if video.ndim == 5 and video.shape[0] == 1:
    out = {k: v[0] for k, v in out.items()}
    video = out["video"]
  if video.ndim != 4 or video.shape[-1] != 3:
    raise ValueError(f"video must be [T, H, W, 3], got {video.shape}")

  if np.issubdtype(video.dtype, np.floating):
    # Kubric pipeline videos are float in [-1, 1].
    video = np.clip((video + 1.0) * (255.0 / 2.0), 0, 255)
  out["video"] = video.astype(np.uint8)

  pts = out["target_points"].astype(np.float32)
  occ = out["occluded"].astype(bool)
  if pts.ndim != 3 or pts.shape[-1] != 2:
    raise ValueError(f"target_points must be [N, T, 2], got {pts.shape}")
  if occ.shape != pts.shape[:2]:
    raise ValueError(
        f"occluded {occ.shape} does not match target_points {pts.shape}"
    )
  if pts.shape[1] != video.shape[0]:
    raise ValueError(
        f"track length {pts.shape[1]} != video frames {video.shape[0]}"
    )
  out["target_points"] = pts
  out["occluded"] = occ
  return out


def write_examples(
    examples: Iterable[Mapping[str, np.ndarray]],
    out_dir: str,
    num_examples: Optional[int] = None,
) -> int:
  """Writes examples as kubric_NNNNNN.npz under out_dir; returns count.

  Files are written atomically (tmp + rename) so a partially-written
  example never enters the reader's glob.
  """
  os.makedirs(out_dir, exist_ok=True)
  count = 0
  for example in examples:
    if num_examples is not None and count >= num_examples:
      break
    arrays = example_to_npz_arrays(example)
    path = os.path.join(out_dir, f"kubric_{count:06d}.npz")
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    count += 1
    if count % 100 == 0:
      print(f"wrote {count} examples", flush=True)
  return count


def kubric_tf_source(
    train_size: int = 256, **dataset_kwargs
) -> Iterator[Mapping[str, np.ndarray]]:
  """Yields numpy examples from the external Kubric TF pipeline.

  Requires the `kubric` package (and its TF stack) — the same dependency
  the reference training pipeline needs; everything downstream of this
  module is TF-free.
  """
  try:
    from kubric.challenges.point_tracking import dataset as kubric_dataset
  except ImportError as e:
    raise ImportError(
        "kubric_tf_source needs the external `kubric` package (pip install "
        "kubric, plus tensorflow_datasets); alternatively feed "
        "write_examples() any iterator producing "
        "{video, target_points, occluded} dicts."
    ) from e

  ds = kubric_dataset.create_point_tracking_dataset(
      train_size=(train_size, train_size),
      batch_dims=[],
      shuffle_buffer_size=None,
      **dataset_kwargs,
  )
  for example in ds.as_numpy_iterator():
    # The pipeline nests under the dataset name on some versions.
    if "video" not in example and len(example) == 1:
      example = next(iter(example.values()))
    yield example


def main(argv=None) -> None:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument("--out_dir", required=True)
  parser.add_argument("--num_examples", type=int, default=10000)
  parser.add_argument("--train_size", type=int, default=256)
  args = parser.parse_args(argv)
  n = write_examples(
      kubric_tf_source(train_size=args.train_size),
      args.out_dir,
      num_examples=args.num_examples,
  )
  print(f"Converted {n} examples to {args.out_dir}")


if __name__ == "__main__":
  main()

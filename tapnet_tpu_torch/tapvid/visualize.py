"""Visualize one example of a TAP-Vid pickle as an mp4 with painted tracks
(the port's counterpart of tapnet_tpu/tapvid/visualize.py; numpy, with cv2
and PIL imported lazily).

Behavioral parity: tapnet/tapvid/visualize.py.

CLI:
  python -m tapnet_tpu_torch.tapvid.visualize --input_path tapvid_davis.pkl \
      --output_path out.mp4 [--index 3]
"""

from __future__ import annotations

import argparse
import pickle
import random

import numpy as np

from tapnet_tpu_torch.tapvid.datasets import _decode_frames, resize_video
from tapnet_tpu_torch.utils import viz


def visualize_example(example, output_path: str, fps: int = 25) -> None:
  frames = _decode_frames(example["video"])
  if frames.shape[1] > 360:
    frames = resize_video(frames, (360, 640))
  scale = np.array(frames.shape[2:0:-1])[None, None]
  painted = viz.paint_point_track(
      frames,
      example["points"] * scale,
      ~np.asarray(example["occluded"], bool),
  )
  viz.write_video(output_path, painted, fps=fps)


def main(argv=None):
  parser = argparse.ArgumentParser(description="TAP-Vid pickle visualizer")
  parser.add_argument("--input_path", required=True)
  parser.add_argument("--output_path", required=True)
  parser.add_argument(
      "--index", type=int, default=None, help="example index (default random)"
  )
  args = parser.parse_args(argv)

  with open(args.input_path, "rb") as f:
    data = pickle.load(f)
  if isinstance(data, dict):
    data = list(data.values())
  idx = (
      args.index
      if args.index is not None
      else random.randint(0, len(data) - 1)
  )
  visualize_example(data[idx], args.output_path)
  print(f"wrote {args.output_path} (example {idx})")


if __name__ == "__main__":
  main()

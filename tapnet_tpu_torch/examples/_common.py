"""Shared helpers for the port's example scripts (the counterpart of
examples/_common.py).

Every example runs end-to-end with no arguments: absent a checkpoint it
builds seeded random weights, and absent a video it renders a moving-sprite
clip (`tapnet_tpu_torch/data/synthetic.py`, seeded) -- so each script
doubles as an end-to-end smoke test of its pipeline. The models run on the
CUDA card unless the script is given `--device cpu`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from tapnet_tpu_torch.utils import viz


def add_device_flag(parser) -> None:
  parser.add_argument("--device", default="cuda",
                      help="torch device (default the CUDA card; cpu to "
                      "run without one)")


def load_video(
    path: Optional[str],
    num_frames: int = 24,
    resize: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
  """Reads a video file as [T, H, W, 3] uint8 (cv2), or renders a synthetic
  clip of `num_frames` frames at `resize` (default 256x256) from a seeded
  generator."""
  if path:
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
      ok, frame = cap.read()
      if not ok:
        break
      frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
      if resize is not None:
        frame = cv2.resize(frame, (resize[1], resize[0]))
      frames.append(frame)
    cap.release()
    if not frames:
      raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)

  from tapnet_tpu_torch.data import synthetic

  h, w = resize or (256, 256)
  batch = synthetic.make_batch(
      torch.Generator().manual_seed(0), batch_size=1, num_frames=num_frames,
      height=h, width=w, num_queries=8,
  )
  video = batch["video"][0].numpy()  # [-1, 1]
  return ((video + 1.0) * 127.5).astype(np.uint8)


def normalize_video(video_u8: np.ndarray) -> np.ndarray:
  """uint8 [T, H, W, 3] -> float32 [1, T, H, W, 3] in [-1, 1]."""
  return (video_u8.astype(np.float32) / 255.0 * 2.0 - 1.0)[None]


def tapir_params(checkpoint: Optional[str], config):
  """Loads a TAPIR checkpoint (a Haiku .npy or a Flax-layout tree, through
  the port's converter) or builds seeded random weights."""
  from tapnet_tpu_torch.checkpoints import tapir_checkpoint
  from tapnet_tpu_torch.models import tapir as tapir_lib

  if checkpoint and os.path.exists(checkpoint):
    return tapir_checkpoint.load_tapir_checkpoint(checkpoint)
  print("no checkpoint given — using RANDOM weights (pipeline demo only)")
  return tapir_lib.init_tapir_params(config, torch.Generator().manual_seed(42))


def tiny_tapir(config):
  """Shrinks a TapirConfig for quick smoke runs: 2 mixer blocks and
  single-block ResNet groups. The pipeline (features, cost volume,
  refinement, heads) is unchanged; only depth shrinks."""
  import dataclasses

  return dataclasses.replace(
      config, num_mixer_blocks=2, blocks_per_group=(1, 1, 1, 1)
  )


def grid_queries(
    frame: int, height: int, width: int, stride: int = 32
) -> np.ndarray:
  """Regular grid of (t, y, x) query points on one frame: [1, N, 3]."""
  ys = np.arange(stride // 2, height, stride, dtype=np.float32)
  xs = np.arange(stride // 2, width, stride, dtype=np.float32)
  yy, xx = np.meshgrid(ys, xs, indexing="ij")
  n = yy.size
  return np.stack(
      [np.full(n, frame, np.float32), yy.ravel(), xx.ravel()], axis=-1
  )[None]


def save_tracks_video(path, video_u8, tracks_xy, visibles):
  """Paints tracks onto the video and writes an mp4 (cv2). Returns the
  painted frames."""
  painted = viz.paint_point_track(video_u8, tracks_xy, visibles)
  viz.write_video(path, painted, fps=10)
  print(f"wrote {path}")
  return painted

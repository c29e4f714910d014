"""Kubric-format training data ingest (port of tapnet_tpu/data/kubric.py).

Consumes pre-exported Kubric examples as npz files, one per example, with:

  video          [T, H, W, 3] uint8
  target_points  [N, T, 2] (x, y) raster at video resolution
  occluded       [N, T] bool

Host work is limited to npz reads in a double-buffered thread
(`KubricNpzReader`); resize to the train resolution, normalization, query
sampling and colour augmentation run on the device (`prepare_batch`). The
random draws of a batch (which track and which visible frame each query
takes, and the colour transform) are made apart by `batch_draws` from a
`torch.Generator`, so a caller, or a test holding the port to the JAX
package's draws, can give its own.
"""

from __future__ import annotations

import glob
import os
import queue as queue_lib
import threading
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tapnet_tpu_torch.data import augmentations
from tapnet_tpu_torch.models.tapir import resize_video
from tapnet_tpu_torch.utils import transforms

Batch = Dict[str, torch.Tensor]


def batch_draws(generator: torch.Generator, occluded: torch.Tensor,
                num_queries: int, color_augment: bool = True) -> Batch:
  """The random values of one batch, on the generator's device: per example
  `num_queries` tracks drawn with replacement, weighted by their visible
  frame count (plus 1e-6), a frame drawn uniformly among each drawn track's
  visible frames (among all of them if it has none), and with
  `color_augment` the colour transform (`augmentations.color_draws`).

  occluded: [B, N, T] (bool or float).
  """
  visible = 1.0 - occluded.to(device=generator.device, dtype=torch.float32)
  b, n, t = visible.shape
  track_w = visible.sum(-1) + 1e-6
  tracks = torch.multinomial(track_w, num_queries, replacement=True,
                             generator=generator)
  frame_w = (torch.gather(visible, 1, tracks[..., None].expand(-1, -1, t))
             > 0).to(torch.float32)
  frame_w = torch.where(frame_w.sum(-1, keepdim=True) > 0, frame_w,
                        torch.ones_like(frame_w))
  frames = torch.multinomial(frame_w.reshape(b * num_queries, t), 1,
                             generator=generator).reshape(b, num_queries)
  draws = dict(query_tracks=tracks, query_frames=frames)
  if color_augment:
    draws.update({f"color/{k}": v for k, v in
                  augmentations.color_draws(generator, b).items()})
  return draws


def prepare_batch(
    batch: Mapping[str, torch.Tensor],
    draws: Mapping[str, torch.Tensor],
    train_size: Tuple[int, int] = (256, 256),
    color_augment: bool = True,
) -> Batch:
  """On the batch's device: resize, normalize, take the drawn queries,
  colour-augment.

  batch: video uint8 [B, T, H, W, 3]; target_points [B, N, T, 2];
  occluded [B, N, T]. draws: `batch_draws`'s.

  Returns video [B, T, h, w, 3] in [-1, 1], query_points [B, Q, 3]
  (t, y, x), target_points [B, Q, T, 2] and occluded [B, Q, T] (float32) at
  the train resolution.
  """
  video = batch["video"].to(torch.float32) / 255.0 * 2.0 - 1.0
  b, t, h, w, _ = video.shape
  video = resize_video(video, tuple(train_size))
  target_points = transforms.convert_grid_coordinates(
      batch["target_points"].to(torch.float32), (w, h), tuple(train_size[::-1]))
  occluded = batch["occluded"].to(torch.float32)

  tracks = draws["query_tracks"].to(video.device)
  frames = draws["query_frames"].to(video.device)
  tp = torch.gather(target_points, 1,
                    tracks[..., None, None].expand(-1, -1, t, 2))
  occ = torch.gather(occluded, 1, tracks[..., None].expand(-1, -1, t))
  xy = torch.gather(tp, 2, frames[..., None, None].expand(-1, -1, 1, 2))[:, :, 0]
  query_points = torch.stack(
      [frames.to(torch.float32), xy[..., 1], xy[..., 0]], dim=-1)

  if color_augment:
    color = {k.split("/", 1)[1]: v for k, v in draws.items()
             if k.startswith("color/")}
    video = augmentations.color_augmentation(video, color)
  return dict(video=video, query_points=query_points, target_points=tp,
              occluded=occ)


class KubricNpzReader:
  """Double-buffered host reader over a directory of Kubric npz examples.

  `example_transform`, if given, maps one loaded example dict (video
  [T, H, W, 3], target_points [N, T, 2], occluded [N, T]) to another: the
  hook for per-example geometric augmentation (`geometric_augmentation`).
  `wait_s` is how long the last `next` waited for the worker thread.
  """

  def __init__(
      self,
      data_dir: str,
      batch_size: int,
      seed: int = 0,
      prefetch: int = 2,
      example_transform=None,
  ):
    self.paths = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if not self.paths:
      raise ValueError(f"No npz files in {data_dir}")
    self.batch_size = batch_size
    self.rng = np.random.RandomState(seed)
    self.example_transform = example_transform
    self.wait_s = 0.0
    self._queue: queue_lib.Queue = queue_lib.Queue(maxsize=prefetch)
    self._thread = threading.Thread(target=self._worker, daemon=True)
    self._thread.start()

  def _load(self, path: str) -> Mapping[str, np.ndarray]:
    with np.load(path) as z:
      example = {
          "video": z["video"],
          "target_points": z["target_points"],
          "occluded": z["occluded"],
      }
    if self.example_transform is not None:
      example = self.example_transform(example)
    return example

  def _worker(self):
    while True:
      try:
        idx = self.rng.randint(0, len(self.paths), self.batch_size)
        examples = [self._load(self.paths[i]) for i in idx]
        batch = {
            k: np.stack([e[k] for e in examples]) for k in examples[0]
        }
      except Exception as e:  # pylint: disable=broad-except
        self._queue.put(e)
        return
      self._queue.put(batch)

  def __iter__(self):
    return self

  def __next__(self) -> Mapping[str, np.ndarray]:
    start = time.perf_counter()
    batch = self._queue.get()
    self.wait_s = time.perf_counter() - start
    if isinstance(batch, Exception):
      raise RuntimeError("the Kubric reader's worker failed") from batch
    return batch


def geometric_augmentation(seed: int = 0, strength: float = 1.0,
                           device: Optional[Any] = None):
  """Per-example TAPNext++ roll + homography augmentation transform.

  Returns an `example_transform` for KubricNpzReader: it adapts between the
  Kubric layout (target_points [N, T, 2], uint8 video) and the
  augmentations' {"video", "tracks" [T, N, 2]} dict. The two
  augmentations' per-frame matrices are composed and the video is warped
  once, in uint8 (`augmentations.warp_video_u8`), on `device` (None: the
  CUDA card); trajectories are transformed with the same homographies.
  Occlusion flags are kept as they are (points warped outside the frame
  are handled by the loss's visibility weighting, as in the reference).
  """
  from tapnet_tpu_torch.inference import resolve_device

  device = resolve_device(device)
  roll = augmentations.RollAugmentation(seed=seed, strength=strength,
                                        device=device)
  homog = augmentations.HomographyAugmentation(
      seed=seed + 1, strength=strength, device=device)

  def transform(example):
    video = np.asarray(example["video"])
    t, h, w = video.shape[:3]
    # Keep the draw order (roll first) so RNG streams match the chained path.
    stacks = [
        m
        for m in (
            roll.sample_homographies(t, h, w),
            homog.sample_homographies(t, h, w),
        )
        if m is not None
    ]
    if not stacks:
      return dict(example)
    # Roll applies first, homography second: compose H_homog @ H_roll.
    composed = augmentations.compose_homographies(*reversed(stacks))
    if np.issubdtype(video.dtype, np.floating):
      video = np.clip(np.round(video), 0, 255).astype(np.uint8)
    warped = augmentations.warp_video_u8(
        torch.from_numpy(video).to(device),
        torch.as_tensor(composed, dtype=torch.float32)).cpu().numpy()
    tracks = np.transpose(
        np.asarray(example["target_points"], np.float32), (1, 0, 2)
    )
    new_tracks = augmentations.transform_points(composed, tracks)
    return dict(
        example,
        video=warped,
        target_points=np.transpose(new_tracks, (1, 0, 2)).astype(np.float32),
    )

  return transform


class TrainingIterator:
  """Host reads (`reader`, a KubricNpzReader) and device-side preparation
  (`prepare_batch` with draws from a generator on the device seeded by
  `seed`), ready for Trainer.fit."""

  def __init__(self, reader: KubricNpzReader, device: torch.device,
               train_size: Tuple[int, int], num_queries: int,
               color_augment: bool, seed: int):
    self.reader = reader
    self.device = device
    self.train_size = tuple(train_size)
    self.num_queries = num_queries
    self.color_augment = color_augment
    self.generator = torch.Generator(device=device).manual_seed(seed)

  def __iter__(self):
    return self

  def __next__(self) -> Batch:
    batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
             for k, v in next(self.reader).items()}
    draws = batch_draws(self.generator, batch["occluded"], self.num_queries,
                        self.color_augment)
    return prepare_batch(batch, draws, self.train_size, self.color_augment)


def training_iterator(
    data_dir: str,
    batch_size: int,
    train_size: Tuple[int, int] = (256, 256),
    num_queries: int = 256,
    color_augment: bool = True,
    geometric_augment: bool = False,
    seed: int = 0,
    device: Optional[Any] = None,
) -> TrainingIterator:
  """Batches of the npz examples under `data_dir` on `device` (None: the
  CUDA card; raises without one), as the JAX package's training_iterator
  makes them (its random draws are the port's own)."""
  from tapnet_tpu_torch.inference import resolve_device

  device = resolve_device(device)
  reader = KubricNpzReader(
      data_dir,
      batch_size,
      seed=seed,
      example_transform=(
          geometric_augmentation(seed=seed, device=device)
          if geometric_augment else None
      ),
  )
  return TrainingIterator(reader, device, train_size, num_queries,
                          color_augment, seed)

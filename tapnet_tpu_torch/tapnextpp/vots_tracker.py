"""TAPNext++ VOTS point tracker of the port (folder protocol + support
points; the counterpart of tapnet_tpu/tapnextpp/vots_tracker.py).

Behavioral parity: tapnet/tapnextpp/votsp2026/{tracker,model,utils}.py. Each
real query point is augmented with a local grid of support points (default 64
within a 32px model-space radius) that are co-tracked through shared
attention and discarded from the outputs. Frames are resized to a square
model resolution (default 512); display <-> model coordinate transforms are
exposed for callers. The tracker runs on the CUDA card unless given
`device="cpu"`.

The resize to the model resolution is `resize_linear_u8`: OpenCV's uint8
`INTER_LINEAR` (the JAX version's `cv2.resize`) computed in integers on the
frame's device, equal to it bit for bit, so the card's machine needs no
OpenCV.

The VOT folder protocol (frames_color.txt, query_*.txt -> output_*.txt and
output_*_visible.txt) is implemented without depending on the `vot` toolkit;
query files are expected to contain one "x,y" point per line or a VOT POINT
region string. It reads the frames with cv2 (imported lazily).
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from tapnet_tpu_torch import inference
from tapnet_tpu_torch.checkpoints import tapnext_checkpoint
from tapnet_tpu_torch.models import ssm_vit

INPUT_RESOLUTION = 512
N_SUPPORT = 64
SUPPORT_RADIUS = 32.0

# OpenCV's fixed-point bilinear resize of uint8 images (imgproc/resize.cpp):
# 11-bit interpolation coefficients, a horizontal pass into int32 row sums,
# and a vertical pass that drops 4 bits of each row sum, keeps the high 16
# bits of its product with the row's coefficient, and rounds the sum of the
# two by a 2-bit shift.
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


@functools.lru_cache(maxsize=16)
def _linear_taps(dst: int, src: int, clamp_coefficient: bool):
  """OpenCV's source taps and 11-bit coefficients of a linear resize from
  `src` to `dst` samples: (i0, i1, c0, c1) int32 numpy arrays [dst].

  Sample centres map as (d + 0.5) * src / dst - 0.5 in float32 arithmetic
  of OpenCV's (double product, float32 position). Columns clamp both the
  tap and its coefficient at the borders (`clamp_coefficient`); rows clamp
  only the taps, so a border row mixes one source row with itself under
  two separately truncated products, as OpenCV does.
  """
  scale = 1.0 / (np.float64(dst) / np.float64(src))
  pos = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
      np.float32)
  i0 = np.floor(pos).astype(np.int64)
  frac = (pos - i0.astype(np.float32)).astype(np.float32)
  if clamp_coefficient:
    low, high = i0 < 0, i0 >= src - 1
    frac[low | high] = 0.0
    i0[low] = 0
    i0[high] = src - 1
  c0 = np.rint((np.float32(1.0) - frac) * np.float32(_COEF_SCALE))
  c1 = np.rint(frac * np.float32(_COEF_SCALE))
  i1 = np.clip(i0 + 1, 0, src - 1)
  i0 = np.clip(i0, 0, src - 1)
  return tuple(a.astype(np.int32) for a in (i0, i1, c0, c1))


def resize_linear_u8(frames: torch.Tensor, height: int,
                     width: int) -> torch.Tensor:
  """OpenCV's `cv2.resize(frame, (width, height), INTER_LINEAR)` of uint8
  frames [..., H, W, C], bit for bit, in int32 arithmetic on the frames'
  device. An exact 2x downscale of both axes is OpenCV's INTER_AREA there
  (the mean of each 2x2 block, rounded half up), as OpenCV switches to it.
  """
  if frames.dtype != torch.uint8:
    raise ValueError(f"uint8 frames expected, got {frames.dtype}")
  src_h, src_w = frames.shape[-3], frames.shape[-2]
  x = frames.to(torch.int32)
  if (src_h, src_w) == (2 * height, 2 * width):
    block = (x[..., 0::2, 0::2, :] + x[..., 0::2, 1::2, :]
             + x[..., 1::2, 0::2, :] + x[..., 1::2, 1::2, :])
    return ((block + 2) >> 2).to(torch.uint8)

  def taps(dst, src, clamp):
    return [torch.from_numpy(a).to(frames.device)
            for a in _linear_taps(dst, src, clamp)]

  x0, x1, a0, a1 = taps(width, src_w, True)
  y0, y1, b0, b1 = taps(height, src_h, False)
  rows = (x.index_select(-2, x0) * a0[:, None]
          + x.index_select(-2, x1) * a1[:, None]) >> 4
  out = (((rows.index_select(-3, y0) * b0[:, None, None]) >> 16)
         + ((rows.index_select(-3, y1) * b1[:, None, None]) >> 16) + 2) >> 2
  return out.clamp(0, 255).to(torch.uint8)


def display_to_model(
    points_xy: np.ndarray, disp_h: int, disp_w: int, model_size: int
) -> np.ndarray:
  """[N, 2] (x, y) display pixels -> square model space."""
  scale = np.array(
      [model_size / disp_w, model_size / disp_h], np.float32
  )
  return points_xy.astype(np.float32) * scale


def model_to_display(
    points_xy: np.ndarray, disp_h: int, disp_w: int, model_size: int
) -> np.ndarray:
  scale = np.array(
      [disp_w / model_size, disp_h / model_size], np.float32
  )
  return points_xy.astype(np.float32) * scale


def grid_support_points(n: int, w: float, h: float) -> np.ndarray:
  """n points on an aspect-matched grid spanning [0, w) x [0, h)."""
  if n <= 0:
    return np.zeros((0, 2), np.float32)
  cols = max(1, round(float(np.sqrt(n * w / h))))
  rows = max(1, int(np.ceil(n / cols)))
  xs = (np.arange(cols) + 0.5) * (w / cols)
  ys = (np.arange(rows) + 0.5) * (h / rows)
  gx, gy = np.meshgrid(xs, ys)
  return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)[:n]


def local_support_points(
    query_xy: np.ndarray,
    n_per_query: int,
    radius: float,
    w: int,
    h: int,
) -> np.ndarray:
  """Support grid of n_per_query points around each query, clamped in-frame."""
  if n_per_query <= 0 or len(query_xy) == 0:
    return np.zeros((0, 2), np.float32)
  out = []
  base = grid_support_points(n_per_query, 2 * radius, 2 * radius) - radius
  for q in query_xy:
    pts = base + q[None]
    pts[:, 0] = np.clip(pts[:, 0], 0, w - 1)
    pts[:, 1] = np.clip(pts[:, 1], 0, h - 1)
    out.append(pts.copy())
  return np.concatenate(out, 0).astype(np.float32)


class VotsPointTracker:
  """Streams frames; tracks real queries + hidden support points.

  `visible_logits` holds the real queries' visibility logits [Q] of the
  last `initialize` or `track` (the flags are the logits > 0).
  """

  def __init__(
      self,
      params,
      config: Optional[ssm_vit.SsmVitConfig] = None,
      input_resolution: int = INPUT_RESOLUTION,
      n_support: int = N_SUPPORT,
      support_radius: float = SUPPORT_RADIUS,
      device: Optional[Any] = None,
  ):
    """Args:
      params: Flax-layout TAPNext parameter tree with numpy leaves.
      config: the configuration the weights were trained at (default
        ViT-B at 256x256, as TAPNext++ is released). Off the input
        resolution, the learned posembs are bicubically adapted once here,
        as the reference runs TAPNext++ at 512 from a 256-trained model.
      input_resolution: the square model resolution frames are resized to.
      n_support, support_radius: support points per real query and their
        model-space radius.
      device: torch device; None means "cuda" (raises without a card).
    """
    config = config or ssm_vit.SsmVitConfig()
    if config.image_size != (input_resolution, input_resolution):
      new_config = dataclasses.replace(
          config, image_size=(input_resolution, input_resolution)
      )
      params = tapnext_checkpoint.adapt_posembs(params, config, new_config)
      config = new_config
    self.predictor = inference.OnlineTapnextPredictor(params, config,
                                                      device=device)
    self.device = self.predictor.device
    self.input_resolution = input_resolution
    self.n_support = n_support
    self.support_radius = support_radius
    self.num_real = 0
    self.visible_logits = None
    self._shape = None

  def initialize(self, frame_rgb: np.ndarray, query_points_xy: np.ndarray):
    """frame_rgb: [H, W, 3] uint8; query_points_xy: [Q, 2] display (x, y).
    Returns ([Q, 2] display (x, y), [Q] bool visible) on this frame."""
    h, w = frame_rgb.shape[:2]
    self._shape = (h, w)
    r = self.input_resolution
    model_q = display_to_model(np.asarray(query_points_xy), h, w, r)
    support = local_support_points(
        model_q, self.n_support, self.support_radius, r, r
    )
    all_xy = np.concatenate([model_q, support], axis=0)
    self.num_real = len(model_q)
    queries_tyx = np.concatenate(
        [np.zeros((len(all_xy), 1), np.float32), all_xy[:, ::-1]], axis=-1
    )
    frame = self._preprocess(frame_rgb)
    tracks, vis = self.predictor.init(frame[None, None], queries_tyx[None])
    return self._postprocess(tracks[:, :, 0], vis[:, :, 0, 0])

  def track(self, frame_rgb: np.ndarray):
    """Returns ([Q, 2] display (x, y), [Q] bool visible) for real queries."""
    frame = self._preprocess(frame_rgb)
    tracks_yx, logits = self.predictor.step(frame[None])
    return self._postprocess(tracks_yx, logits)

  def _preprocess(self, frame_rgb: np.ndarray) -> torch.Tensor:
    """[H, W, 3] uint8 -> [r, r, 3] float32 in [-1, 1] on the device."""
    r = self.input_resolution
    frame = torch.from_numpy(np.ascontiguousarray(frame_rgb)).to(self.device)
    resized = resize_linear_u8(frame, r, r)
    return resized.float() / 255.0 * 2.0 - 1.0

  def _postprocess(self, tracks_yx: np.ndarray,
                   logits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    h, w = self._shape
    real_yx = np.asarray(tracks_yx)[0, : self.num_real]
    self.visible_logits = np.asarray(logits)[0, : self.num_real]
    xy = model_to_display(
        real_yx[:, ::-1], h, w, self.input_resolution
    )
    return xy, self.visible_logits > 0


def _parse_query_file(path: str) -> np.ndarray:
  """Reads 'x,y' lines or VOT POINT region strings."""
  pts = []
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line:
        continue
      if line.lower().startswith("point"):
        line = line.split("point", 1)[-1].strip(" :")
      vals = [float(v) for v in line.replace(";", ",").split(",") if v]
      pts.append(vals[:2])
  return np.asarray(pts, np.float32)


def run_folder_protocol(params, config=None, workdir: str = ".",
                        device: Optional[Any] = None):
  """VOT folder protocol: track every query_*.txt over frames_color.txt
  with a `VotsPointTracker` at its defaults."""
  import cv2

  with open(os.path.join(workdir, "frames_color.txt")) as f:
    frame_paths = [
        os.path.join(workdir, line.strip()) for line in f if line.strip()
    ]
  query_files = sorted(glob.glob(os.path.join(workdir, "query_*.txt")))

  for qf in query_files:
    tag = os.path.basename(qf)[len("query_"):-len(".txt")]
    queries = _parse_query_file(qf)
    tracker = VotsPointTracker(params, config, device=device)

    first = cv2.imread(frame_paths[0])[..., ::-1]
    xy, vis = tracker.initialize(first, queries)
    all_xy, all_vis = [xy], [vis]
    for p in frame_paths[1:]:
      frame = cv2.imread(p)[..., ::-1]
      xy, vis = tracker.track(frame)
      all_xy.append(xy)
      all_vis.append(vis)

    out_xy = np.stack(all_xy)  # [T, Q, 2]
    out_vis = np.stack(all_vis)  # [T, Q]
    with open(os.path.join(workdir, f"output_{tag}.txt"), "w") as f:
      for t in range(out_xy.shape[0]):
        f.write(
            ";".join(f"{x:.2f},{y:.2f}" for x, y in out_xy[t]) + "\n"
        )
    with open(
        os.path.join(workdir, f"output_{tag}_visible.txt"), "w"
    ) as f:
      for t in range(out_vis.shape[0]):
        f.write(";".join(str(int(v)) for v in out_vis[t]) + "\n")

"""Training augmentations on the device (port of
tapnet_tpu/data/augmentations.py).

`color_augmentation` is the JAX package's photometric jitter (the reference
TF brightness / saturation / contrast / hue, each applied with probability
0.8, and grayscale with probability 0.2), one transform per video on a
[-1, 1] video. Its random numbers are drawn apart, by `color_draws`, so that
a caller (or a test holding the port to JAX's draws) can give its own.

The TAPNext++ geometric augmentations (`RollAugmentation`,
`HomographyAugmentation`: sinusoidal camera shift, in-plane rotation and
perspective jitter) draw their schedules on the host with
`np.random.RandomState`, as the JAX package does, so one seed gives the same
matrices in both; frames are warped on a torch device by inverse bilinear
sampling (`warp_video`, `warp_video_u8`) and trajectories transformed with
the same matrices.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from tapnet_tpu_torch.utils import sampling

Draws = Dict[str, torch.Tensor]

# The reference's jitter (tapnet/utils/experiment_utils.py:183-250).
PROB_COLOR_AUGMENT, PROB_COLOR_DROP = 0.8, 0.2
BRIGHTNESS_MAX_DELTA, HUE_MAX_DELTA = 32.0 / 255.0, 0.2
SATURATION_RANGE = CONTRAST_RANGE = (0.6, 1.4)


def _rgb_to_grayscale(video: torch.Tensor) -> torch.Tensor:
  lum = (0.2989 * video[..., 0] + 0.587 * video[..., 1]
         + 0.114 * video[..., 2])
  return torch.stack([lum] * 3, dim=-1)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
  r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
  maxc = rgb.amax(-1)
  minc = rgb.amin(-1)
  v = maxc
  delta = maxc - minc
  zero = torch.zeros((), dtype=rgb.dtype, device=rgb.device)
  s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
  safe_delta = torch.clamp(delta, min=1e-12)
  rc = (maxc - r) / safe_delta
  gc = (maxc - g) / safe_delta
  bc = (maxc - b) / safe_delta
  h = torch.where(maxc == r, bc - gc,
                  torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
  h = torch.remainder(h / 6.0, 1.0)
  h = torch.where(delta == 0, zero, h)
  return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
  h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
  i = torch.floor(h * 6.0)
  f = h * 6.0 - i
  p = v * (1 - s)
  q = v * (1 - f * s)
  t = v * (1 - (1 - f) * s)
  i = torch.remainder(i.to(torch.int32), 6).long()
  choices = torch.stack([
      torch.stack([v, t, p], -1),
      torch.stack([q, v, p], -1),
      torch.stack([p, v, t], -1),
      torch.stack([p, q, v], -1),
      torch.stack([t, p, v], -1),
      torch.stack([v, p, q], -1),
  ], dim=0)
  index = i[None, ..., None].expand((1,) + tuple(i.shape) + (3,))
  return torch.gather(choices, 0, index)[0]


def color_draws(generator: torch.Generator, batch: int) -> Draws:
  """One video's colour transform per example, [batch] each: the
  brightness delta, saturation and contrast factors, hue shift, and the
  uniforms that decide whether to augment and whether to drop colour."""
  u = torch.rand((6, batch), generator=generator,
                 device=generator.device)
  span = lambda x, lo, hi: lo + x * (hi - lo)
  return dict(
      brightness=span(u[0], -BRIGHTNESS_MAX_DELTA, BRIGHTNESS_MAX_DELTA),
      saturation=span(u[1], *SATURATION_RANGE),
      hue=span(u[2], -HUE_MAX_DELTA, HUE_MAX_DELTA),
      contrast=span(u[3], *CONTRAST_RANGE),
      augment=u[4], drop=u[5])


def color_augmentation(video: torch.Tensor, draws: Draws) -> torch.Tensor:
  """Photometric jitter on a [-1, 1] video [B, T, H, W, 3], the same for
  every frame of a video, with the per-example `draws` (`color_draws`)."""
  shape = (-1,) + (1,) * (video.ndim - 1)
  d = {k: v.to(device=video.device, dtype=video.dtype).reshape(shape)
       for k, v in draws.items()}
  x = video * 0.5 + 0.5

  def augment(x):
    x = torch.clamp(x + d["brightness"], 0.0, 1.0)
    hsv = _rgb_to_hsv(x)
    hsv = torch.stack([
        torch.remainder(hsv[..., 0] + d["hue"][..., 0], 1.0),
        torch.clamp(hsv[..., 1] * d["saturation"][..., 0], 0.0, 1.0),
        hsv[..., 2],
    ], dim=-1)
    x = torch.clamp(_hsv_to_rgb(hsv), 0.0, 1.0)
    mean = x.mean(dim=(-2, -3), keepdim=True)
    return torch.clamp((x - mean) * d["contrast"] + mean, 0.0, 1.0)

  x = torch.where(d["augment"] < PROB_COLOR_AUGMENT, augment(x), x)
  x = torch.where(d["drop"] < PROB_COLOR_DROP, _rgb_to_grayscale(x), x)
  return x * 2.0 - 1.0



# ------------------------------------------------------- geometric (TAPNext++)


def sinusoid_schedule(
    rng: np.random.RandomState,
    num_frames: int,
    n_low: int,
    n_high: int,
    low_amp: float,
    high_amp: float,
    strength: float = 1.0,
) -> np.ndarray:
  """Sum of random low/high-frequency sinusoids, zeroed at t=0. [T]."""
  t = np.arange(num_frames) / num_frames if num_frames > 1 else np.zeros(1)
  out = np.zeros(num_frames)
  for n, amp_max, freq_range in (
      (n_low, low_amp, (1, 4)),
      (n_high, high_amp, (8, 16)),
  ):
    amps = rng.uniform(0, amp_max, n) * strength
    freqs = rng.uniform(*freq_range, n) * np.pi
    phases = rng.uniform(0, 2 * np.pi, n)
    for a, f, p in zip(amps, freqs, phases):
      out += a * (np.sin(t * f + p) - np.sin(p))
  return out


def warp_video(video: torch.Tensor, homogs: torch.Tensor) -> torch.Tensor:
  """Inverse-warps each frame by its homography (bilinear, on the video's
  device).

  Args:
    video: [T, H, W, C] float.
    homogs: [T, 3, 3] mapping source pixel centers -> destination pixels
      (inverted in float32, as the JAX version does).

  Returns:
    warped [T, H, W, C] with zero padding outside.
  """
  t, h, w, c = video.shape
  dev = video.device
  gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev),
                          indexing="ij")
  dest = torch.stack([gx.reshape(-1), gy.reshape(-1),
                      torch.ones(h * w, device=dev)], dim=-1)
  inv = torch.linalg.inv(homogs.to(device=dev, dtype=torch.float32))
  src = dest @ inv.transpose(1, 2)  # [T, H*W, 3], dest -> source
  z = src[..., 2:]
  src = src[..., :2] / torch.where(torch.abs(z) < 1e-12,
                                   torch.full_like(z, 1e-12), z)
  # Pixel-index coords to raster (+0.5) for the sampler.
  pts_yx = torch.stack([src[..., 1] + 0.5, src[..., 0] + 0.5], dim=-1)
  vals = sampling.sample_grid_batched(video, pts_yx, mode="constant")
  return vals.reshape(t, h, w, c)


def warp_video_u8(video_u8: torch.Tensor, homogs: torch.Tensor) -> torch.Tensor:
  """`warp_video` with uint8 in and out, the float conversion on the
  device: one composed warp in place of chained ones, and a quarter of
  float32's bytes each way between host and card."""
  warped = warp_video(video_u8.to(torch.float32), homogs)
  return torch.clamp(torch.round(warped), 0.0, 255.0).to(torch.uint8)


def compose_homographies(*stacks: np.ndarray) -> np.ndarray:
  """Compose per-frame homography stacks; stacks[0] is applied LAST.

  `warp_video` + `transform_points` apply x_new = H @ x_old, so applying
  R then M equals one application of (M @ R):
  compose_homographies(M, R) == M @ R per frame.
  """
  out = stacks[0]
  for nxt in stacks[1:]:
    out = np.einsum("tij,tjk->tik", out, nxt)
  return out


def transform_points(homogs: np.ndarray, points_xy: np.ndarray) -> np.ndarray:
  """Apply per-frame homographies to [T, N, 2] (x, y) points."""
  pts_h = np.concatenate(
      [points_xy, np.ones_like(points_xy[..., :1])], axis=-1
  )
  out = np.einsum("tij,tnj->tni", homogs, pts_h)
  return out[..., :2] / np.where(
      np.abs(out[..., 2:]) < 1e-12, 1e-12, out[..., 2:]
  )


def _reflect(val, lo, hi):
  while val < lo or val > hi:
    if val < lo:
      val = lo + (lo - val)
    if val > hi:
      val = hi - (val - hi)
  return val


def estimate_homography(targ_pts, src_pts) -> np.ndarray:
  """DLT homography from four or more point correspondences (least squares
  through the SVD of the 2N x 9 constraint matrix), in float64."""
  targ_pts = np.asarray(targ_pts, np.float64)
  src_pts = np.asarray(src_pts, np.float64)
  tx, ty = targ_pts[..., 0], targ_pts[..., 1]
  sx, sy = src_pts[..., 0], src_pts[..., 1]
  one = np.ones_like(tx)
  zero = np.zeros_like(tx)
  row_x = np.stack(
      [sx, sy, one, zero, zero, zero, -tx * sx, -tx * sy, -tx], axis=-1
  )
  row_y = np.stack(
      [zero, zero, zero, sx, sy, one, -ty * sx, -ty * sy, -ty], axis=-1
  )
  a = np.concatenate([row_x, row_y], axis=-2)
  _, _, vt = np.linalg.svd(a, full_matrices=a.shape[-2] <= 8)
  return vt[..., -1, :].reshape(a.shape[:-2] + (3, 3))


class RollAugmentation:
  """Sinusoidal camera shift + in-plane rotation over time.

  data dict: {"video" [T, H, W, C] (any float range), "tracks" [T, N, 2]
  (x, y) raster}. The rotation is applied as a per-frame affine homography,
  warped on `device` (None: the CUDA card).
  """

  def __init__(self, rotate: bool = True, p: float = 0.8,
               strength: float = 1.0, seed: Optional[int] = None,
               device: Optional[Any] = None):
    self.rotate = rotate
    self.p = p
    self.strength = strength
    self.rng = np.random.RandomState(seed)
    self.device = device

  def sample_homographies(
      self, t: int, h: int, w: int
  ) -> Optional[np.ndarray]:
    """Draw this augmentation's per-frame matrices, or None when skipped."""
    if self.rng.rand() > self.p:
      return None
    shift_x = sinusoid_schedule(self.rng, t, 5, 5, 30.0, 10.0, self.strength)
    shift_y = sinusoid_schedule(self.rng, t, 5, 5, 20.0, 7.0, self.strength)
    angle = (
        sinusoid_schedule(self.rng, t, 5, 5, 10.0, 5.0, self.strength)
        if self.rotate
        else np.zeros(t)
    )

    # Per-frame affine homographies: rotate about center, then shift.
    homogs = np.zeros((t, 3, 3))
    cx, cy = w / 2.0, h / 2.0
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    for i in range(t):
      rot = np.array(
          [
              [cos[i], sin[i], (1 - cos[i]) * cx - sin[i] * cy],
              [-sin[i], cos[i], sin[i] * cx + (1 - cos[i]) * cy],
              [0, 0, 1],
          ]
      )
      shift = np.array(
          [[1, 0, shift_x[i]], [0, 1, shift_y[i]], [0, 0, 1]]
      )
      homogs[i] = rot @ shift
    return homogs

  def __call__(self, data: Mapping[str, np.ndarray]):
    video = np.asarray(data["video"])
    t, h, w = video.shape[:3]
    homogs = self.sample_homographies(t, h, w)
    if homogs is None:
      return dict(data)
    return _apply_homographies(data, homogs, self.device)


class HomographyAugmentation:
  """Sinusoidal perspective jitter: the four frame corners wander smoothly
  within 30% margins; frames are warped by the induced homographies, on
  `device` (None: the CUDA card)."""

  def __init__(self, p: float = 0.8, strength: float = 1.0,
               seed: Optional[int] = None, device: Optional[Any] = None):
    self.p = p
    self.strength = strength
    self.rng = np.random.RandomState(seed)
    self.device = device

  def sample_homographies(
      self, t: int, h: int, w: int
  ) -> Optional[np.ndarray]:
    """Draw this augmentation's per-frame matrices, or None when skipped."""
    if self.rng.rand() > self.p:
      return None

    # 8 schedules: (x, y) for each of 4 corners.
    perts = np.stack(
        [
            sinusoid_schedule(self.rng, t, 3, 3, 0.05, 0.02, self.strength)
            for _ in range(8)
        ],
        axis=1,
    )  # [T, 8]
    signs = np.array([1, 1, -1, 1, -1, -1, 1, -1])
    scale = np.array([w, h, w, h, w, h, w, h])
    perts = np.abs(perts) * signs * scale

    src = np.array(
        [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float64
    )
    homogs = np.zeros((t, 3, 3))
    wm, hm = w * 0.3, h * 0.3
    bounds = [
        (0, wm), (0, hm),
        (w - 1 - wm, w - 1), (0, hm),
        (w - 1 - wm, w - 1), (h - 1 - hm, h - 1),
        (0, wm), (h - 1 - hm, h - 1),
    ]
    for i in range(t):
      dst = src.reshape(-1) + perts[i]
      dst = np.array(
          [_reflect(v, lo, hi) for v, (lo, hi) in zip(dst, bounds)]
      ).reshape(4, 2)
      homogs[i] = estimate_homography(dst, src)
      homogs[i] /= homogs[i][2, 2]
    return homogs

  def __call__(self, data: Mapping[str, np.ndarray]):
    video = np.asarray(data["video"])
    t, h, w = video.shape[:3]
    homogs = self.sample_homographies(t, h, w)
    if homogs is None:
      return dict(data)
    return _apply_homographies(data, homogs, self.device)


def _apply_homographies(data: Mapping[str, np.ndarray], homogs: np.ndarray,
                        device: Optional[Any] = None):
  """Warp data["video"] (on `device`) and transform data["tracks"] by
  per-frame matrices."""
  from tapnet_tpu_torch.inference import resolve_device

  device = resolve_device(device)
  video = np.asarray(data["video"])
  tracks = np.asarray(data["tracks"])
  warped = warp_video(torch.as_tensor(video, dtype=torch.float32).to(device),
                      torch.as_tensor(homogs, dtype=torch.float32))
  new_tracks = transform_points(homogs, tracks)
  return dict(data, video=warped.cpu().numpy(),
              tracks=new_tracks.astype(tracks.dtype))

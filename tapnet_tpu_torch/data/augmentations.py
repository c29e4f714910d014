"""Training augmentations on the device (port of
tapnet_tpu/data/augmentations.py: the colour augmentation; the warps and
homographies come with the Kubric training reader).

`color_augmentation` is the JAX package's photometric jitter (the reference
TF brightness / saturation / contrast / hue, each applied with probability
0.8, and grayscale with probability 0.2), one transform per video on a
[-1, 1] video. Its random numbers are drawn apart, by `color_draws`, so that
a caller (or a test holding the port to JAX's draws) can give its own.
"""

from __future__ import annotations

from typing import Dict

import torch

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


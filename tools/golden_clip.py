"""The golden clips and int8 configurations of the PyTorch port's checks.

numpy only: tools/make_torch_golden.py writes the JAX package's outputs on
these clips, and the port's tests and chip_smoke.py rebuild the clips and
read the configurations from here.

The clip: textured sprites moving in straight lines over a smooth textured
background, uint8 1 x T x 256 x 256 x 3, and 32 query points, made with
numpy from a seed.
"""

from __future__ import annotations

import numpy as np

# The int8 configurations, as overrides of `bootstapir_config()`: "a" is the
# w8a8 mixer with the per-frame int8 correlation (grids quantized once per
# video), "b" the per-position int8 correlation, "c" the JAX package's
# headline configuration (bench.py: "a" with the per-frame int8 ExtraConvs and
# 2 refinement steps), "d" the per-pixel int8 ExtraConvs.
INT8_CONFIGS = {
    "a": dict(quantized_mixer=True, quantized_corr="per_frame"),
    "b": dict(quantized_corr=True),
    "c": dict(quantized_mixer=True, quantized_extra_convs=True,
              quantized_corr="per_frame", num_pips_iter=2),
    "d": dict(quantized_extra_convs="per_pixel"),
}
# Frames of each configuration's clip. "d" needs a low-resolution grid of at
# least 4 * 1024 * 1024 elements, or the JAX package runs the per-frame
# scheme in its place (fused_extra_convs.wants_fused): 16 frames at 256^2
# give exactly that, 24 stay clear of the boundary.
CLIP_FRAMES = {"a": 8, "b": 8, "c": 8, "d": 24}
SEED = 20261016
T, H, W, N = 8, 256, 256, 32


def _smooth_texture(rng, h, w, cells):
  """[h, w, 3] uint8 texture: bilinear upsampling of a coarse random grid."""
  coarse = rng.rand(cells + 1, cells + 1, 3)
  ys = np.linspace(0, cells, h)
  xs = np.linspace(0, cells, w)
  y0 = np.minimum(ys.astype(int), cells - 1)
  x0 = np.minimum(xs.astype(int), cells - 1)
  fy = (ys - y0)[:, None, None]
  fx = (xs - x0)[None, :, None]
  top = coarse[y0][:, x0] * (1 - fx) + coarse[y0][:, x0 + 1] * fx
  bot = coarse[y0 + 1][:, x0] * (1 - fx) + coarse[y0 + 1][:, x0 + 1] * fx
  return ((top * (1 - fy) + bot * fy) * 255).astype(np.uint8)


def make_clip(seed: int = SEED, num_frames: int = T):
  """Returns (video uint8 [1, num_frames, H, W, 3], query_points float32
  [1, N, 3]). The default is the 8-frame clip of the float golden file."""
  rng = np.random.RandomState(seed)
  background = _smooth_texture(rng, H, W, 12)
  sprites = []
  for _ in range(5):
    size = rng.randint(40, 72)
    sprites.append(dict(
        tex=_smooth_texture(rng, size, size, 4),
        pos=rng.rand(2) * (np.array([H, W]) - size),
        vel=(rng.rand(2) - 0.5) * 12.0,
    ))
  frames = np.empty((num_frames, H, W, 3), np.uint8)
  owner = np.full((num_frames, H, W), -1, np.int32)  # top sprite per pixel
  for t in range(num_frames):
    frame = background.copy()
    for k, s in enumerate(sprites):
      size = s["tex"].shape[0]
      y, x = np.round(s["pos"] + s["vel"] * t).astype(int)
      y0, x0 = max(y, 0), max(x, 0)
      y1, x1 = min(y + size, H), min(x + size, W)
      if y1 > y0 and x1 > x0:
        frame[y0:y1, x0:x1] = s["tex"][y0 - y : y1 - y, x0 - x : x1 - x]
        owner[t, y0:y1, x0:x1] = k
    frames[t] = frame

  # Half the queries on sprites (at a random frame), half on the background.
  queries = []
  while len(queries) < N:
    t = rng.randint(num_frames)
    y, x = rng.rand(2) * (np.array([H, W]) - 16) + 8
    on_sprite = owner[t, int(y), int(x)] >= 0
    if on_sprite == (len(queries) % 2 == 0):
      queries.append((t, y, x))
  return frames[None], np.asarray(queries, np.float32)[None]

"""Writes golden BootsTAPIR outputs of the JAX package for the PyTorch port.

Runs `tapnet_tpu.inference.TapirPredictor` on the CPU in float32, with the
committed trained checkpoint (runs/bootstapir_synth/trained_params_f16.npy)
and `bootstapir_config()`, on a small deterministic clip: textured sprites
moving in straight lines over a smooth textured background, uint8
1 x 8 x 256 x 256 x 3, made with numpy from a seed. Writes the clip, 32 query
points and JAX's tracks, occlusion and expected_dist logits to
tests/data/bootstapir_golden.npz, which tests/test_torch_golden.py and
chip_smoke.py read.

The int8 inference modes have a file of their own,
tests/data/bootstapir_golden_int8.npz: the same clip and queries through the
same predictor with the two int8 configurations of `INT8_CONFIGS` (off the
TPU the JAX package runs the einsum mirrors of its int8 kernels). It holds
`<name>_tracks`, `<name>_occlusion` and `<name>_expected_dist` per
configuration; the clip and the queries are read from the first file.

  JAX_PLATFORMS=cpu python tools/make_torch_golden.py          # both files
  JAX_PLATFORMS=cpu python tools/make_torch_golden.py int8     # one of them
  JAX_PLATFORMS=cpu python tools/make_torch_golden.py float
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "runs/bootstapir_synth/trained_params_f16.npy")
OUT = os.path.join(REPO, "tests/data/bootstapir_golden.npz")
OUT_INT8 = os.path.join(REPO, "tests/data/bootstapir_golden_int8.npz")
# The int8 configurations, as overrides of `bootstapir_config()`: "a" is the
# w8a8 mixer with the per-frame int8 correlation (grids quantized once per
# video), "b" the per-position int8 correlation.
INT8_CONFIGS = {
    "a": dict(quantized_mixer=True, quantized_corr="per_frame"),
    "b": dict(quantized_corr=True),
}
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


def make_clip(seed: int = SEED):
  """Returns (video uint8 [1, T, H, W, 3], query_points float32 [1, N, 3])."""
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
  frames = np.empty((T, H, W, 3), np.uint8)
  owner = np.full((T, H, W), -1, np.int32)  # top sprite per pixel
  for t in range(T):
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
    t = rng.randint(T)
    y, x = rng.rand(2) * (np.array([H, W]) - 16) + 8
    on_sprite = owner[t, int(y), int(x)] >= 0
    if on_sprite == (len(queries) % 2 == 0):
      queries.append((t, y, x))
  return frames[None], np.asarray(queries, np.float32)[None]


def main(which=("float", "int8")):
  sys.path.insert(0, REPO)
  import jax

  jax.config.update("jax_platforms", "cpu")
  import jax.numpy as jnp

  from tapnet_tpu import inference
  from tapnet_tpu.checkpoints import tapir_checkpoint
  from tapnet_tpu.models import tapir
  from tapnet_tpu.utils import sampling

  video, query_points = make_clip()
  params = tapir_checkpoint.load_tapir_checkpoint(CHECKPOINT)
  frames = np.asarray(sampling.preprocess_frames(jnp.asarray(video)))

  def run(**overrides):
    predictor = inference.TapirPredictor(
        params, tapir.bootstapir_config(**overrides)
    )
    out = predictor(frames, query_points)
    return {k: out[k] for k in ("tracks", "occlusion", "expected_dist")}

  os.makedirs(os.path.dirname(OUT), exist_ok=True)
  if "float" in which:
    np.savez_compressed(
        OUT, video=video, query_points=query_points, **run()
    )
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 2**20:.2f} MiB)")
  if "int8" in which:
    arrays = {}
    for name, overrides in INT8_CONFIGS.items():
      for key, value in run(**overrides).items():
        arrays[f"{name}_{key}"] = value
    np.savez_compressed(OUT_INT8, **arrays)
    print(f"wrote {OUT_INT8} ({os.path.getsize(OUT_INT8) / 2**20:.2f} MiB)")


if __name__ == "__main__":
  main(tuple(sys.argv[1:]) or ("float", "int8"))

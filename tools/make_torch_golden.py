"""Writes golden BootsTAPIR outputs of the JAX package for the PyTorch port.

Runs `tapnet_tpu.inference.TapirPredictor` on the CPU in float32, with the
committed trained checkpoint (runs/bootstapir_synth/trained_params_f16.npy)
and `bootstapir_config()`, on the 8-frame clip of tools/golden_clip.py
(uint8 1 x 8 x 256 x 256 x 3, made with numpy from a seed). Writes the clip,
32 query points and JAX's tracks, occlusion and expected_dist logits to
tests/data/bootstapir_golden.npz, which tests/test_torch_golden.py and
chip_smoke.py read.

The int8 inference modes have a file of their own,
tests/data/bootstapir_golden_int8.npz: the configurations of `INT8_CONFIGS`
through the same predictor (off the TPU the JAX package runs the einsum
mirrors of its int8 kernels and XLA's int8 convolution). It holds
`<name>_tracks`, `<name>_occlusion` and `<name>_expected_dist` per
configuration. Each configuration names its clip in `CLIP_FRAMES`: the
8-frame clip of the first file (whose video and queries are read from
there), or a longer clip from the same generator and seed, which is not
stored: `golden_clip.make_clip(num_frames=...)` rebuilds it.

  JAX_PLATFORMS=cpu python tools/make_torch_golden.py            # both files
  JAX_PLATFORMS=cpu python tools/make_torch_golden.py float
  JAX_PLATFORMS=cpu python tools/make_torch_golden.py int8       # all of INT8_CONFIGS
  JAX_PLATFORMS=cpu python tools/make_torch_golden.py int8 c d   # these, kept beside the rest
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "runs/bootstapir_synth/trained_params_f16.npy")
OUT = os.path.join(REPO, "tests/data/bootstapir_golden.npz")
OUT_INT8 = os.path.join(REPO, "tests/data/bootstapir_golden_int8.npz")

sys.path.insert(0, REPO)
from tools.golden_clip import CLIP_FRAMES, INT8_CONFIGS, T, make_clip  # noqa: E402


def main(which=("float", "int8"), names=None):
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

  def run(clip=(frames, query_points), **overrides):
    predictor = inference.TapirPredictor(
        params, tapir.bootstapir_config(**overrides)
    )
    out = predictor(*clip)
    return {k: out[k] for k in ("tracks", "occlusion", "expected_dist")}

  def clip_of(name):
    if CLIP_FRAMES[name] == T:
      return frames, query_points
    long_video, long_queries = make_clip(num_frames=CLIP_FRAMES[name])
    return (np.asarray(sampling.preprocess_frames(jnp.asarray(long_video))),
            long_queries)

  os.makedirs(os.path.dirname(OUT), exist_ok=True)
  if "float" in which:
    np.savez_compressed(
        OUT, video=video, query_points=query_points, **run()
    )
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 2**20:.2f} MiB)")
  if "int8" in which:
    names = names or sorted(INT8_CONFIGS)
    arrays = {}
    if os.path.exists(OUT_INT8):
      arrays = {k: v for k, v in np.load(OUT_INT8).items()
                if k.split("_")[0] in INT8_CONFIGS
                and k.split("_")[0] not in names}
    for name in names:
      for key, value in run(clip_of(name), **INT8_CONFIGS[name]).items():
        arrays[f"{name}_{key}"] = value
      print(f"ran configuration {name}", flush=True)
    np.savez_compressed(OUT_INT8, **arrays)
    print(f"wrote {OUT_INT8} ({os.path.getsize(OUT_INT8) / 2**20:.2f} MiB)")


if __name__ == "__main__":
  args = sys.argv[1:]
  main(tuple(args[:1]) or ("float", "int8"), args[1:] or None)

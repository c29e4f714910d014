"""Writes golden TAPNext outputs of the JAX package for the PyTorch port.

Runs the JAX package's ViT-B TAPNext (`SsmVitConfig()`, 256x256) on the CPU
with the seed-made weights of tools/tapnext_weights.py (seed 0), on the first
4 frames of the clip of tools/golden_clip.py with its first 16 query points,
in float32 and in bfloat16 compute dtype:

  * `TAPNextTracker.__call__`: `<dtype>_call_tracks` [1, 16, 4, 2] (y, x),
    `_track_logits` [1, 16, 4, 512], `_visible_logits` [1, 16, 4, 1], and
    the per-layer `_inter_tracks` / `_inter_visible_logits` [12, ...];
  * `TapnextPredictor(chunk_size=2)`: `<dtype>_pred_tracks` [1, 16, 4, 2]
    (x, y) and `_pred_occlusion` [1, 16, 4].

Only outputs are stored (tests/data/tapnext_golden.npz): the clip and the
weights are rebuilt from their seeds. tests/test_torch_tapnext.py and
chip_smoke.py read the file.

  JAX_PLATFORMS=cpu python tools/make_tapnext_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests/data/tapnext_golden.npz")
WEIGHT_SEED = 0
FRAMES, QUERIES, CHUNK = 4, 16, 2

sys.path.insert(0, REPO)
from tools.golden_clip import make_clip  # noqa: E402
from tools.tapnext_weights import seeded_tapnext_params  # noqa: E402


def golden_clip():
  """(video float32 [1, 4, 256, 256, 3] in [-1, 1], query_points float32
  [1, 16, 3] (t, y, x))."""
  video, query_points = make_clip(num_frames=FRAMES)
  frames = video.astype(np.float32) / 255.0 * 2.0 - 1.0
  return frames, query_points[:, :QUERIES]


def main():
  import jax

  jax.config.update("jax_platforms", "cpu")
  import jax.numpy as jnp

  from tapnet_tpu import inference
  from tapnet_tpu.models import ssm_vit, tapnext

  video, query_points = golden_clip()
  out = {}
  for name in ("float32", "bfloat16"):
    config = ssm_vit.SsmVitConfig(compute_dtype=name)
    params = seeded_tapnext_params(config, WEIGHT_SEED)
    model = tapnext.TAPNextTracker(config=config)
    res = jax.jit(lambda p, v, q: model.apply({"params": p}, v, q))(
        params, jnp.asarray(video), jnp.asarray(query_points))
    out[f"{name}_call_tracks"] = np.asarray(res.tracks)
    out[f"{name}_call_track_logits"] = np.asarray(res.track_logits)
    out[f"{name}_call_visible_logits"] = np.asarray(res.visible_logits)
    out[f"{name}_call_inter_tracks"] = np.stack(
        [np.asarray(t) for t in res.intermediate_tracks])
    out[f"{name}_call_inter_visible_logits"] = np.stack(
        [np.asarray(t) for t in res.intermediate_visible_logits])
    predictor = inference.TapnextPredictor(params, config, chunk_size=CHUNK)
    pred = predictor(video, query_points)
    out[f"{name}_pred_tracks"] = np.asarray(pred["tracks"], np.float32)
    out[f"{name}_pred_occlusion"] = np.asarray(pred["occlusion"], np.float32)
    print(name, {k: v.shape for k, v in out.items() if k.startswith(name)},
          flush=True)
  np.savez(OUT, **out)
  print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
  main()

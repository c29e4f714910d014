"""Writes golden online BootsTAPIR outputs of the JAX package for the port.

Runs `tapnet_tpu.inference.OnlineTapirPredictor` on the CPU with the
committed trained checkpoint (runs/bootstapir_synth/trained_params_f16.npy)
and `causal_bootstapir_config()`, in float32 and with
compute_dtype="bfloat16" (float32 parameters, as the JAX predictor takes
them), on the 8-frame clip of tools/golden_clip.py. The protocol is
`run_stream`: the clip's 32 query points moved to frame 0, `init` on frame
0, one step per frame 0-7, and before the step of frame ADD_AT,
`add_points` puts NEW_POINTS (two of the clip's query positions) into the
slots ADD_IDX. Writes tests/data/bootstapir_golden_online.npz:

  query_points [1, 32, 3], new_query_points [1, 2, 3]   (t = 0)
  <dtype>_tracks [8, 1, 32, 2], <dtype>_visibles [8, 1, 32],
  <dtype>_occlusion, <dtype>_expected_dist [8, 1, 32]   (the logits)

for dtype float32 and bfloat16. The tracks and visibles are what the JAX
predictor's `predict` returns; the logits come from the same step, run
again with the state `predict` started from. No causal state is stored.

  JAX_PLATFORMS=cpu python tools/make_online_golden.py

numpy only at import: the port's tests and chip_smoke.py import
`run_stream` and the constants from here.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "runs/bootstapir_synth/trained_params_f16.npy")
GOLDEN = os.path.join(REPO, "tests/data/bootstapir_golden.npz")
OUT = os.path.join(REPO, "tests/data/bootstapir_golden_online.npz")

DTYPES = ("float32", "bfloat16")
ADD_AT = 4
ADD_IDX = (0, 5)
# The clip's query points whose (y, x) the added queries take.
NEW_POINTS = (8, 13)


def online_queries(query_points: np.ndarray):
  """(the clip's query points moved to frame 0, the two added ones)."""
  qp = np.array(query_points, np.float32)
  qp[..., 0] = 0.0
  return qp, qp[:, list(NEW_POINTS)].copy()


def run_stream(init, step, add_points, frames, query_points, new_points):
  """The online protocol on frames [B, T, H, W, 3] in [-1, 1]: `step(frame)`
  returns a dict of arrays, stacked over the steps."""
  init(frames[:, 0], query_points)
  outs = []
  for t in range(frames.shape[1]):
    if t == ADD_AT:
      add_points(frames[:, t], new_points, list(ADD_IDX))
    outs.append(step(frames[:, t]))
  return {key: np.stack([o[key] for o in outs]) for key in outs[0]}


def main():
  import jax

  jax.config.update("jax_platforms", "cpu")
  import jax.numpy as jnp

  from tapnet_tpu import inference
  from tapnet_tpu.checkpoints import tapir_checkpoint
  from tapnet_tpu.models import tapir
  from tapnet_tpu.utils import sampling

  golden = np.load(GOLDEN)
  frames = np.asarray(sampling.preprocess_frames(jnp.asarray(golden["video"])))
  qp, new_qp = online_queries(golden["query_points"])
  params = tapir_checkpoint.load_tapir_checkpoint(CHECKPOINT)
  arrays = dict(query_points=qp, new_query_points=new_qp)
  for name in DTYPES:
    config = tapir.causal_bootstapir_config(compute_dtype=name)
    predictor = inference.OnlineTapirPredictor(params, config)
    model, p = predictor.model, config.num_pips_iter

    @jax.jit
    def logits(params, frame, query_features, state):
      grids = model.apply({"params": params}, frame,
                          method=tapir.TAPIR.get_feature_grids)
      out = model.apply({"params": params}, frame.shape[-3:-1], grids,
                        query_features, None, None, state, True,
                        method=tapir.TAPIR.estimate_trajectories)
      mean = lambda key: jnp.mean(jnp.stack(out[key][p::p]), axis=0)[..., 0]
      return mean("occlusion"), mean("expected_dist")

    def step(frame, predictor=predictor, logits=logits):
      occ, expd = logits(predictor.params, jnp.asarray(frame)[:, None],
                         predictor._query_features, predictor._state)  # pylint: disable=protected-access
      tracks, visibles = predictor.predict(frame)
      return dict(tracks=tracks, visibles=visibles, occlusion=np.asarray(occ),
                  expected_dist=np.asarray(expd))

    out = run_stream(predictor.init, step, predictor.add_points, frames, qp,
                     new_qp)
    for key, value in out.items():
      arrays[f"{name}_{key}"] = value
    print(f"ran {name}", flush=True)
  os.makedirs(os.path.dirname(OUT), exist_ok=True)
  np.savez_compressed(OUT, **arrays)
  print(f"wrote {OUT} ({os.path.getsize(OUT) / 2**20:.3f} MiB)")


if __name__ == "__main__":
  sys.path.insert(0, REPO)
  main()

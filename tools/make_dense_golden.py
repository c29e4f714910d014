"""Writes golden RoboTAP dense-tracking outputs of the JAX package for the
port.

Runs `tapnet_tpu.robotap.dense_tracking.track_many_points` on the CPU with
the committed trained checkpoint
(runs/bootstapir_synth/trained_params_f16.npy) and
`causal_bootstapir_config()` (float32) on the 8-frame 256x256 clip of
tests/data/bootstapir_golden.npz, NUM_POINTS query points sampled across
all frames with seed SEED. Writes tests/data/bootstapir_golden_dense.npz:

  query_points [N, 3]                  (t, y, x), as track_many_points draws
  tracks [N, T, 2], visibility [N, T]  track_many_points' outputs
  occlusion, expected_dist [N, T]      the logits behind the flags: the
                                       mean over the last refinement
                                       iteration of each step, from a
                                       second pass of the same stream

The second pass repeats the stream step by step (the query features of
each source frame scattered into [1, N, C] banks, a causal state carried
from frame to frame) and must reproduce track_many_points' tracks (within
1e-3 px: XLA may fuse a step that returns more outputs another way) and
flags; it keeps the logits, which track_many_points does not return.

  JAX_PLATFORMS=cpu python tools/make_dense_golden.py

numpy only at import: chip_smoke.py and the port's tests import the
constants from here.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "runs/bootstapir_synth/trained_params_f16.npy")
CLIP = os.path.join(REPO, "tests/data/bootstapir_golden.npz")
OUT = os.path.join(REPO, "tests/data/bootstapir_golden_dense.npz")
NUM_POINTS = 64
SEED = 3


def golden_apart(out, golden, logit_tol):
  """Distances of a track_many_points run `out` (with its logits) from the
  golden arrays: the largest track and logit distances, the track median
  and 95th percentile (px), the share of equal flags, and the flags apart,
  split by whether JAX's combined visibility logit (the log-odds of
  (1 - sigmoid(occlusion)) (1 - sigmoid(expected_dist)), the probability
  the flag thresholds at 0.5) lies within `logit_tol` of 0."""
  occ = np.asarray(golden["occlusion"], np.float64)
  expd = np.asarray(golden["expected_dist"], np.float64)
  visible_p = (1 - 1 / (1 + np.exp(-occ))) * (1 - 1 / (1 + np.exp(-expd)))
  near = np.abs(np.log(visible_p) - np.log1p(-visible_p)) <= logit_tol
  flips = out["visibility"] != golden["visibility"]
  err = np.linalg.norm(out["tracks"] - golden["tracks"], axis=-1)
  return dict(
      track_max_px=float(np.abs(out["tracks"] - golden["tracks"]).max()),
      track_median_px=float(np.median(err)),
      track_p95_px=float(np.percentile(err, 95)),
      logit_max_abs=max(float(np.abs(out[k] - golden[k]).max())
                        for k in ("occlusion", "expected_dist")),
      visible_agree=float(np.mean(~flips)),
      flags_apart=int(flips.sum()),
      flags_apart_near_threshold=int((flips & near).sum()),
      flags_apart_elsewhere=int((flips & ~near).sum()),
      flags_near_threshold=int(near.sum()))


def main():
  import jax

  jax.config.update("jax_platforms", "cpu")
  import jax.numpy as jnp

  from tapnet_tpu.checkpoints import tapir_checkpoint
  from tapnet_tpu.models import tapir
  from tapnet_tpu.robotap import dense_tracking
  from tapnet_tpu.utils import sampling

  video = np.load(CLIP)["video"][0]  # [T, H, W, 3] uint8
  params = tapir_checkpoint.load_tapir_checkpoint(CHECKPOINT)
  config = tapir.causal_bootstapir_config()
  out = dense_tracking.track_many_points(video, params, config,
                                         num_points=NUM_POINTS, seed=SEED)

  # The second pass, keeping the logits.
  model = tapir.TAPIR(config=config)
  frames = video.astype(np.float32) / 255.0 * 2.0 - 1.0
  qp = out["query_points"]
  query_ts = qp[:, 0].astype(np.int32)
  apply = lambda method, *args: model.apply({"params": params}, *args,
                                            method=method)

  @jax.jit
  def frame_query_features(params, frame, pts):
    grids = model.apply({"params": params}, frame,
                        method=tapir.TAPIR.get_feature_grids)
    return model.apply({"params": params}, frame.shape, pts, grids,
                       method=tapir.TAPIR.get_query_features)

  banks = None
  for frame_id in np.unique(query_ts):
    sel = np.nonzero(query_ts == frame_id)[0]
    pts = qp[sel].copy()
    pts[:, 0] = 0.0
    qf = frame_query_features(
        params, jnp.asarray(frames[None, frame_id:frame_id + 1]),
        jnp.asarray(pts[None]))
    if banks is None:
      zeros = lambda x: jnp.zeros((1, NUM_POINTS) + x.shape[2:], x.dtype)
      banks = ([zeros(x) for x in qf.lowres], [zeros(x) for x in qf.hires],
               qf.resolutions)
    banks = ([a.at[:, sel].set(b) for a, b in zip(banks[0], qf.lowres)],
             [a.at[:, sel].set(b) for a, b in zip(banks[1], qf.hires)],
             banks[2])
  qf = tapir.QueryFeatures(tuple(banks[0]), tuple(banks[1]), banks[2])
  p = config.num_pips_iter

  @jax.jit
  def step(params, frame, qf, state):
    grids = model.apply({"params": params}, frame,
                        method=tapir.TAPIR.get_feature_grids)
    res = model.apply({"params": params}, frame.shape[-3:-1], grids, qf, None,
                      None, state, True,
                      method=tapir.TAPIR.estimate_trajectories)
    mean = lambda key: jnp.mean(jnp.stack(res[key][p::p]), axis=0)[0, :, 0]
    return (mean("tracks"), mean("occlusion"), mean("expected_dist"),
            res["causal_context"])

  state = apply(tapir.TAPIR.construct_initial_causal_state, 1, NUM_POINTS, 1)
  tracks, occ, expd = [], [], []
  for fr in range(frames.shape[0]):
    tr, oc, ex, state = step(params, jnp.asarray(frames[None, fr:fr + 1]), qf,
                             state)
    tracks.append(np.asarray(tr))
    occ.append(np.asarray(oc))
    expd.append(np.asarray(ex))
  tracks, occ, expd = (np.stack(x, axis=1) for x in (tracks, occ, expd))
  visible = np.array(sampling.postprocess_occlusions(occ, expd))
  visible &= np.arange(frames.shape[0])[None] >= query_ts[:, None]
  # The same jitted programs but for the step's outputs: XLA may fuse them
  # another way, so the tracks agree to float32 noise and the flags equal.
  np.testing.assert_allclose(tracks, out["tracks"], rtol=0, atol=1e-3)
  np.testing.assert_array_equal(visible, out["visibility"])

  np.savez_compressed(
      OUT, query_points=qp, tracks=out["tracks"],
      visibility=out["visibility"], occlusion=occ, expected_dist=expd)
  print(f"wrote {OUT} ({os.path.getsize(OUT) / 2**20:.3f} MiB); "
        f"visible {out['visibility'].mean():.3f}")


if __name__ == "__main__":
  sys.path.insert(0, REPO)
  main()

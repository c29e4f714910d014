"""Writes golden outputs of the JAX package's TAPNext++ VOTS tracker for the
PyTorch port, and holds the clip, the stream protocol and the limits that
the port's tests and chip_smoke.py share.

The JAX package's `tapnextpp.vots_tracker.VotsPointTracker` runs on the CPU
at its defaults (512x512 input, 64 support points a query in a 32 px
radius) with the ViT-B weights of tools/tapnext_weights.py (seed 0) made at
256x256 and adapted to 512 by the tracker (`adapt_posembs`), as the
reference runs TAPNext++. The clip is `vots_clip()`: 6 display frames of
240x428, 2 real queries on its first frame. The stream (`run_stream`):
`initialize` on frame 0, `track` on each later frame. Stored
(tests/data/vots_golden.npz): `xy` [6, 2, 2] display (x, y), `visible`
[6, 2] and `visible_logits` [6, 2], and `resized_crc32` [6], the CRC-32 of
each frame's `cv2.resize(INTER_LINEAR)` to 512x512 (the JAX tracker's
resize), against which the card's integer resize is checked; the clip and
weights are rebuilt from their seeds.

Limits (`judge`), those of the port's CPU test (tests/test_torch_vots.py):
tracks within TRACK_MODEL_PX in model space (the display error divided by
the display / model scale of its axis), visibility logits within LOGIT,
and the flags equal except where JAX's logit lies within LOGIT of 0.

  JAX_PLATFORMS=cpu python tools/make_vots_golden.py   (about two minutes)
"""

from __future__ import annotations

import os
import sys
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests/data/vots_golden.npz")
WEIGHT_SEED = 0
CLIP_SEED = 7
FRAMES, DISPLAY_HW, QUERIES = 6, (240, 428), 2
RESOLUTION = 512
TRACK_MODEL_PX, LOGIT = 0.05, 2e-3

sys.path.insert(0, REPO)
from tools.tapnext_weights import seeded_tapnext_params  # noqa: E402


def vots_clip(frames=FRAMES, hw=DISPLAY_HW, queries=QUERIES, seed=CLIP_SEED):
  """(frames uint8 [frames, H, W, 3], query points float32 [queries, 2]
  display (x, y) on frame 0), made with numpy from `seed`: a smooth random
  texture (sums of oriented sinusoids and Gaussian blobs) that drifts a few
  pixels a frame, with a bright blob that moves on its own."""
  rng = np.random.RandomState(seed)
  h, w = hw
  yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
  base = np.zeros((h, w, 3), np.float32)
  for _ in range(6):
    k = rng.uniform(0.01, 0.08, 2)
    phase = rng.uniform(0, 2 * np.pi)
    base += rng.uniform(20, 40, 3) * np.sin(k[0] * yy + k[1] * xx + phase)[
        ..., None]
  for _ in range(12):
    cy, cx = rng.uniform(0, h), rng.uniform(0, w)
    s = rng.uniform(6, 20)
    base += rng.uniform(-60, 60, 3) * np.exp(
        -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))[..., None]
  drift = rng.uniform(-3, 3, 2)
  blob_start = np.array([w * 0.6, h * 0.4], np.float32)
  blob_vel = rng.uniform(-4, 4, 2)
  video = []
  for t in range(frames):
    dy, dx = np.round(drift * t).astype(int)
    frame = np.roll(base, (dy, dx), axis=(0, 1))
    bx, by = blob_start + blob_vel * t
    frame = frame + 90 * np.exp(
        -((yy - by) ** 2 + (xx - bx) ** 2) / (2 * 9.0 ** 2))[..., None]
    video.append(np.clip(frame + 128, 0, 255).astype(np.uint8))
  margin = np.array([w, h], np.float32) * 0.15
  points = margin + rng.uniform(0, 1, (queries, 2)) * (
      np.array([w, h], np.float32) - 2 * margin)
  points[0] = blob_start
  return np.stack(video), points.astype(np.float32)


def run_stream(tracker, frames, queries):
  """`initialize` on frames[0], `track` on each later frame: {xy [T, Q, 2]
  display (x, y), visible [T, Q], visible_logits [T, Q]}. The tracker
  exposes `visible_logits` after each call (the port's does; `jax_tracker`
  adds it to JAX's)."""
  xy, vis = tracker.initialize(frames[0], queries)
  out = dict(xy=[xy], visible=[vis], visible_logits=[tracker.visible_logits])
  for frame in frames[1:]:
    xy, vis = tracker.track(frame)
    out["xy"].append(xy)
    out["visible"].append(vis)
    out["visible_logits"].append(tracker.visible_logits)
  return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items()}


def jax_tracker(params, config, **kwargs):
  """The JAX package's VotsPointTracker with its real queries' visibility
  logits kept in `visible_logits` after each call (its predictor's
  `predict` returns flags only; the same jitted step is called here)."""
  import jax.numpy as jnp

  from tapnet_tpu.tapnextpp import vots_tracker

  tracker = vots_tracker.VotsPointTracker(params, config, **kwargs)
  pred = tracker.predictor
  init = pred.init

  def init_keeping_logits(frames, query_points):
    tracks, vis = init(frames, query_points)
    tracker.visible_logits = np.asarray(vis)[0, :tracker.num_real, 0, 0]
    return tracks, vis

  def predict_keeping_logits(frame):
    frame = jnp.asarray(frame)
    if frame.ndim == 4:
      frame = frame[:, None]
    tracks, vis, pred._state = pred._jitted_step(pred.params, frame,
                                                 pred._state)
    tracker.visible_logits = np.asarray(vis)[0, :tracker.num_real, 0, 0]
    return np.asarray(tracks[:, :, 0]), np.asarray(vis[:, :, 0, 0] > 0)

  pred.init, pred.predict = init_keeping_logits, predict_keeping_logits
  return tracker


def judge(got, ref, display_hw, resolution=RESOLUTION):
  """The port's stream against JAX's: the largest track error in model
  pixels, the largest logit difference, the flags apart where JAX's logit
  is not within LOGIT of 0, and whether all are within the limits."""
  h, w = display_hw
  scale = np.array([w / resolution, h / resolution], np.float32)
  track_err = np.abs(np.asarray(got["xy"]) - ref["xy"]) / scale
  logit_err = np.abs(np.asarray(got["visible_logits"]) - ref["visible_logits"])
  near = np.abs(ref["visible_logits"]) <= LOGIT
  apart = (np.asarray(got["visible"]) != ref["visible"])
  r = dict(track_max_model_px=float(track_err.max()),
           logit_max_abs=float(logit_err.max()),
           flags_apart_near_zero=int((apart & near).sum()),
           flags_apart_elsewhere=int((apart & ~near).sum()),
           limits=dict(track_model_px=TRACK_MODEL_PX, logit=LOGIT))
  r["ok"] = (r["track_max_model_px"] <= TRACK_MODEL_PX
             and r["logit_max_abs"] <= LOGIT
             and r["flags_apart_elsewhere"] == 0)
  return r


def frame_crc32(frame_u8: np.ndarray) -> int:
  """CRC-32 of a uint8 frame's bytes (C order)."""
  return zlib.crc32(np.ascontiguousarray(frame_u8).tobytes())


def main():
  import cv2
  import jax

  jax.config.update("jax_platforms", "cpu")
  from tapnet_tpu.models import ssm_vit

  config = ssm_vit.SsmVitConfig()
  params = seeded_tapnext_params(config, WEIGHT_SEED)
  frames, queries = vots_clip()
  tracker = jax_tracker(params, config, input_resolution=RESOLUTION)
  out = run_stream(tracker, frames, queries)
  out["resized_crc32"] = np.array([frame_crc32(cv2.resize(
      f, (RESOLUTION, RESOLUTION), interpolation=cv2.INTER_LINEAR))
                                   for f in frames], np.int64)
  print({k: (v.shape, v.dtype) for k, v in out.items()}, flush=True)
  np.savez(OUT, **out)
  print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
  main()

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

The int8 streams have a file of their own,
tests/data/bootstapir_golden_online_int8.npz: the same protocol in float32
with `causal_bootstapir_config(**INT8_CONFIGS[name])` for the int8
configurations a-d of tools/golden_clip.py, as `<name>_tracks`,
`<name>_visibles`, `<name>_occlusion` and `<name>_expected_dist` (each
step's grids quantized anew, as JAX streams them; "d" streams the per-frame
int8 ExtraConvs, since the per-pixel kernel needs 16+ frames).

The int8 file also holds a witness of how far float32 noise alone moves
JAX's own int8 streams: the same streams on the clip with every pixel
nudged NUDGE_ULPS float32 ulps up after preprocessing, as
`<name>_nudged_<key>`. An int8 stream carries a rounding that noise flipped
into every later step, so JAX against itself on nudged frames reads how far
a faithful port's stream may sit from JAX's. The nudge must move the int8
roundings as much as an implementation's float32 noise does: one ulp is
absorbed before the ExtraConvs at some frames (JAX's int8 feature grids of
frames 1 and 7 come out bit-equal), while 16 ulps change about as many
values of those grids (1.5e5 of 2.6e5 over 1e-5 at frames 1, 3 and 7) as
the port's float32 noise does (0.8e5-1.6e5).

  JAX_PLATFORMS=cpu python tools/make_online_golden.py          # both files
  JAX_PLATFORMS=cpu python tools/make_online_golden.py float
  JAX_PLATFORMS=cpu python tools/make_online_golden.py int8     # and witness
  JAX_PLATFORMS=cpu python tools/make_online_golden.py witness  # witness only

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
OUT_INT8 = os.path.join(REPO, "tests/data/bootstapir_golden_online_int8.npz")

DTYPES = ("float32", "bfloat16")
ADD_AT = 4
ADD_IDX = (0, 5)
# The clip's query points whose (y, x) the added queries take.
NEW_POINTS = (8, 13)
# The witness's nudge, in float32 ulps of the preprocessed frames.
NUDGE_ULPS = 16


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


def nudged(frames: np.ndarray, ulps: int = NUDGE_ULPS) -> np.ndarray:
  """The preprocessed frames with every value `ulps` float32 ulps up."""
  out = np.asarray(frames, np.float32)
  for _ in range(ulps):
    out = np.nextafter(out, np.float32(np.inf)).astype(np.float32)
  return out


def add_witness(arrays, stream, frames):
  """Adds `<name>_nudged_<key>` of every int8 configuration to `arrays`:
  `stream(config, frames)` on the nudged `frames`."""
  from tapnet_tpu.models import tapir
  from tools.golden_clip import INT8_CONFIGS

  for name, overrides in sorted(INT8_CONFIGS.items()):
    out = stream(tapir.causal_bootstapir_config(**overrides), nudged(frames))
    for key, value in out.items():
      arrays[f"{name}_nudged_{key}"] = value
    print(f"ran {name} on the nudged clip", flush=True)


def main(which=("float", "int8")):
  import jax

  jax.config.update("jax_platforms", "cpu")
  import jax.numpy as jnp

  from tapnet_tpu import inference
  from tapnet_tpu.checkpoints import tapir_checkpoint
  from tapnet_tpu.models import tapir
  from tapnet_tpu.ops import qconv
  from tapnet_tpu.utils import sampling
  from tools.golden_clip import INT8_CONFIGS
  from tools.make_eval_draws import use_exact_int8_conv

  # JAX's int8 convolutions as exact float32 ones: the same int32 values,
  # minutes faster a stream on the CPU.
  use_exact_int8_conv(qconv)
  golden = np.load(GOLDEN)
  frames = np.asarray(sampling.preprocess_frames(jnp.asarray(golden["video"])))
  qp, new_qp = online_queries(golden["query_points"])
  params = tapir_checkpoint.load_tapir_checkpoint(CHECKPOINT)

  def stream(config, frames=frames):
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

    def step(frame):
      occ, expd = logits(predictor.params, jnp.asarray(frame)[:, None],
                         predictor._query_features, predictor._state)  # pylint: disable=protected-access
      tracks, visibles = predictor.predict(frame)
      return dict(tracks=tracks, visibles=visibles, occlusion=np.asarray(occ),
                  expected_dist=np.asarray(expd))

    return run_stream(predictor.init, step, predictor.add_points, frames, qp,
                      new_qp)

  os.makedirs(os.path.dirname(OUT), exist_ok=True)
  if "witness" in which and "int8" not in which:
    with np.load(OUT_INT8) as z:
      arrays = dict(z)
    add_witness(arrays, stream, frames)
    np.savez_compressed(OUT_INT8, **arrays)
    print(f"wrote {OUT_INT8} ({os.path.getsize(OUT_INT8) / 2**20:.3f} MiB)")
  runs = []
  if "float" in which:
    runs.append((OUT, {name: tapir.causal_bootstapir_config(compute_dtype=name)
                       for name in DTYPES}))
  if "int8" in which:
    runs.append((OUT_INT8, {
        name: tapir.causal_bootstapir_config(**overrides)
        for name, overrides in sorted(INT8_CONFIGS.items())}))
  for path, configs in runs:
    arrays = dict(query_points=qp, new_query_points=new_qp)
    for name, config in configs.items():
      for key, value in stream(config).items():
        arrays[f"{name}_{key}"] = value
      print(f"ran {name}", flush=True)
    if path == OUT_INT8:
      add_witness(arrays, stream, frames)
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({os.path.getsize(path) / 2**20:.3f} MiB)")


if __name__ == "__main__":
  sys.path.insert(0, REPO)
  main(sys.argv[1:] or ("float", "int8"))

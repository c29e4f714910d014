"""Writes the held-out synthetic eval sets as random draws, and the JAX
package's TAP-Vid metrics on them, for the PyTorch port.

The sets behind the repo's BootsTAPIR accuracy numbers are made by the JAX
package's `data.synthetic.export_npz`; their arguments are the port's
`tapnet_tpu_torch.data.synthetic.HELD_OUT_SETS` (16 videos each, 24 frames
at 256^2, 64 tracks):

  a  seed 10000, 6 sprites, vel 3   (runs/bootstapir_synth/eval_trained.json)
  b  seed 20000, 12 sprites, vel 7  (runs/bootstap_demo/results.json "before_b")

A set's videos take about 56 MB; the draws they are rendered from take a few
KB a video. This tool takes JAX's draws with `export_npz`'s key splitting
(one `split` per example, then `make_batch`'s `split(key, 1)` and
`split(k, 8)`) and writes them to tests/data/synth_eval_draws.npz as
`<set>/<name>` arrays with a leading video axis. The port's
`tapnet_tpu_torch.data.synthetic.export_npz(..., draws=...)` renders them
into the same Kubric npz layout (`render_batch`, then JAX's uint8
conversion).

It then scores the trained BootsTAPIR checkpoint
(runs/bootstapir_synth/trained_params_f16.npy, the file the card loads) on
JAX's own export of each set with `tapnet_tpu.tapvid.evaluate` on the CPU:
`TapirPredictor(query_chunk_size=32)`, `bootstapir_config()`, strided
queries (one query bucket a set, so the model compiles once), in the
precisions of `PRECISIONS` (fp32, bf16 and the int8 configurations a-d of
tools/golden_clip.py on set a; fp32 on set b). The 13 metrics per video and
their mean go to tests/data/synth_eval_jax_metrics.json.

  JAX_PLATFORMS=cpu python tools/make_eval_draws.py              # both files
  JAX_PLATFORMS=cpu python tools/make_eval_draws.py draws        # draws only
  JAX_PLATFORMS=cpu python tools/make_eval_draws.py metrics a:c  # one run,
                                            # kept beside the others
  JAX_PLATFORMS=cpu python tools/make_eval_draws.py metrics a:c@5:8

A run scores only the videos the file does not hold yet, and writes each
video as soon as it is scored: a run cut short is resumed by running it
again, and processes given other videos of one run (`@start:stop`) may
score them at once. JAX's int8 ExtraConvs (c) run their integer
convolutions as exact float32 ones (`int8_conv_in_float32`: the same int32
values; XLA's integer convolution takes about 25 minutes a video on the
CPU).

chip_smoke.py does not import this tool: the sets' arguments and the draws'
reader are the port's, and it reads the two files.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tapnet_tpu_torch.data import synthetic  # noqa: E402

CHECKPOINT = os.path.join(REPO, "runs/bootstapir_synth/trained_params_f16.npy")
DRAWS = os.path.join(REPO, "tests/data/synth_eval_draws.npz")
METRICS = os.path.join(REPO, "tests/data/synth_eval_jax_metrics.json")

# The scored runs: set -> precisions. "fp32" and "bf16" are the float
# predictor (bfloat16=True for bf16); a letter is an int8 configuration of
# tools/golden_clip.INT8_CONFIGS over bootstapir_config().
PRECISIONS = {"a": ("fp32", "bf16", "a", "b", "c", "d"), "b": ("fp32",)}


def jax_draws(seed, num_examples, num_frames, height, width, num_queries,
              num_sprites, vel_range):
  """The draws of `export_npz(dir, num_examples, seed, ...)`, stacked over
  the videos, as `make_batch`'s `one_example` takes them."""
  import jax
  import jax.numpy as jnp

  h, w, s, q, vr = height, width, num_sprites, num_queries, vel_range
  out = {k: [] for k in synthetic.DRAW_KEYS}
  rng = jax.random.PRNGKey(seed)
  for _ in range(num_examples):
    rng, key = jax.random.split(rng)
    (k,) = jax.random.split(key, 1)
    keys = jax.random.split(k, 8)
    out["bg_small"].append(jax.random.uniform(keys[0], (8, 8, 3)))
    out["pos0"].append(jax.random.uniform(
        keys[1], (s, 2), minval=jnp.array([h * 0.2, w * 0.2]),
        maxval=jnp.array([h * 0.8, w * 0.8])))
    out["vel"].append(jax.random.uniform(keys[2], (s, 2), minval=-vr,
                                         maxval=vr))
    out["half"].append(jax.random.uniform(keys[3], (s, 1), minval=h * 0.06,
                                          maxval=h * 0.18))
    out["tex_small"].append(jax.random.uniform(keys[4], (s, 8, 8, 3)))
    out["sprite_id"].append(jax.random.randint(keys[5], (q,), 0, s))
    out["offset"].append(jax.random.uniform(keys[6], (q, 2), minval=-0.9,
                                            maxval=0.9))
    out["t_query"].append(jax.random.randint(keys[7], (q,), 0, num_frames))
  return {k: np.stack([np.asarray(v) for v in vs]) for k, vs in out.items()}


def write_draws():
  arrays = {}
  for name, spec in synthetic.HELD_OUT_SETS.items():
    spec = dict(spec)
    num_examples = spec.pop("num_examples")
    for k, v in jax_draws(num_examples=num_examples, **spec).items():
      arrays[f"{name}/{k}"] = v
  os.makedirs(os.path.dirname(DRAWS), exist_ok=True)
  np.savez_compressed(DRAWS, **arrays)
  print(f"wrote {DRAWS} ({os.path.getsize(DRAWS) / 1024:.1f} KiB)", flush=True)


def export_jax_set(name: str, out_dir: str):
  from tapnet_tpu.data import synthetic as jax_synthetic

  spec = dict(synthetic.HELD_OUT_SETS[name])
  jax_synthetic.export_npz(out_dir, spec.pop("num_examples"), **spec)


# Input channels of one float32 partial product of `int8_conv_in_float32`:
# 9 taps x 64 channels x 127^2 < 2^24, so every partial sum is an integer
# float32 holds exactly, in any order of summation.
_EXACT_CHANNELS = 64


def int8_conv_in_float32(conv):
  """`qconv._conv` with its int8 x int8 -> int32 convolutions computed as
  float32 convolutions of the int8 values over _EXACT_CHANNELS input
  channels at a time, each exact and converted to int32, then summed in
  int32: the same int32 result, since no partial sum rounds. XLA's integer
  convolution on the CPU takes about 25 minutes a video of the ExtraConvs'
  shapes; this takes seconds."""
  import jax.numpy as jnp

  def patched(x, kernel, dtype_out, strides):
    if x.dtype != jnp.int8:
      return conv(x, kernel, dtype_out, strides)
    acc = None
    for c0 in range(0, x.shape[-1], _EXACT_CHANNELS):
      part = conv(x[..., c0:c0 + _EXACT_CHANNELS].astype(jnp.float32),
                  kernel[:, :, c0:c0 + _EXACT_CHANNELS].astype(jnp.float32),
                  jnp.float32, strides).astype(jnp.int32)
      acc = part if acc is None else acc + part
    return acc

  patched.exact_int8 = True
  return patched


def use_exact_int8_conv(qconv):
  """Puts `int8_conv_in_float32` in place of the JAX package's
  `qconv._conv`, once (its callers look it up when they are traced)."""
  if not hasattr(qconv._conv, "exact_int8"):  # pylint: disable=protected-access
    qconv._conv = int8_conv_in_float32(qconv._conv)  # pylint: disable=protected-access


def score(name: str, precision: str, data_dir: str, params, videos):
  """Scores the set's videos of index `videos` that METRICS does not hold
  yet, and merges each into it as soon as it is scored, so a run cut short
  keeps its videos and a second run resumes it; several processes may score
  one run's videos at once."""
  from tapnet_tpu import inference
  from tapnet_tpu.models import tapir
  from tapnet_tpu.ops import qconv
  from tapnet_tpu.tapvid import datasets, evaluate
  from tools.golden_clip import INT8_CONFIGS

  use_exact_int8_conv(qconv)
  key = f"{name}:{precision}"
  overrides = {} if precision in ("fp32", "bf16") else INT8_CONFIGS[precision]
  query_mode = synthetic.HELD_OUT_QUERY_MODE
  examples = list(datasets.create_kubric_dataset(data_dir, query_mode))
  todo = [i for i in videos if i not in _recorded(key)]
  if not todo:
    return
  # One query bucket for the whole set, so XLA compiles the predictor once
  # (a compile of the full model takes minutes on the CPU); the padded
  # queries are independent of the real ones and dropped.
  bucket = -(-max(e["kubric"]["query_points"].shape[1] for e in examples)
             // 64) * 64
  predictor = inference.TapirPredictor(
      params, tapir.bootstapir_config(**overrides), query_bucket=bucket,
      query_chunk_size=synthetic.HELD_OUT_QUERY_CHUNK_SIZE,
      bfloat16=precision == "bf16")
  for i in todo:
    # One video at a time, so each video's metrics are kept; the mean over
    # them is evaluate_dataset's mean over the set.
    t0 = time.time()
    metrics = {k: float(v) for k, v in evaluate.evaluate_dataset(
        predictor, [examples[i]], query_mode, verbose=False).items()}
    run = _merge_video(key, i, metrics, time.time() - t0, bucket,
                       len(examples))
    print(f"  {key} video {i}: AJ {metrics['average_jaccard']:.6f} "
          f"({time.time() - t0:.0f} s; {run['videos']} of "
          f"{len(examples)} in)", flush=True)


def _recorded(key):
  """The video indices METRICS holds for run `key`."""
  if not os.path.exists(METRICS):
    return set()
  with open(METRICS) as f:
    run = json.load(f)["runs"].get(key, {})
  return {i for i, m in enumerate(run.get("per_video", ())) if m is not None}


def _merge_video(key, index, metrics, seconds, bucket, num_videos):
  """Puts video `index`'s metrics into run `key` of METRICS, keeping the
  rest of the file (the file is rewritten under a lock). A run holds
  "per_video" (13 metrics a video, null where a video is not scored yet),
  "videos" (the count scored), "complete", "mean" (over the videos scored:
  evaluate_dataset's mean over the set once complete), "seconds" (the sum
  of the videos' times) and "query_bucket"."""
  import fcntl

  with open(os.path.join(tempfile.gettempdir(), "synth_eval_metrics.lock"),
            "w") as lock:
    fcntl.flock(lock, fcntl.LOCK_EX)
    doc = {"runs": {}}
    if os.path.exists(METRICS):
      with open(METRICS) as f:
        doc = json.load(f)
    doc.update(
        checkpoint=os.path.relpath(CHECKPOINT, REPO),
        predictor="TapirPredictor(query_chunk_size="
        f"{synthetic.HELD_OUT_QUERY_CHUNK_SIZE})",
        config="bootstapir_config() + tools/golden_clip.INT8_CONFIGS",
        query_mode=synthetic.HELD_OUT_QUERY_MODE, sets=synthetic.HELD_OUT_SETS,
        device="cpu")
    run = doc["runs"].setdefault(key, {})
    per_video = run.get("per_video", [])
    per_video += [None] * (num_videos - len(per_video))
    per_video[index] = metrics
    scored = [m for m in per_video if m is not None]
    run.update(
        per_video=per_video, videos=len(scored),
        complete=len(scored) == num_videos,
        mean={k: float(np.mean([m[k] for m in scored])) for k in metrics},
        seconds=run.get("seconds", 0.0) + seconds, query_bucket=bucket)
    with open(METRICS, "w") as f:
      json.dump(doc, f, indent=1, sort_keys=True)
  return run


def write_metrics(runs):
  """Scores `runs` ((set, precision, video indices) triples) and merges
  them into METRICS."""
  from tapnet_tpu.checkpoints import tapir_checkpoint

  params = tapir_checkpoint.load_tapir_checkpoint(CHECKPOINT)
  for name in sorted({s for s, _, _ in runs}):
    with tempfile.TemporaryDirectory() as data_dir:
      export_jax_set(name, data_dir)
      for set_name, precision, videos in runs:
        if set_name == name:
          score(name, precision, data_dir, params, videos)
  print(f"wrote {METRICS}", flush=True)


def _parse_run(arg):
  """"a:c" (every video of the set) or "a:c@5:8" (videos 5 to 7)."""
  run, _, span = arg.partition("@")
  name, precision = run.split(":")
  start, stop = (int(v) for v in span.split(":")) if span else (
      0, synthetic.HELD_OUT_SETS[name]["num_examples"])
  return name, precision, range(start, stop)


def main(argv):
  import jax

  jax.config.update("jax_platforms", "cpu")
  if not argv or argv[0] == "draws":
    write_draws()
  if not argv or argv[0] == "metrics":
    runs = [_parse_run(r) for r in argv[1:]] or [
        _parse_run(f"{s}:{p}") for s, ps in PRECISIONS.items() for p in ps]
    write_metrics(runs)


if __name__ == "__main__":
  main(sys.argv[1:])

"""Writes the JAX package's TAPIR training numbers for the PyTorch port, and
holds the port's to them.

The JAX package on the CPU (its kernels' plain references; their VJPs are
plain math) trains a small BootsTAPIR (CONFIG: ExtraConvs, 2 mixer blocks at
the served width 512, 2 refinement steps, pyramid level 1, ResNet blocks
(1, 1, 1, 1), 64x64) on one batch of 2 clips of 4 frames with 8 queries in
chunks of 4, so that the second chunk's refinement leaves the graph:

  * "identity" and "permuted": 3 steps of `trainer.tapir_loss_builder`,
    once with the chunks in query order (no "permutation" rng) and once in
    the order of JAX's draw for PERMUTATION_KEY, which the file stores and
    `run_port` feeds to the port (`models.tapir._draw_permutation`);
  * "bootstrap": one step of `bootstrap.make_bootstrap_train_step` (teacher
    = student at the golden weights; a labeled anchor, the golden batch, and
    an unlabeled video), JAX's query, view and colour draws for
    BOOTSTRAP_KEY stored and fed to the port (`bootstrap._sample_queries`,
    `_sample_view`, `data.augmentations.color_draws`).

The optimizer is the TAPIR experiment's (b2 0.95, weight decay 0.1, no
clipping) with warmup 1. The weights (`golden_params`, numpy seed 0, Flax's
initialisers' distributions) and the batches (numpy seeds 0 and 1) are
rebuilt from their seeds on either side, so the file
(tests/data/tapir_train_golden.npz) holds only results: per run and step
the loss, the scalars and per parameter leaf its largest |g|, the learning
rates, and at a fixed sample of each leaf's elements (all of a small leaf;
else 48 at random and the 8 largest |g| of the identity run's first step)
the gradients of each step and the parameters after the last (the
bootstrap run: the student's and the teacher's).

`run_port` runs the same steps through the port's `Trainer` and
`make_bootstrap_train_step` (on the card or the CPU) and `judge` holds them
to the file. The limits, derived before any port number is read:

  * loss and every scalar, per step: 1e-5 relative (float32 sums in other
    orders through the same layers); gradient_norm the same;
  * every gradient leaf, each run's first step: 1e-4 * max|g_leaf| + 1e-7 *
    G, G the largest |g| of the model (float32 noise on gradients that
    vanish exactly);
  * the parameters after the last step: 1e-6 * |p| (a float32 rounding a
    step) plus what the gradient limit lets Adam move (as in
    tools/make_tapnext_train_golden.py, whose docstring derives it; here
    without clipping); the teacher moves by (1 - ema_decay) of the
    student's update, so the student's limit bounds it too;
  * each of these limits also takes WITNESS_FACTOR times JAX's own distance
    from its numbers when the batch's videos are nudged by NUDGE_REL (16
    float32 steps of 2^-23, a random sign per value): the witness of how
    far float32 noise moves each number. Most move by 1e-6 of their size,
    but a gradient that vanishes exactly (pos_out's bias: the softmax
    ignores a constant) is all noise, and the bootstrap step's student sees
    a view with flat zero borders (the warp's fill), where JAX's own
    backbone gradients move by percents under the nudge.

On the card (`card=True`), K1 and K3 run their float32 kernels, whose
outputs may lie 1e-4 (K1, absolute: the features are unit vectors, so
|corr| <= 1) and 1e-4 + 1e-4 |y| (K3) from the plain versions'
(`chip_smoke.CORR_FP32_TOL`, `MIXER_FP32_TOL`); the backward is the plain
math's on either device. What those forward limits carry into each number
is measured here, on the CPU, before the card is read: `witness` runs the
port with every K1 and K3 output moved by its full limit times a seeded
random sign, and each card limit is the CPU limit plus WITNESS_FACTOR times
that run's distance from the plain one (one draw of signs is not the worst
case; 3 covers the partial cancellation of independent errors).

  JAX_PLATFORMS=cpu python tools/make_tapir_train_golden.py
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Any, Dict, Mapping

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests/data/tapir_train_golden.npz")
sys.path.insert(0, REPO)

CONFIG = dict(num_mixer_blocks=2, num_pips_iter=2, blocks_per_group=(1, 1, 1, 1),
              initial_resolution=(64, 64))
SIZE = 64
BATCH, FRAMES, QUERIES, CHUNK, STEPS = 2, 4, 8, 4, 3
OPTIMIZER = dict(base_lr=1e-3, adam_b1=0.9, adam_b2=0.95, weight_decay=0.1,
                 warmup_steps=1, max_norm=-1.0)
TOTAL_STEPS = 10
BOOTSTRAP = dict(num_queries=8, query_chunk_size=4, supervised_chunk_size=4)
WEIGHT_SEED, BATCH_SEED, VIDEO_SEED = 0, 0, 1
PERMUTATION_KEY, BOOTSTRAP_KEY = 7, 11
RUNS = ("identity", "permuted", "bootstrap")
N_RANDOM, N_TOP = 48, 8
LOSS_REL = 1e-5
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-7
PARAM_REL = 1e-6
# The card's float32 forward limits of K1 and K3 (chip_smoke.py).
K1_ATOL, K3_RTOL, K3_ATOL = 1e-4, 1e-4, 1e-4
WITNESS_FACTOR = 3.0
WITNESS_SEED = 5
NUDGE_REL, NUDGE_SEED = 16 * 2.0**-23, 3


def steps_of(run: str) -> int:
  return 1 if run == "bootstrap" else STEPS


def model_config():
  from tapnet_tpu_torch.models import tapir
  return tapir.bootstapir_config(**CONFIG)


def golden_params() -> Dict[str, Any]:
  """The Flax-layout weights, rebuilt from WEIGHT_SEED with numpy: the tree
  of `models.tapir.init_tapir_params` with each LeCun kernel drawn anew
  (a standard normal truncated at 2 by redrawing, scaled to variance
  1 / fan_in), the zero and one leaves kept."""
  import torch

  from tapnet_tpu_torch.models import tapir
  tree = tapir.init_tapir_params(model_config(), torch.Generator().manual_seed(0))
  rng = np.random.RandomState(WEIGHT_SEED)

  def fill(node):
    for key in sorted(node):
      value = node[key]
      if isinstance(value, dict):
        fill(value)
      elif key == "kernel" and np.any(value):
        z = rng.standard_normal(value.shape)
        while np.any(np.abs(z) > 2):
          bad = np.abs(z) > 2
          z[bad] = rng.standard_normal(int(bad.sum()))
        fan_in = int(np.prod(value.shape[:-1]))
        node[key] = (z * np.sqrt(1.0 / fan_in) / tapir._TRUNC_STD).astype(  # pylint: disable=protected-access
            np.float32)

  fill(tree)
  return tree


def golden_batch(seed: int = BATCH_SEED) -> Dict[str, np.ndarray]:
  """The labeled batch, rebuilt from `seed` (numpy): 8-bit frames in
  [-1, 1], query points (t, y, x) on the frames, targets (x, y) partly off
  the frame, 30% occluded."""
  rng = np.random.RandomState(seed)
  video = rng.randint(0, 256, (BATCH, FRAMES, SIZE, SIZE, 3))
  query_points = np.stack([
      rng.randint(0, FRAMES, (BATCH, QUERIES)),
      rng.uniform(0, SIZE, (BATCH, QUERIES)),
      rng.uniform(0, SIZE, (BATCH, QUERIES))], -1)
  return {
      "video": (video / 127.5 - 1.0).astype(np.float32),
      "query_points": query_points.astype(np.float32),
      "target_points": rng.uniform(-2, SIZE + 2, (BATCH, QUERIES, FRAMES, 2)
                                   ).astype(np.float32),
      "occluded": (rng.rand(BATCH, QUERIES, FRAMES) < 0.3).astype(np.float32),
  }


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
  out = {}
  for k, v in tree.items():
    key = f"{prefix}/{k}" if prefix else k
    if isinstance(v, Mapping):
      out.update(flatten(v, key))
    else:
      out[key] = np.asarray(v)
  return out


def _decayed(key: str) -> bool:
  return key.rsplit("/", 1)[-1] not in ("bias", "scale", "offset")


def grad_limit(golden, run: str, key: str, step: int = 0, card: bool = False):
  """The gradient limit of leaf `key` at `step` of `run`."""
  limit = (GRAD_REL * float(golden[f"{run}/grad_max/{key}"][step])
           + GRAD_FLOOR * float(golden[f"{run}/global_max"][step])
           + WITNESS_FACTOR * float(golden[f"{run}/nudge/grad/{key}"][step]))
  if card:
    limit += WITNESS_FACTOR * float(golden[f"{run}/kernels/grad/{key}"])
  return limit


def scalar_limit(golden, run: str, name: str, step: int,
                 card: bool = False) -> float:
  """The limit of scalar `name` at `step` of `run`."""
  limit = (LOSS_REL * abs(float(golden[f"{run}/scalar/{name}"][step]))
           + WITNESS_FACTOR * float(golden[f"{run}/nudge/scalar/{name}"][step]))
  if card:
    limit += WITNESS_FACTOR * float(golden[f"{run}/kernels/scalar/{name}"][step])
  return limit


def param_limit(golden, run: str, key: str, card: bool = False) -> np.ndarray:
  """Per sampled element of leaf `key`, how far the port's parameter after
  the run's last step may lie from JAX's (the module docstring)."""
  b1, b2, eps = OPTIMIZER["adam_b1"], OPTIMIZER["adam_b2"], 1e-8
  lr = golden["lr"].astype(np.float64)
  g = golden[f"{run}/grad/{key}"].astype(np.float64)  # [steps, n]
  wd = OPTIMIZER["weight_decay"] if _decayed(key) else 0.0
  mu = np.zeros_like(g[0])
  nu = np.zeros_like(g[0])
  reach = np.zeros_like(g[0])
  apart = np.zeros_like(g[0])
  for k in range(steps_of(run)):
    d = grad_limit(golden, run, key, k, card)
    mu = b1 * mu + (1 - b1) * g[k]
    nu = b2 * nu + (1 - b2) * g[k] ** 2
    s = np.sqrt(nu / (1 - b2 ** (k + 1)))
    reach = np.maximum(reach, d)
    w = (1 - b1) * b1 ** np.arange(k, -1, -1) / (1 - b1 ** (k + 1))
    v = (1 - b2) * b2 ** np.arange(k, -1, -1) / (1 - b2 ** (k + 1))
    r = np.sqrt(np.sum(w * w / v))
    du = np.minimum(2 * r, (1 + r) * reach / (np.maximum(s - reach, 0) + eps))
    apart = apart * (1 + lr[k] * wd) + lr[k] * du
  p = np.abs(golden[f"{run}/params/{key}"].astype(np.float64))
  return PARAM_REL * steps_of(run) * p + apart


def unpack(packed: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
  """The golden arrays (per-leaf values stored concatenated over the leaves,
  in the order of `keys`) with one entry per leaf added."""
  out = dict(packed)
  bounds = packed["sample_offsets"]
  per_leaf = ("grad", "params", "teacher_params")
  for i, key in enumerate(packed["keys"]):
    cut = slice(bounds[i], bounds[i + 1])
    out[f"samples/{key}"] = packed["samples"][cut]
    for run in RUNS:
      for part in per_leaf:
        if f"{run}/{part}" in packed:
          out[f"{run}/{part}/{key}"] = packed[f"{run}/{part}"][..., cut]
      for part in ("grad_max", "nudge/grad"):
        if f"{run}/{part}" in packed:
          out[f"{run}/{part}/{key}"] = packed[f"{run}/{part}"][:, i]
      if f"{run}/kernels/grad" in packed:
        out[f"{run}/kernels/grad/{key}"] = packed[f"{run}/kernels/grad"][i]
  return out


def load(path: str = OUT) -> Dict[str, np.ndarray]:
  """The golden file, unpacked (`unpack`)."""
  with np.load(path) as f:
    return unpack({k: f[k] for k in f.files})


def judge(golden, port: Mapping[str, Any], runs=RUNS, card: bool = False):
  """Holds the port's numbers (`run_port`) to the JAX numbers (`load`).
  Returns (a record of the largest errors over their limits, a list of
  failures)."""
  failures, record = [], {}
  for run in runs:
    got = port[run]
    r = record[run] = {}
    worst_scalar = 0.0
    for k in range(steps_of(run)):
      for sname, value in got["scalars"][k].items():
        want = float(golden[f"{run}/scalar/{sname}"][k])
        limit = scalar_limit(golden, run, sname, k, card)
        over = abs(value - want) / max(limit, 1e-30)
        worst_scalar = max(worst_scalar, over)
        if over > 1:
          failures.append(f"{run} step {k} {sname}: {value} vs {want}")
    r["scalars_over_limit"] = worst_scalar
    worst_grad, worst_param = 0.0, 0.0
    for key in golden["keys"]:
      idx = golden[f"samples/{key}"]
      limit = grad_limit(golden, run, key, 0, card)
      grads = np.asarray(got["grads"][key], np.float64).ravel()
      want = golden[f"{run}/grad/{key}"][0].astype(np.float64)
      over = max(float(np.max(np.abs(grads[idx] - want))),
                 abs(float(np.max(np.abs(grads)))
                     - float(golden[f"{run}/grad_max/{key}"][0]))) / limit
      worst_grad = max(worst_grad, over)
      if over > 1:
        failures.append(f"{run} gradient {key}: {over} of its limit")
      plimit = param_limit(golden, run, key, card)
      for part in ("params", "teacher_params"):
        if part not in got:
          continue
        params = np.asarray(got[part][key], np.float64).ravel()[idx]
        apart = np.abs(params - golden[f"{run}/{part}/{key}"])
        # A zero limit (a zero parameter that no step moves) admits no move.
        pover = float(np.max(np.where(
            plimit > 0, apart / np.where(plimit > 0, plimit, 1.0),
            np.where(apart > 0, np.inf, 0.0))))
        worst_param = max(worst_param, pover)
        if pover > 1:
          failures.append(f"{run} {part} {key}: {pover} of the limit")
    r.update(grads_over_limit=worst_grad, params_over_limit=worst_param,
             loss=got["scalars"][0]["loss"],
             golden_loss=float(golden[f"{run}/scalar/loss"][0]))
  return record, failures


@contextlib.contextmanager
def patched(module, **values):
  """Sets module attributes for the duration."""
  old = {k: getattr(module, k) for k in values}
  for k, v in values.items():
    setattr(module, k, v)
  try:
    yield
  finally:
    for k, v in old.items():
      setattr(module, k, v)


@contextlib.contextmanager
def jax_draws(golden):
  """The port's permutation and bootstrap draws replaced by JAX's."""
  import torch

  from tapnet_tpu_torch.data import augmentations
  from tapnet_tpu_torch.models import tapir
  from tapnet_tpu_torch.training import bootstrap

  t = lambda name: torch.from_numpy(np.array(golden[name]))
  view = (t("bootstrap/draw/scale"), t("bootstrap/draw/tx"),
          t("bootstrap/draw/ty"))
  color = {k: t(f"bootstrap/draw/color/{k}") for k in
           ("brightness", "saturation", "hue", "contrast", "augment", "drop")}
  with patched(tapir, _draw_permutation=lambda gen, n: t("permuted/permutation")), \
       patched(bootstrap, _sample_queries=lambda *a: t("bootstrap/draw/query_points"),
               _sample_view=lambda *a: view), \
       patched(augmentations, color_draws=lambda *a: color):
    yield


@contextlib.contextmanager
def perturbed_kernels():
  """Every K1 and K3 output moved by its card limit times a random sign
  (seeded): the witness of what those limits carry (module docstring)."""
  import torch

  from tapnet_tpu_torch.ops import corr_tents, fused_mixer_block
  gen = torch.Generator().manual_seed(WITNESS_SEED)
  sign = lambda y: torch.randint(0, 2, y.shape, generator=gen).to(y) * 2 - 1
  corr, mixer = corr_tents.corr_tent_patches, fused_mixer_block.mixer_block

  def corr_moved(*args, **kwargs):
    y = corr(*args, **kwargs)
    return y + K1_ATOL * sign(y)

  def mixer_moved(*args, **kwargs):
    y = mixer(*args, **kwargs)
    return y + (K3_ATOL + K3_RTOL * y.detach().abs()) * sign(y)

  with patched(corr_tents, corr_tent_patches=corr_moved), \
       patched(fused_mixer_block, mixer_block=mixer_moved):
    yield


def run_port(device, golden, counters=None, runs=RUNS):
  """The port on the golden weights and batches with JAX's draws (from
  `golden`), per run: the first step's gradients (every leaf, Flax layout,
  as the optimizer receives them), the scalars of each step, the parameters
  after them (bootstrap: and the teacher's), and with `counters()` the
  kernels' launches per step."""
  import torch

  from tapnet_tpu_torch.checkpoints import convert
  from tapnet_tpu_torch.models import tapir
  from tapnet_tpu_torch.training import bootstrap, optimizers, trainer

  config = model_config()
  params = golden_params()
  to_dev = lambda d: {k: torch.from_numpy(v).to(device) for k, v in d.items()}
  batch = to_dev(golden_batch())
  tree = lambda d: flatten(convert.state_dict_to_flax(d))
  opt = optimizers.OptimizerConfig(**OPTIMIZER)
  out = {}
  with jax_draws(golden):
    for run in runs:
      before = counters() if counters else None
      grads = []

      def capture(tx, grads=grads):
        """The optimizer, keeping the gradients it receives."""
        update = tx.update
        tx.update = lambda g, s, p: (grads.append(g), update(g, s, p))[1]
        return tx

      if run == "bootstrap":
        tx = capture(optimizers.make_optimizer(
            opt, optimizers.make_lr_schedule(opt, TOTAL_STEPS)))
        student = tapir.TAPIR(config).to(device)
        teacher = tapir.TAPIR(config).to(device)
        state = bootstrap.init_bootstrap_state(student, teacher, params, tx)
        step = bootstrap.make_bootstrap_train_step(
            student, teacher, tx, bootstrap.BootstrapConfig(**BOOTSTRAP))
        data = {"video": torch.from_numpy(golden_batch(VIDEO_SEED)["video"]
                                          ).to(device), "labeled": batch}
        state, s = step(state, data, torch.Generator())
        out[run] = dict(scalars=[{k: float(v) for k, v in s.items()}],
                        teacher_params=tree(state.teacher_params))
      else:
        t = trainer.Trainer(tapir.TAPIR(config), opt, total_steps=TOTAL_STEPS,
                            task=trainer.TaskConfig(train_chunk_size=CHUNK),
                            device=device)
        named = t.load_params(params)
        state = trainer.TrainState(named, capture(t.tx).init(named), 0, {})
        gen = torch.Generator() if run == "permuted" else None
        scalars = []
        for _ in range(STEPS):
          state, s = t.step_fn(state, batch, gen)
          scalars.append({k: float(v) for k, v in s.items()})
        out[run] = dict(scalars=scalars)
      out[run].update(grads=tree(grads[0]), params=tree(state.params))
      if counters:
        after = counters()
        out[run]["launches_per_step"] = {
            k: (v - before.get(k, 0)) / steps_of(run) for k, v in after.items()}
  return out


def witness(golden, runs=RUNS) -> Dict[str, np.ndarray]:
  """The port on the CPU with K1's and K3's outputs moved by their card
  limits (`perturbed_kernels`), against the plain port: per run and step
  each scalar's distance, and per leaf the largest gradient distance of the
  first step. Packed as the golden file's arrays."""
  plain = run_port("cpu", golden, runs=runs)
  with perturbed_kernels():
    moved = run_port("cpu", golden, runs=runs)
  out = {}
  for run in runs:
    for sname in plain[run]["scalars"][0]:
      out[f"{run}/kernels/scalar/{sname}"] = np.array(
          [abs(a[sname] - b[sname]) for a, b in
           zip(plain[run]["scalars"], moved[run]["scalars"])], np.float32)
    out[f"{run}/kernels/grad"] = np.array(
        [np.max(np.abs(plain[run]["grads"][k] - moved[run]["grads"][k]))
         for k in golden["keys"]], np.float32)
  return out


def _bootstrap_draws(key, b, t, h, w):
  """JAX's draws of one bootstrap step (make_bootstrap_train_step)."""
  import jax

  from tapnet_tpu.training import bootstrap as jax_bootstrap
  k_view, k_query, k_color = jax.random.split(key, 3)
  cfg = jax_bootstrap.BootstrapConfig(**BOOTSTRAP)
  out = {"bootstrap/draw/query_points": np.asarray(
      jax_bootstrap._sample_queries(k_query, b, cfg.num_queries, t, h, w))}  # pylint: disable=protected-access
  scale, tx, ty = jax_bootstrap._sample_view(k_view, b, h, w, cfg.min_scale)  # pylint: disable=protected-access
  out.update({"bootstrap/draw/scale": np.asarray(scale),
              "bootstrap/draw/tx": np.asarray(tx),
              "bootstrap/draw/ty": np.asarray(ty)})
  ranges = dict(brightness=(-32.0 / 255.0, 32.0 / 255.0),
                saturation=(0.6, 1.4), hue=(-0.2, 0.2), contrast=(0.6, 1.4),
                augment=(0.0, 1.0), drop=(0.0, 1.0))
  draws = {k: [] for k in ranges}
  for video_key in jax.random.split(k_color, b):
    keys = jax.random.split(video_key, 7)
    for i, (name, (lo, hi)) in enumerate(ranges.items()):
      draws[name].append(float(jax.random.uniform(keys[i], (), minval=lo,
                                                   maxval=hi)))
  for name, values in draws.items():
    out[f"bootstrap/draw/color/{name}"] = np.array(values, np.float32)
  return out


def jax_training(runs=RUNS) -> Dict[str, np.ndarray]:
  """The JAX package's numbers for the golden weights and batches, in the
  file's packed layout (module docstring)."""
  import jax

  jax.config.update("jax_platforms", "cpu")
  import jax.numpy as jnp
  import optax

  from tapnet_tpu.models import tapir
  from tapnet_tpu.training import bootstrap, optimizers, trainer

  model = tapir.TAPIR(config=tapir.bootstapir_config(**CONFIG))
  params = jax.tree_util.tree_map(jnp.asarray, golden_params())
  batch = {k: jnp.asarray(v) for k, v in golden_batch().items()}
  opt = optimizers.OptimizerConfig(**OPTIMIZER)
  schedule = optimizers.make_lr_schedule(opt, TOTAL_STEPS)
  task = trainer.TaskConfig(train_chunk_size=CHUNK)
  out: Dict[str, np.ndarray] = {
      "lr": np.array([float(schedule(k)) for k in range(STEPS)], np.float32)}
  keys = sorted(flatten(golden_params()))
  out["keys"] = np.array(keys)
  samples = None

  def record(run, grads, scalars, after, teacher=None):
    nonlocal samples
    if samples is None:
      rng = np.random.RandomState(1)
      samples = []
      for key in keys:
        n = grads[0][key].size
        if n <= N_RANDOM + N_TOP:
          samples.append(np.arange(n))
        else:
          top = np.argsort(-np.abs(grads[0][key].ravel()))[:N_TOP]
          rand = rng.choice(n, N_RANDOM, replace=False)
          samples.append(np.unique(np.concatenate([top, rand])))
      out["samples"] = np.concatenate(samples).astype(np.int32)
      out["sample_offsets"] = np.cumsum([0] + [len(i) for i in samples]
                                        ).astype(np.int32)
    pick = lambda leaves: np.concatenate(
        [leaves[key].ravel()[idx] for key, idx in zip(keys, samples)])
    for sname in scalars[0]:
      out[f"{run}/scalar/{sname}"] = np.array([s[sname] for s in scalars],
                                              np.float32)
    out[f"{run}/global_max"] = np.array(
        [max(float(np.abs(v).max()) for v in g.values()) for g in grads],
        np.float32)
    out[f"{run}/grad"] = np.stack([pick(g) for g in grads]).astype(np.float32)
    out[f"{run}/grad_max"] = np.array(
        [[np.abs(g[key]).max() for key in keys] for g in grads], np.float32)
    out[f"{run}/params"] = pick(after).astype(np.float32)
    if teacher is not None:
      out[f"{run}/teacher_params"] = pick(teacher).astype(np.float32)

  host = lambda tree: flatten(jax.tree_util.tree_map(np.asarray, tree))
  nudge_rng = np.random.RandomState(NUDGE_SEED)

  def nudged(video):
    sign = nudge_rng.randint(0, 2, video.shape) * 2 - 1
    return jnp.asarray(np.asarray(video) * (1 + NUDGE_REL * sign)
                       ).astype(jnp.float32)

  def record_nudge(run, clean, moved):
    """JAX's own distance under the nudge: per step, each scalar's and
    each leaf's largest gradient difference."""
    (g0, s0), (g1, s1) = clean, moved
    for sname in s0[0]:
      out[f"{run}/nudge/scalar/{sname}"] = np.array(
          [abs(a[sname] - b[sname]) for a, b in zip(s0, s1)], np.float32)
    out[f"{run}/nudge/grad"] = np.array(
        [[np.abs(a[key] - b[key]).max() for key in keys]
         for a, b in zip(g0, g1)], np.float32)

  for run in runs:
    if run == "bootstrap":
      b, t, h, w = BATCH, FRAMES, SIZE, SIZE
      key = jax.random.PRNGKey(BOOTSTRAP_KEY)
      out.update(_bootstrap_draws(key, b, t, h, w))

      def capture_grads():
        return optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g, s, p=None: (g, g))

      tx = optax.chain(capture_grads(), optimizers.make_optimizer(opt, schedule))
      step_fn = jax.jit(bootstrap.make_bootstrap_train_step(
          model, tx, bootstrap.BootstrapConfig(**BOOTSTRAP)))
      data = {"video": jnp.asarray(golden_batch(VIDEO_SEED)["video"]),
              "labeled": batch}
      moved = {"video": nudged(data["video"]),
               "labeled": dict(batch, video=nudged(batch["video"]))}
      results = []
      for batch_ in (data, moved):
        state, s = step_fn(bootstrap.init_bootstrap_state(params, tx), batch_,
                           key)
        results.append(([host(state.opt_state[0])],
                        [{k: float(v) for k, v in s.items()}]))
        if batch_ is data:
          clean_state = state
      record(run, *results[0], host(clean_state.params),
             host(clean_state.teacher_params))
      record_nudge(run, *results)
      continue
    permuted = run == "permuted"
    rng = jax.random.PRNGKey(PERMUTATION_KEY) if permuted else None
    if permuted:
      drawn = []
      permutation = jax.random.permutation

      def spy(*args, **kwargs):
        value = permutation(*args, **kwargs)
        drawn.append(np.asarray(value))
        return value

      jax.random.permutation = spy
      try:
        model.apply({"params": params}, batch["video"], batch["query_points"],
                    query_chunk_size=CHUNK, is_training=True,
                    rngs={"permutation": rng})
      finally:
        jax.random.permutation = permutation
      assert len(drawn) == 1, len(drawn)
      out["permuted/permutation"] = drawn[0].astype(np.int64)

    def builder(m, task_, permuted=permuted):
      if permuted:
        return trainer.tapir_loss_builder(m, task_)

      def loss_fn(p, model_state, batch_, rng_):
        del rng_
        output = m.apply({"params": p}, batch_["video"],
                         batch_["query_points"],
                         query_chunk_size=task_.train_chunk_size,
                         is_training=True)
        loss, scalars = trainer.compute_tapir_loss(output, batch_, task_)
        return loss, (scalars, model_state)

      return loss_fn

    loss_fn = builder(model, task)
    tx = optimizers.make_optimizer(opt, schedule)
    train_step = trainer.make_train_step(model, tx, task, builder)

    @jax.jit
    def step_fn(state, batch_, loss_fn=loss_fn, train_step=train_step,
                rng=rng):
      grads = jax.grad(lambda p: loss_fn(p, {}, batch_, rng)[0])(state.params)
      return train_step(state, batch_, rng) + (grads,)

    results = []
    for batch_ in (batch, dict(batch, video=nudged(batch["video"]))):
      state = trainer.TrainState(params, tx.init(params),
                                 jnp.zeros((), jnp.int32), {})
      grads, scalars = [], []
      for _ in range(STEPS):
        state, s, g = step_fn(state, batch_)
        grads.append(host(g))
        scalars.append({k: float(v) for k, v in s.items()})
      results.append((grads, scalars))
      if batch_ is batch:
        after = host(state.params)
    record(run, *results[0], after)
    record_nudge(run, *results)
  return out


def main():
  out = jax_training()
  for run in RUNS:
    print(run, "loss", out[f"{run}/scalar/loss"])
  out.update(witness(unpack(out)))
  np.savez_compressed(OUT, **out)
  print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
  main()

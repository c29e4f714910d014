"""Writes the JAX package's TAPNext training numbers for the PyTorch port,
and holds the port's to them.

The JAX package on the CPU, with the Pallas scan kernel in interpret mode
(`ops/scan.FORCE_INTERPRET`, forward and backward), trains a small TAPNext
(CONFIG: width 64, depth 2, 2 heads, 32x32, 8x8 patches) on one batch of 2
clips of 4 frames with 8 queries, for both losses of
`training/trainer.py`: `tapnext_loss_builder` ("full") and
`tapnext_chunked_loss_builder(chunk_size=2)` ("chunked"), 3 steps of
`make_optimizer` (warmup 1, weight decay 0.1, max_norm 1). The weights
(tools/tapnext_weights.py, seed 0, numpy) and the batch (`golden_batch`,
numpy seed 0) are rebuilt from their seeds on either side, so the file
(tests/data/tapnext_train_golden.npz) holds only results: per step the loss,
the scalars, the gradient norm and per parameter leaf its largest |g|, the
learning rate of each step, and at a fixed sample of each leaf's elements
(all of a small leaf; else 48 at random and the 8 largest |g| of the full
loss's first step) the gradients of each step and the parameters after the
third.

`run_port` runs the same steps through the port's `Trainer` (on the card or
the CPU) and `judge` holds them to the file, within these limits:

  * loss and every scalar, per step: 1e-5 relative (float32 sums in other
    orders through two layers; the port on the CPU is within 3e-7);
  * every gradient leaf, first step: 1e-4 * max|g_leaf| + 1e-7 * G, G the
    largest |g| of the model. The second term is float32 noise on gradients
    that vanish exactly (the attention key bias: softmax ignores a constant
    added to a row of scores), some 3e-8 at G = 1.8 on the CPU;
  * the parameters after 3 steps: 1e-6 * |p| (a float32 rounding per step)
    plus what the gradient limit allows Adam to move, derived per element:
    with every gradient within its limit d (clipping by the global norm
    scales it by max_norm / n, and n is held within 1e-5), Adam's bias-
    corrected first moment moves by at most D = max_i d_i (its weights sum
    to 1) and so does s = sqrt(v_hat) (a weighted 2-norm), while
    |m_hat| <= R * s with R = sqrt(sum_i w_i^2 / v_i) (Cauchy-Schwarz over
    the two moments' weights; 1.0019 at step 3). So an update moves by at
    most min(2 R, (1 + R) D / (max(s - D, 0) + eps)), and a parameter by
    that times the step's learning rate (times 1 + lr * wd for the decay of
    a parameter already apart). An element whose gradient lies within D of
    zero may thus move by up to 2 R * lr a step: Adam's first updates are
    near sign(g). s and D come from the JAX gradients in the file.

  JAX_PLATFORMS=cpu python tools/make_tapnext_train_golden.py
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace
from typing import Any, Dict, Mapping

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests/data/tapnext_train_golden.npz")
sys.path.insert(0, REPO)
from tools.tapnext_weights import seeded_tapnext_params  # noqa: E402

CONFIG = dict(width=64, depth=2, mlp_dim=128, num_heads=2,
              patch_size=(1, 8, 8), image_size=(32, 32))
BATCH, FRAMES, QUERIES, CHUNK, STEPS = 2, 4, 8, 2, 3
OPTIMIZER = dict(base_lr=1e-3, warmup_steps=1, weight_decay=0.1, max_norm=1.0)
TOTAL_STEPS = 10
WEIGHT_SEED, BATCH_SEED = 0, 0
BUILDERS = ("full", "chunked")
N_RANDOM, N_TOP = 48, 8
LOSS_REL, NORM_REL = 1e-5, 1e-5
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-7
PARAM_REL = 1e-6


def golden_params() -> Dict[str, Any]:
  """The Flax-layout weights, rebuilt from WEIGHT_SEED (numpy)."""
  config = SimpleNamespace(lru_width=None, posemb="learn", posemb_full="learn",
                           bidirectional_ssm=False, query_scale=1, **CONFIG)
  return seeded_tapnext_params(config, WEIGHT_SEED)


def golden_batch() -> Dict[str, np.ndarray]:
  """The training batch, rebuilt from BATCH_SEED (numpy): 8-bit frames in
  [-1, 1], query points (t, y, x) on the frames, targets (x, y) partly off
  the frame, 30% occluded."""
  rng = np.random.RandomState(BATCH_SEED)
  size = CONFIG["image_size"][0]
  video = rng.randint(0, 256, (BATCH, FRAMES, size, size, 3))
  query_points = np.stack([
      rng.randint(0, FRAMES, (BATCH, QUERIES)),
      rng.uniform(0, size, (BATCH, QUERIES)),
      rng.uniform(0, size, (BATCH, QUERIES))], -1)
  return {
      "video": (video / 127.5 - 1.0).astype(np.float32),
      "query_points": query_points.astype(np.float32),
      "target_points": rng.uniform(-2, size + 2, (BATCH, QUERIES, FRAMES, 2)
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


def grad_limit(grad_max, global_max):
  """The gradient limit of a leaf: 1e-4 * max|g_leaf| + 1e-7 * G."""
  return GRAD_REL * np.asarray(grad_max, np.float64) + GRAD_FLOOR * np.asarray(
      global_max, np.float64)


def param_limit(golden, name: str, key: str) -> np.ndarray:
  """Per sampled element of leaf `key`, how far the port's parameter after
  the last step may lie from JAX's (see the module docstring)."""
  opt = OPTIMIZER
  b1, b2, eps = 0.9, 0.95, 1e-8
  lr = golden["lr"].astype(np.float64)
  g = golden[f"{name}/grad/{key}"].astype(np.float64)  # [STEPS, n]
  norm = golden[f"{name}/grad_norm"].astype(np.float64)
  d = grad_limit(golden[f"{name}/grad_max/{key}"],
                 golden[f"{name}/global_max"])[:, None]
  clip = np.where(norm > opt["max_norm"], opt["max_norm"] / norm, 1.0)[:, None]
  gc = g * clip
  dgc = clip * (d + np.abs(g) * NORM_REL)
  decayed = key.rsplit("/", 1)[-1] not in ("bias", "scale", "offset")
  mu = np.zeros_like(gc[0])
  nu = np.zeros_like(gc[0])
  reach = np.zeros_like(gc[0])
  apart = np.zeros_like(gc[0])
  for k in range(STEPS):
    mu = b1 * mu + (1 - b1) * gc[k]
    nu = b2 * nu + (1 - b2) * gc[k] ** 2
    s = np.sqrt(nu / (1 - b2 ** (k + 1)))
    reach = np.maximum(reach, dgc[k])
    w = (1 - b1) * b1 ** np.arange(k, -1, -1) / (1 - b1 ** (k + 1))
    v = (1 - b2) * b2 ** np.arange(k, -1, -1) / (1 - b2 ** (k + 1))
    r = np.sqrt(np.sum(w * w / v))
    du = np.minimum(2 * r, (1 + r) * reach / (np.maximum(s - reach, 0) + eps))
    wd = opt["weight_decay"] if decayed else 0.0
    apart = apart * (1 + lr[k] * wd) + lr[k] * du
  p = np.abs(golden[f"{name}/params/{key}"].astype(np.float64))
  return PARAM_REL * p + apart


def unpack(packed: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
  """The golden arrays (per-leaf values stored concatenated over the leaves,
  in the order of `keys`) with one entry per leaf added: `samples/<key>`,
  `<loss>/grad/<key>` [STEPS, n], `<loss>/grad_max/<key>` [STEPS] and
  `<loss>/params/<key>` [n]."""
  out = dict(packed)
  bounds = packed["sample_offsets"]
  for i, key in enumerate(packed["keys"]):
    cut = slice(bounds[i], bounds[i + 1])
    out[f"samples/{key}"] = packed["samples"][cut]
    for name in BUILDERS:
      if f"{name}/grad" in packed:
        out[f"{name}/grad/{key}"] = packed[f"{name}/grad"][:, cut]
        out[f"{name}/grad_max/{key}"] = packed[f"{name}/grad_max"][:, i]
        out[f"{name}/params/{key}"] = packed[f"{name}/params"][cut]
  return out


def load(path: str = OUT) -> Dict[str, np.ndarray]:
  """The golden file, unpacked (`unpack`)."""
  with np.load(path) as f:
    return unpack({k: f[k] for k in f.files})


def judge(golden, port: Mapping[str, Any], builders=BUILDERS):
  """Holds the port's numbers (`run_port`) to the JAX numbers (`load`, or
  `unpack(jax_training(...))`). Returns (a
  record of the largest errors over their limits, a list of failures)."""
  failures, record = [], {}
  for name in builders:
    got = port[name]
    r = record[name] = {}
    worst_scalar = 0.0
    for k in range(STEPS):
      for sname, value in got["scalars"][k].items():
        want = float(golden[f"{name}/scalar/{sname}"][k])
        over = abs(value - want) / (
            (NORM_REL if sname == "gradient_norm" else LOSS_REL) * abs(want))
        worst_scalar = max(worst_scalar, over)
        if over > 1:
          failures.append(f"{name} step {k} {sname}: {value} vs {want}")
    r["scalars_over_limit"] = worst_scalar
    worst_grad, worst_param, near_zero = 0.0, 0.0, 0
    for key in golden["keys"]:
      idx = golden[f"samples/{key}"]
      limit = grad_limit(golden[f"{name}/grad_max/{key}"][0],
                         golden[f"{name}/global_max"][0])
      grads = np.asarray(got["grads"][key], np.float64).ravel()
      want = golden[f"{name}/grad/{key}"][0].astype(np.float64)
      over = max(float(np.max(np.abs(grads[idx] - want))),
                 abs(float(np.max(np.abs(grads)))
                     - float(golden[f"{name}/grad_max/{key}"][0]))) / limit
      worst_grad = max(worst_grad, over)
      if over > 1:
        failures.append(f"{name} gradient {key}: {over} of its limit")
      plimit = param_limit(golden, name, key)
      params = np.asarray(got["params"][key], np.float64).ravel()[idx]
      apart = np.abs(params - golden[f"{name}/params/{key}"])
      pover = float(np.max(apart / plimit))
      near_zero += int(np.sum(apart > PARAM_REL * np.abs(params)))
      worst_param = max(worst_param, pover)
      if pover > 1:
        failures.append(f"{name} parameters {key}: {pover} of the limit")
    r.update(grads_over_limit=worst_grad, params_over_limit=worst_param,
             params_beyond_relative_part=near_zero,
             loss=got["scalars"][0]["loss"],
             golden_loss=float(golden[f"{name}/scalar/loss"][0]))
  return record, failures


def _builder(trainer, name):
  if name == "full":
    return trainer.tapnext_loss_builder
  return lambda m, t: trainer.tapnext_chunked_loss_builder(m, t, CHUNK)


def run_port(device, counters=None, params=None, batch=None,
             builders=BUILDERS):
  """The port's `Trainer` on the golden weights and batch (or the given
  Flax-layout `params` and numpy `batch`), for each loss: the first step's
  gradients (every leaf, Flax layout), the scalars of each of STEPS steps of
  `Trainer.step_fn`, and the parameters after them. `counters()`, if given,
  is read around each loss's steps (the kernels' launch counts)."""
  import torch

  from tapnet_tpu_torch.checkpoints import convert
  from tapnet_tpu_torch.models import ssm_vit, tapnext
  from tapnet_tpu_torch.training import optimizers, trainer

  config = ssm_vit.SsmVitConfig(**CONFIG)
  params = golden_params() if params is None else params
  batch = {k: torch.from_numpy(v).to(device)
           for k, v in (golden_batch() if batch is None else batch).items()}
  tree = lambda d: flatten(convert.state_dict_to_tapnext(
      d, config.num_heads, config.patch_size))
  out = {}
  for name in builders:
    builder = _builder(trainer, name)
    t = trainer.Trainer(tapnext.TAPNextTracker(config),
                        optimizers.OptimizerConfig(**OPTIMIZER),
                        total_steps=TOTAL_STEPS, loss_builder=builder,
                        device=device)
    state = t.init_state()
    convert.load_tapnext_params(t.model, params)
    _, _, grads = trainer.loss_and_grads(builder(t.model, t.task),
                                         state.params, batch)
    grads = tree(grads)
    launches = counters() if counters else None
    scalars = []
    for _ in range(STEPS):
      state, s = t.step_fn(state, batch)
      scalars.append({k: float(v) for k, v in s.items()})
    out[name] = dict(grads=grads, scalars=scalars, params=tree(state.params),
                     launches=(None if counters is None else
                               {k: v - launches.get(k, 0)
                                for k, v in counters().items()}))
  return out


def jax_training(params, batch, builders=BUILDERS, every_element=False):
  """The JAX package's numbers for `params` (Flax layout) and `batch`
  (numpy), in the file's packed layout: for each loss, STEPS steps of
  `make_train_step` (jitted) and the gradients at each step's parameters,
  with the Pallas scan in interpret mode. Samples every element of each
  leaf if `every_element`, else as the module docstring says."""
  import jax

  jax.config.update("jax_platforms", "cpu")
  import jax.numpy as jnp

  from tapnet_tpu.models import ssm_vit, tapnext
  from tapnet_tpu.ops import scan
  from tapnet_tpu.training import optimizers, trainer

  interpret = scan.FORCE_INTERPRET
  scan.FORCE_INTERPRET = True
  try:
    model = tapnext.TAPNextTracker(config=ssm_vit.SsmVitConfig(**CONFIG))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    params0 = jax.tree_util.tree_map(jnp.asarray, params)
    opt = optimizers.OptimizerConfig(**OPTIMIZER)
    schedule = optimizers.make_lr_schedule(opt, TOTAL_STEPS)
    tx = optimizers.make_optimizer(opt, schedule)
    out: Dict[str, np.ndarray] = {
        "lr": np.array([float(schedule(k)) for k in range(STEPS)],
                       np.float32)}
    keys = sorted(flatten(params))
    out["keys"] = np.array(keys)
    samples = None
    for name in builders:
      builder = _builder(trainer, name)
      loss_fn = builder(model, trainer.TaskConfig())
      train_step = trainer.make_train_step(model, tx, trainer.TaskConfig(),
                                           builder)

      @jax.jit
      def step_fn(state):
        # The step's gradients beside the step (one compilation: XLA shares
        # the two backward passes).
        grads = jax.grad(lambda p: loss_fn(p, {}, batch, None)[0])(
            state.params)
        return train_step(state, batch, None) + (grads,)

      state = trainer.TrainState(params0, tx.init(params0),
                                 jnp.zeros((), jnp.int32), {})
      grads, scalars = [], []
      for _ in range(STEPS):
        state, s, g = step_fn(state)
        grads.append(flatten(jax.tree_util.tree_map(np.asarray, g)))
        scalars.append({k: float(v) for k, v in s.items()})
      after = flatten(jax.tree_util.tree_map(np.asarray, state.params))
      if samples is None:
        rng = np.random.RandomState(1)
        samples = []
        for key in keys:
          n = grads[0][key].size
          if every_element or n <= N_RANDOM + N_TOP:
            samples.append(np.arange(n))
          else:
            top = np.argsort(-np.abs(grads[0][key].ravel()))[:N_TOP]
            rand = rng.choice(n, N_RANDOM, replace=False)
            samples.append(np.unique(np.concatenate([top, rand])))
        out["samples"] = np.concatenate(samples).astype(np.int32)
        out["sample_offsets"] = np.cumsum(
            [0] + [len(i) for i in samples]).astype(np.int32)
      for sname in scalars[0]:
        out[f"{name}/scalar/{sname}"] = np.array(
            [s[sname] for s in scalars], np.float32)
      out[f"{name}/grad_norm"] = out[f"{name}/scalar/gradient_norm"]
      out[f"{name}/global_max"] = np.array(
          [max(float(np.abs(v).max()) for v in g.values()) for g in grads],
          np.float32)
      pick = lambda leaves: np.concatenate(
          [leaves[key].ravel()[idx] for key, idx in zip(keys, samples)])
      out[f"{name}/grad"] = np.stack([pick(g) for g in grads]).astype(
          np.float32)
      out[f"{name}/grad_max"] = np.array(
          [[np.abs(g[key]).max() for key in keys] for g in grads], np.float32)
      out[f"{name}/params"] = pick(after).astype(np.float32)
  finally:
    scan.FORCE_INTERPRET = interpret
  return out


def main():
  out = jax_training(golden_params(), golden_batch())
  for name in BUILDERS:
    print(name, "loss", out[f"{name}/scalar/loss"], "gradient_norm",
          out[f"{name}/grad_norm"])
  np.savez_compressed(OUT, **out)
  print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
  main()

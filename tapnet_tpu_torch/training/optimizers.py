"""Optimizer and learning-rate schedule for training (port of
tapnet_tpu/training/optimizers.py).

`make_optimizer` mirrors the JAX package's optax chain step by step, on a
dict of parameters keyed by the port's names:

  apply_if_finite(chain(clip_by_global_norm, scale_by_adam,
                        add_decayed_weights(mask), scale_by_schedule,
                        scale(-1), masked(scale(fast), fast_mask)))

with optax's arithmetic: Adam's moments as (1 - b) * g + b * m, its bias
correction 1 - b^count in float32, eps outside the square root; the
schedule read at the count before its increment (with init_value 0 the first
update is exactly zero); a non-finite gradient skipped (zero update, state
kept) and counted, unless more than `max_consecutive_nonfinite` came in a
row. The masks are decided on the Flax path of each parameter
(`checkpoints.convert.tapnext_flax_path`), as the JAX package decides them
on its tree: weight decay skips leaves named bias, scale or offset, and so
does decay the block-diagonal and convolution `b`, `a_param`, the tokens
and the position embeddings.

The state is a plain dict of tensors and ints; `apply_updates` adds the
updates to the parameters in place (the port keeps one copy of them). The
SGD chain (`optimizer="sgd"`) is not ported: no experiment uses it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Tuple

import torch

from tapnet_tpu_torch.checkpoints.convert import tapnext_flax_path

Params = Mapping[str, torch.Tensor]
Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
  """The JAX package's defaults (reference configs/tapir_config.py:53-96)."""

  optimizer: str = "adam"
  base_lr: float = 1e-3
  max_norm: float = -1.0  # <= 0 disables clipping
  weight_decay: float = 1e-1
  adam_b1: float = 0.9
  adam_b2: float = 0.95
  adam_eps: float = 1e-8
  sgd_momentum: float = 0.9
  sgd_nesterov: bool = False
  schedule_type: str = "cosine"
  warmup_steps: int = 1000
  init_value: float = 0.0
  end_value: float = 0.0
  constant_fraction: float = 0.5
  max_consecutive_nonfinite: int = 5
  # Parameters whose Flax path has a component containing any of these
  # substrings get their final update multiplied by `fast_lr_multiplier`.
  fast_variables: tuple = ()
  fast_lr_multiplier: float = 10.0


def _f32(value) -> float:
  """A value rounded to float32, as optax computes its schedules."""
  return float(torch.tensor(value, dtype=torch.float32))


def _polynomial(init_value, end_value, transition_steps, count):
  """optax.linear_schedule (polynomial, power 1), in float32."""
  if transition_steps <= 0:
    return _f32(init_value)
  count = torch.clamp(torch.tensor(count, dtype=torch.float32), 0,
                      transition_steps)
  frac = 1 - count / transition_steps
  return float(_f32(init_value - end_value) * frac + end_value)


def _cosine(init_value, decay_steps, alpha, count):
  """optax.cosine_decay_schedule (exponent 1), in float32."""
  count = torch.minimum(torch.tensor(float(count), dtype=torch.float32),
                        torch.tensor(float(decay_steps), dtype=torch.float32))
  cosine = 0.5 * (1 + torch.cos(math.pi * count / float(decay_steps)))
  decayed = (1 - alpha) * cosine + alpha
  return float(torch.tensor(init_value, dtype=torch.float32) * decayed)


def make_lr_schedule(config: OptimizerConfig, total_steps: int) -> Schedule:
  """Cosine with warmup (optax.warmup_cosine_decay_schedule) or constant
  then cosine (optax.join_schedules), as step -> learning rate."""
  if config.schedule_type == "cosine":
    warmup = config.warmup_steps
    decay_steps = max(total_steps, warmup + 1)
    alpha = (0.0 if config.base_lr == 0.0
             else config.end_value / config.base_lr)

    def schedule(step: int) -> float:
      if step < warmup:
        return _polynomial(config.init_value, config.base_lr, warmup, step)
      return _cosine(config.base_lr, decay_steps - warmup, alpha,
                     step - warmup)

    return schedule
  if config.schedule_type == "constant_cosine":
    constant_steps = int(config.constant_fraction * total_steps)
    alpha = config.end_value / config.base_lr

    def schedule(step: int) -> float:
      if step < constant_steps:
        return _f32(config.base_lr)
      return _cosine(config.base_lr, total_steps - constant_steps, alpha,
                     step - constant_steps)

    return schedule
  raise ValueError(f"Unknown schedule: {config.schedule_type}")


def weight_decay_mask(params: Params) -> Dict[str, bool]:
  """True where weight decay applies: every parameter whose Flax leaf name is
  not bias, scale or offset."""
  no_decay_names = ("bias", "scale", "offset")
  return {name: tapnext_flax_path(name)[-1] not in no_decay_names
          for name in params}


def fast_variables_mask(params: Params, fast_variables) -> Dict[str, bool]:
  """True where a component of the Flax path contains a fast-variable
  substring."""
  return {name: any(s in part for s in fast_variables
                    for part in tapnext_flax_path(name))
          for name in params}


def global_norm(tensors) -> torch.Tensor:
  """sqrt of the sum of squares of every element (optax.global_norm)."""
  return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


class Optimizer:
  """The optax chain of `make_optimizer`, as `init(params)` and
  `update(grads, state, params) -> (updates, state)`."""

  def __init__(self, config: OptimizerConfig, lr_schedule: Schedule):
    if config.optimizer == "sgd":
      raise NotImplementedError(
          "the SGD chain is not ported: no experiment of the port uses it")
    if config.optimizer != "adam":
      raise ValueError(f"Unknown optimizer: {config.optimizer}")
    self.config = config
    self.lr_schedule = lr_schedule

  def init(self, params: Params) -> dict:
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
    return dict(count=0, notfinite_count=0, last_finite=True,
                total_notfinite=0, adam_count=0, mu=zeros(), nu=zeros())

  def _inner(self, grads: Params, state: dict, params: Params):
    cfg = self.config
    updates = dict(grads)
    if cfg.max_norm > 0:
      g_norm = global_norm(updates.values())
      if not bool(g_norm < cfg.max_norm):
        updates = {k: (g / g_norm) * cfg.max_norm for k, g in updates.items()}
    b1, b2 = cfg.adam_b1, cfg.adam_b2
    mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in updates.items()}
    nu = {k: (1 - b2) * g**2 + b2 * state["nu"][k]
          for k, g in updates.items()}
    count = state["adam_count"] + 1
    c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
    c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
    updates = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + cfg.adam_eps)
               for k in updates}
    new = dict(state, mu=mu, nu=nu, adam_count=count)
    if cfg.weight_decay > 0:
      mask = weight_decay_mask(params)
      updates = {k: u + cfg.weight_decay * params[k] if mask[k] else u
                 for k, u in updates.items()}
    step_size = self.lr_schedule(state["count"])
    updates = {k: step_size * u for k, u in updates.items()}
    new["count"] = state["count"] + 1
    updates = {k: -1.0 * u for k, u in updates.items()}
    if cfg.fast_variables:
      fast = fast_variables_mask(params, cfg.fast_variables)
      updates = {k: cfg.fast_lr_multiplier * u if fast[k] else u
                 for k, u in updates.items()}
    return updates, new

  def update(self, grads: Params, state: dict,
             params: Params) -> Tuple[Dict[str, torch.Tensor], dict]:
    """One update (optax.apply_if_finite around the chain)."""
    finite = bool(torch.stack([torch.isfinite(g).all()
                               for g in grads.values()]).all())
    notfinite = 0 if finite else state["notfinite_count"] + 1
    if finite or notfinite > self.config.max_consecutive_nonfinite:
      updates, new = self._inner(grads, state, params)
    else:
      updates = {k: torch.zeros_like(g) for k, g in grads.items()}
      new = dict(state)
    new.update(notfinite_count=notfinite, last_finite=finite,
               total_notfinite=state["total_notfinite"] + (0 if finite else 1))
    return updates, new


def make_optimizer(config: OptimizerConfig,
                   lr_schedule: Schedule) -> Optimizer:
  """The full optimizer chain (see the module docstring)."""
  return Optimizer(config, lr_schedule)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
  """params += updates, in place."""
  for k, p in params.items():
    p.add_(updates[k])

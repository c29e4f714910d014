"""Training step and loop for TAPNext on one device (port of
tapnet_tpu/training/trainer.py).

`make_train_step` computes the loss of a batch, its gradients by autograd
(the RG-LRU scan's through K5b on the card), one update of the optax-like
optimizer (`training.optimizers`) applied to the model's parameters in
place, and the scalars with `gradient_norm`. Two TAPNext losses:

  * `tapnext_loss_builder`: one pass over the whole clip with per-layer
    deep supervision;
  * `tapnext_chunked_loss_builder`: the long-video recipe, the clip run
    through `TAPNextTracker.forward_step` in time chunks with
    `torch.utils.checkpoint` on each chunk. The temporal mixer is exactly
    recurrent and attention per frame, so the chunks give the one pass's
    outputs, and gradients flow back through the carried SSM state (full
    BPTT) with only the chunk-boundary states and one chunk's activations
    alive at a time. The loss covers the final heads only.

`Trainer` owns the model, the optimizer and the loop. It runs on one device:
the CUDA card unless given `device="cpu"`; a mesh (multi-GPU) is ROADMAP
Queue 1 item 9. TAPIR training is not ported (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Mapping, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from tapnet_tpu_torch.checkpoints import convert
from tapnet_tpu_torch.inference import resolve_device
from tapnet_tpu_torch.models import rglru, ssm_vit, tapnext, tapnext_losses
from tapnet_tpu_torch.training import checkpointing, optimizers, telemetry

Batch = Mapping[str, torch.Tensor]

_TAPIR_NOT_PORTED = ("TAPIR training is not ported yet (ROADMAP Queue 1 item "
                     "8); the port trains TAPNext")
_MESH_NOT_PORTED = ("multi-GPU training is not ported yet (ROADMAP Queue 1 "
                    "item 9); the port trains on one device")


class TrainState(NamedTuple):
  # The model's own parameters by name, updated in place by each step.
  params: Dict[str, torch.Tensor]
  opt_state: Any
  step: int
  # Non-parameter variables; TAPNext has none.
  model_state: Any = {}


@dataclasses.dataclass(frozen=True)
class TaskConfig:
  """Supervised point-prediction task settings (the JAX package's; the
  TAPIR losses read them)."""

  train_chunk_size: int = 32
  position_loss_weight: float = 0.05
  expected_dist_thresh: float = 6.0


def tapir_loss_builder(model, task: TaskConfig):
  raise NotImplementedError(_TAPIR_NOT_PORTED)


def contrastive_loss_builder(model, task: TaskConfig, **kwargs):
  raise NotImplementedError(_TAPIR_NOT_PORTED)


def _tapnext_targets(batch: Batch):
  """The batch's (x, y) targets as the model's (y, x), and visibility."""
  return batch["target_points"].flip(-1), 1.0 - batch["occluded"]


def tapnext_loss_builder(model, task: TaskConfig):
  """TAPNext loss: coordinate CE + Huber + visibility, with deep
  supervision. `loss_fn(batch) -> (loss, scalars)`."""
  del task

  def loss_fn(batch: Batch):
    results = model(batch["video"], batch["query_points"])
    return tapnext_losses.tapnext_loss(results, *_tapnext_targets(batch))

  return loss_fn


def tapnext_chunked_loss_builder(model, task: TaskConfig,
                                 chunk_size: int = 128):
  """TAPNext loss over time-chunked forwards (see the module docstring)."""
  del task

  def loss_fn(batch: Batch):
    video, qp = batch["video"], batch["query_points"]
    t = video.shape[1]
    if t % chunk_size:
      raise ValueError(
          f"num_frames {t} must be a multiple of chunk_size {chunk_size}")
    padding = torch.ones(qp.shape[:-1], dtype=torch.bool, device=qp.device)

    def first(frames):
      r = model.forward_step(frames, qp)
      cache = r.state.hidden_state
      return (r.tracks, r.track_logits, r.visible_logits, cache.rg_lru_state,
              cache.conv1d_state)

    def body(frames, lru_state, conv_state, step):
      state = ssm_vit.TAPNextTrackingState(
          step=step, query_points=qp, query_padding=padding,
          hidden_state=rglru.RecurrentBlockCache(lru_state, conv_state))
      r = model.forward_step(frames, state=state)
      cache = r.state.hidden_state
      return (r.tracks, r.track_logits, r.visible_logits, cache.rg_lru_state,
              cache.conv1d_state)

    outs = [torch.utils.checkpoint.checkpoint(
        first, video[:, :chunk_size], use_reentrant=False)]
    for start in range(chunk_size, t, chunk_size):
      outs.append(torch.utils.checkpoint.checkpoint(
          body, video[:, start:start + chunk_size], *outs[-1][3:], start,
          use_reentrant=False))
    # [B, Q, chunk, ...] per chunk -> [B, Q, T, ...].
    joined = [torch.cat([o[i] for o in outs], dim=2) for i in range(3)]
    results = tapnext.TrackerResults(
        tracks=joined[0], track_logits=joined[1], visible_logits=joined[2],
        intermediate_tracks=[], intermediate_track_logits=[],
        intermediate_visible_logits=[])
    return tapnext_losses.tapnext_loss(results, *_tapnext_targets(batch))

  return loss_fn


def loss_and_grads(loss_fn, params: Mapping[str, torch.Tensor], batch: Batch):
  """(loss, scalars, grads by name); an unused parameter's gradient is
  zero."""
  loss, scalars = loss_fn(batch)
  names = list(params)
  grads = torch.autograd.grad(loss, [params[n] for n in names],
                              allow_unused=True)
  grads = {n: torch.zeros_like(params[n]) if g is None else g
           for n, g in zip(names, grads)}
  return loss, scalars, grads


def make_train_step(
    model, tx: optimizers.Optimizer, task: TaskConfig = TaskConfig(),
    loss_builder: Optional[Callable] = None,
) -> Callable[[TrainState, Batch], tuple]:
  """`train_step(state, batch) -> (state, scalars)`: the loss of
  `loss_builder(model, task)`, its gradients, one optimizer update applied
  to the parameters in place, and the loss's scalars with gradient_norm."""
  loss_fn = (loss_builder or tapir_loss_builder)(model, task)

  def train_step(state: TrainState, batch: Batch):
    _, scalars, grads = loss_and_grads(loss_fn, state.params, batch)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    optimizers.apply_updates(state.params, updates)
    scalars = {k: v.detach() for k, v in scalars.items()}
    scalars["gradient_norm"] = optimizers.global_norm(grads.values())
    return (TrainState(state.params, opt_state, state.step + 1,
                       state.model_state), scalars)

  return train_step


class Trainer:
  """Owns the model and optimizer and runs the training loop on one
  device."""

  def __init__(
      self,
      model,
      optimizer_config: optimizers.OptimizerConfig,
      total_steps: int,
      task: TaskConfig = TaskConfig(),
      mesh=None,
      checkpoint_path: Optional[str] = None,
      checkpoint_every: int = 1000,
      loss_builder: Optional[Callable] = None,
      log_path: Optional[str] = None,
      device: Optional[Any] = None,
  ):
    """device: None means the CUDA card (raises without one unless
    device="cpu"). The port draws its initial parameters without a forward
    pass, so it needs no example batch (the JAX Trainer's init_num_frames
    and init_state's example_batch)."""
    if mesh is not None:
      raise NotImplementedError(_MESH_NOT_PORTED)
    if not isinstance(model, tapnext.TAPNextTracker):
      raise NotImplementedError(_TAPIR_NOT_PORTED)
    self.device = resolve_device(device)
    self.model = model.to(self.device)
    self.task = task
    self.loss_builder = loss_builder
    self.lr_schedule = optimizers.make_lr_schedule(optimizer_config,
                                                   total_steps)
    self.tx = optimizers.make_optimizer(optimizer_config, self.lr_schedule)
    self.total_steps = total_steps
    self.checkpoint_path = checkpoint_path
    self.checkpoint_every = checkpoint_every
    self.log_path = (log_path if log_path is not None
                     else telemetry.default_log_path(checkpoint_path))
    self._step_fn = None

  def _flax_tree(self, tensors: Mapping[str, torch.Tensor]):
    cfg = self.model.config
    return convert.state_dict_to_tapnext(tensors, cfg.num_heads,
                                         cfg.patch_size)

  def _from_flax_tree(self, tree) -> Dict[str, torch.Tensor]:
    return {k: v.to(self.device)
            for k, v in convert.tapnext_to_state_dict(tree).items()}

  def init_state(self, seed: int = 42) -> TrainState:
    """Fresh parameters (`models.tapnext.init_tapnext_params` from `seed`)
    loaded into the model, and a fresh optimizer state."""
    tree = tapnext.init_tapnext_params(
        self.model.config, torch.Generator().manual_seed(seed))
    convert.load_tapnext_params(self.model, tree)
    params = dict(self.model.named_parameters())
    return TrainState(params, self.tx.init(params), 0, {})

  def restore_or_init(self) -> TrainState:
    """The state of `checkpoint_path` if it exists, else `init_state`."""
    ckpt = (checkpointing.restore_checkpoint(self.checkpoint_path)
            if self.checkpoint_path else None)
    if ckpt is None:
      return self.init_state()
    convert.load_tapnext_params(self.model, ckpt["params"])
    params = dict(self.model.named_parameters())
    opt_state = dict(ckpt["opt_state"])
    for key in ("mu", "nu"):
      if key in opt_state:
        opt_state[key] = self._from_flax_tree(opt_state[key])
    return TrainState(params, opt_state, int(ckpt["step"]),
                      ckpt.get("model_state", {}))

  def save(self, state: TrainState) -> None:
    """Writes `state` to `checkpoint_path`: parameters and optimizer
    moments as Flax-layout trees."""
    opt_state = dict(state.opt_state)
    for key in ("mu", "nu"):
      if key in opt_state:
        opt_state[key] = self._flax_tree(opt_state[key])
    checkpointing.save_checkpoint(self.checkpoint_path, dict(
        params=self._flax_tree(state.params), opt_state=opt_state,
        step=state.step, model_state=state.model_state))

  @property
  def step_fn(self):
    if self._step_fn is None:
      self._step_fn = make_train_step(self.model, self.tx, self.task,
                                      self.loss_builder)
    return self._step_fn

  def fit(self, state: TrainState, data: Iterator[Batch], num_steps: int,
          log_every: int = 50) -> TrainState:
    """Runs `num_steps` training steps, printing and logging the scalars
    every `log_every` steps and checkpointing every `checkpoint_every`."""
    sink = telemetry.ScalarSink(self.log_path)
    last_t = time.time()
    try:
      for i in range(num_steps):
        batch = {k: v.to(self.device) for k, v in next(data).items()}
        state, scalars = self.step_fn(state, batch)
        step = state.step
        if log_every and (i + 1) % log_every == 0:
          scalars = {k: float(v) for k, v in scalars.items()}
          dt = (time.time() - last_t) / log_every
          last_t = time.time()
          lr = float(self.lr_schedule(step))
          print(f"step {step} loss {scalars['loss']:.4f} "
                f"gnorm {scalars['gradient_norm']:.3f} "
                f"lr {lr:.2e} {dt*1000:.0f} ms/step")
          sink.write(step, dict(scalars, learning_rate=lr,
                                ms_per_step=dt * 1000))
        if (self.checkpoint_path and self.checkpoint_every
            and step % self.checkpoint_every == 0):
          self.save(state)
    finally:
      sink.close()
    return state

"""Training step and loop on one device (port of
tapnet_tpu/training/trainer.py).

`make_train_step` computes the loss of a batch, its gradients by autograd
(through the hand-written kernels' VJPs on the card: `ops._vjp`, and the
RG-LRU scan's K5b), one update of the optax-like optimizer
(`training.optimizers`) applied to the model's parameters in place, and the
scalars with `gradient_norm`. The losses:

  * `tapir_loss_builder` (TAPIR, causal TAPIR, BootsTAPIR, TAP-Net): the
    TAP loss (`compute_tapir_loss`) of the training forward, whose query
    chunks run in an order drawn from the step's `torch.Generator` (TAP-Net
    draws none; without an uncertainty output its prob_loss is 0);
  * `contrastive_loss_builder` (TAP-Net): the original TAP-Net's
    cost-volume loss, the log-softmax mass of each query's cost volume at
    its ground-truth track on the visible frames;
  * `tapnext_loss_builder`: TAPNext, one pass over the whole clip with
    per-layer deep supervision;
  * `tapnext_chunked_loss_builder`: the long-video recipe, the clip run
    through `TAPNextTracker.forward_step` in time chunks with
    `torch.utils.checkpoint` on each chunk. The temporal mixer is exactly
    recurrent and attention per frame, so the chunks give the one pass's
    outputs, and gradients flow back through the carried SSM state (full
    BPTT) with only the chunk-boundary states and one chunk's activations
    alive at a time. The loss covers the final heads only.

`Trainer` owns the model, the optimizer and the loop. It runs on the CUDA
card unless given `device="cpu"`. With a `mesh` (`parallel.mesh.Mesh`) it
runs one rank of a data- and query-parallel run whose step is the
single-device step on the global batch, as GSPMD's is in the JAX package:

  * the state is replicated (the initial parameters, or what a resume read,
    broadcast from rank 0);
  * each rank takes its part of every global batch (`mesh.shard_batch`:
    clips over "data", queries over "model");
  * the draws (TAPIR's query order) are made for the global batch with the
    same generator on every rank;
  * each rank's loss is its share of the global loss (the mean over ranks is
    the loss): a uniform mean over equal parts needs nothing more, a
    normaliser that depends on the data (TAPNext's mask counts) is summed
    over the ranks (`tapnext_losses.tapnext_loss(mesh=...)`);
  * the gradients are averaged over every rank before the optimizer (and
    so before the gradient norm, the clip and the non-finite skip), so every
    rank takes the same step;
  * TAP-Net's BatchNorm takes the global batch's statistics over "data"
    (`tsm_resnet.sync_batch_norm`);
  * the scalars are the global means; only rank 0 prints, writes the JSONL
    and the checkpoint, and evaluates.

TAPIR's queries split over "model" run the global query chunks cut to each
rank's queries (`TAPIR.forward(query_shard=...)`), so the refinement keeps
its gradient for the same queries as on one device. TAPNext's query tokens
attend to each other, so splitting its forward over queries would change the
function: its "model" ranks gather the whole query set, run the whole
forward and take their queries' share of the loss (the work is repeated, the
function is JAX's).

TAP-Net's BatchNorm running statistics are the model's buffers, moved in
place by each training forward, as the parameters are by each update:
`TrainState.model_state` is {"batch_stats": those buffers by name}, the
JAX TrainState's collection, and checkpoints store it as Flax's
`batch_stats` tree, so a checkpoint of either package restores in the
other.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Mapping, NamedTuple, Optional

import torch
import torch.utils.checkpoint

from tapnet_tpu_torch.checkpoints import convert
from tapnet_tpu_torch.inference import resolve_device
from tapnet_tpu_torch.models import (rglru, ssm_vit, tapir, tapnet, tapnext,
                                     tapnext_losses, tsm_resnet)
from tapnet_tpu_torch.parallel import mesh as mesh_lib
from tapnet_tpu_torch.training import checkpointing, optimizers, telemetry
from tapnet_tpu_torch.utils import losses as loss_lib
from tapnet_tpu_torch.utils import sampling, transforms

Batch = Mapping[str, torch.Tensor]


class TrainState(NamedTuple):
  # The model's own parameters by name, updated in place by each step.
  params: Dict[str, torch.Tensor]
  opt_state: Any
  step: int
  # Non-parameter variables: TAP-Net's {"batch_stats": running statistics
  # by name}; the other trackers have none.
  model_state: Any = {}


@dataclasses.dataclass(frozen=True)
class TaskConfig:
  """Supervised point-prediction task settings (the JAX package's; the
  TAPIR losses read them)."""

  train_chunk_size: int = 32
  position_loss_weight: float = 0.05
  expected_dist_thresh: float = 6.0


def compute_tapir_loss(output: Mapping[str, Any], batch: Batch,
                       task: TaskConfig):
  """TAP loss over the final output and every unrefined iteration
  (`utils.losses.tapnet_loss`). Returns (loss, scalars) with JAX's scalar
  names: position_loss, occlusion_loss and prob_loss of the final output,
  position_loss_i and occlusion_loss_i of iteration i, and loss."""
  scalars = {}

  def one(tracks, occ, expd):
    return loss_lib.tapnet_loss(
        tracks, occ, batch["target_points"], batch["occluded"],
        batch["video"].shape, expected_dist=expd,
        position_loss_weight=task.position_loss_weight,
        expected_dist_thresh=task.expected_dist_thresh)

  huber, occ_l, prob = one(output["tracks"], output["occlusion"],
                           output.get("expected_dist"))
  loss = huber + occ_l + prob
  scalars.update(position_loss=huber, occlusion_loss=occ_l, prob_loss=prob)
  for i in range(len(output.get("unrefined_tracks", ()))):
    huber, occ_l, prob = one(output["unrefined_tracks"][i],
                             output["unrefined_occlusion"][i],
                             output["unrefined_expected_dist"][i])
    loss = loss + huber + occ_l + prob
    scalars[f"position_loss_{i}"] = huber
    scalars[f"occlusion_loss_{i}"] = occ_l
  scalars["loss"] = loss
  return loss, scalars


def _splits_queries(mesh) -> bool:
  return mesh is not None and mesh.size(mesh_lib.MODEL_AXIS) > 1


def query_shard(mesh, num_queries: int):
  """(offset, total) of this rank's `num_queries` queries among the global
  ones split over the "model" axis, or None without a split."""
  if not _splits_queries(mesh):
    return None
  return (mesh.index(mesh_lib.MODEL_AXIS) * num_queries,
          mesh.size(mesh_lib.MODEL_AXIS) * num_queries)


def tapir_loss_builder(model, task: TaskConfig, mesh=None):
  """The TAP loss of TAPIR-style trackers. `loss_fn(batch, generator=None)
  -> (loss, scalars)`: the training forward in chunks of
  `task.train_chunk_size` queries, in an order drawn from `generator` (the
  identity without one). Under a `mesh` the chunks are the global ones
  (`query_shard`); the loss, a mean over equal parts, is this rank's share
  as it is."""

  def loss_fn(batch: Batch, generator: Optional[torch.Generator] = None):
    # TAP-Net's chunks are independent and draw nothing: it needs no shard.
    shard = ({"query_shard": query_shard(mesh, batch["query_points"].shape[1])}
             if isinstance(model, tapir.TAPIR) else {})
    output = model(batch["video"], batch["query_points"],
                   query_chunk_size=task.train_chunk_size, is_training=True,
                   generator=generator, **shard)
    return compute_tapir_loss(output, batch, task)

  return loss_fn


def contrastive_loss_builder(model, task: TaskConfig,
                             softmax_temperature: float = 10.0, mesh=None):
  """TAP-Net's cost-volume loss (the JAX package's, after the reference's
  supervised_point_prediction.py:255-302): the training forward with the
  query features, then per chunk of `task.train_chunk_size` queries the
  log-softmax over (T, h, w) of each query's dot products with the feature
  grid, sampled bilinearly at its target point on each frame and averaged
  over the visible frames; the loss is minus the mean. `loss_fn(batch,
  generator=None) -> (loss, {"loss", "contrastive_loss"})`. A mean over
  equal parts: under a `mesh` it is this rank's share as it is."""
  del mesh

  def loss_fn(batch: Batch, generator: Optional[torch.Generator] = None):
    del generator
    out = model(batch["video"], batch["query_points"],
                query_chunk_size=task.train_chunk_size, is_training=True,
                get_query_feats=True)
    feature_grid, query_feats = out["feature_grid"], out["query_feats"]
    im_shape = tuple(batch["video"].shape)
    b, t, h, w, _ = feature_grid.shape
    losses = []
    for start in range(0, query_feats.shape[1], task.train_chunk_size):
      stop = start + task.train_chunk_size
      q = query_feats[:, start:stop]
      n = q.shape[1]
      dots = torch.einsum("bnc,bthwc->bnthw", q, feature_grid)
      log_softmax = torch.log_softmax(
          (dots * softmax_temperature).reshape(b, n, -1), -1)
      target = transforms.convert_grid_coordinates(
          batch["target_points"][:, start:stop], im_shape[3:1:-1],
          tuple(feature_grid.shape)[3:1:-1])
      # The per-frame log-softmax sampled along the target track, (y, x).
      vals = sampling.sample_grid_batched(
          log_softmax.reshape(b * n * t, h, w, 1),
          target.flip(-1).reshape(b * n * t, 1, 2)).reshape(b, n, t)
      visible = 1.0 - batch["occluded"][:, start:stop]
      losses.append(torch.mean(vals * visible, -1))
    loss = -torch.mean(torch.cat(losses, 1))
    return loss, {"loss": loss, "contrastive_loss": loss}

  return loss_fn


def _tapnext_targets(batch: Batch):
  """The batch's (x, y) targets as the model's (y, x), and visibility."""
  return batch["target_points"].flip(-1), 1.0 - batch["occluded"]


def _all_queries(query_points, mesh):
  """TAPNext's whole query set: its query tokens attend to each other, so
  the "model" ranks gather the queries split over them."""
  if not _splits_queries(mesh):
    return query_points
  return mesh_lib.gather(query_points, mesh, mesh_lib.MODEL_AXIS, dim=1)


def _my_queries(results, mesh):
  """This rank's queries of [B, Q, ...] results (every field, and each
  intermediate head's)."""
  if not _splits_queries(mesh):
    return results
  part = lambda x: mesh_lib.shard(x, mesh, mesh_lib.MODEL_AXIS, 1)
  return tapnext.TrackerResults(
      tracks=part(results.tracks), track_logits=part(results.track_logits),
      visible_logits=part(results.visible_logits),
      intermediate_tracks=[part(x) for x in results.intermediate_tracks],
      intermediate_track_logits=[
          part(x) for x in results.intermediate_track_logits],
      intermediate_visible_logits=[
          part(x) for x in results.intermediate_visible_logits])


def tapnext_loss_builder(model, task: TaskConfig, mesh=None):
  """TAPNext loss: coordinate CE + Huber + visibility, with deep
  supervision. `loss_fn(batch, generator=None) -> (loss, scalars)`; the
  generator is not used. Under a `mesh` the loss is this rank's share of the
  global one, its mask counts summed over the ranks."""
  del task

  def loss_fn(batch: Batch, generator: Optional[torch.Generator] = None):
    del generator
    results = model(batch["video"], _all_queries(batch["query_points"], mesh))
    return tapnext_losses.tapnext_loss(_my_queries(results, mesh),
                                       *_tapnext_targets(batch), mesh=mesh)

  return loss_fn


def tapnext_chunked_loss_builder(model, task: TaskConfig,
                                 chunk_size: int = 128, mesh=None):
  """TAPNext loss over time-chunked forwards (see the module docstring)."""
  del task

  def loss_fn(batch: Batch, generator: Optional[torch.Generator] = None):
    del generator
    video = batch["video"]
    qp = _all_queries(batch["query_points"], mesh)
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
    return tapnext_losses.tapnext_loss(_my_queries(results, mesh),
                                       *_tapnext_targets(batch), mesh=mesh)

  return loss_fn


def loss_and_grads(loss_fn, params: Mapping[str, torch.Tensor], batch: Batch,
                   generator: Optional[torch.Generator] = None):
  """(loss, scalars, grads by name); an unused parameter's gradient is
  zero. `generator` goes to the loss (TAPIR's query order)."""
  loss, scalars = loss_fn(batch, generator)
  names = list(params)
  grads = torch.autograd.grad(loss, [params[n] for n in names],
                              allow_unused=True)
  grads = {n: torch.zeros_like(params[n]) if g is None else g
           for n, g in zip(names, grads)}
  return loss, scalars, grads


def make_train_step(
    model, tx: optimizers.Optimizer, task: TaskConfig = TaskConfig(),
    loss_builder: Optional[Callable] = None, mesh=None,
) -> Callable[[TrainState, Batch], tuple]:
  """`train_step(state, batch, generator=None) -> (state, scalars)`: the
  loss of `loss_builder(model, task)` (TAPIR's by default), its gradients,
  one optimizer update applied to the parameters in place, and the loss's
  scalars with gradient_norm. `generator` draws TAPIR's query order.

  With a `mesh`, `batch` is this rank's part of the global batch, the loss
  is `loss_builder(model, task, mesh=mesh)` (this rank's share), and the
  gradients and scalars are averaged over every rank before the update."""
  builder = loss_builder or tapir_loss_builder
  loss_fn = (builder(model, task) if mesh is None
             else builder(model, task, mesh=mesh))

  def train_step(state: TrainState, batch: Batch,
                 generator: Optional[torch.Generator] = None):
    _, scalars, grads = loss_and_grads(loss_fn, state.params, batch,
                                       generator)
    scalars = {k: v.detach() for k, v in scalars.items()}
    if mesh is not None:
      mesh.mean_(list(grads.values()))
      scalars = global_means(scalars, mesh)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    optimizers.apply_updates(state.params, updates)
    scalars["gradient_norm"] = optimizers.global_norm(grads.values())
    return (TrainState(state.params, opt_state, state.step + 1,
                       state.model_state), scalars)

  return train_step


def global_means(scalars: Mapping[str, torch.Tensor],
                 mesh) -> Dict[str, torch.Tensor]:
  """Each scalar's mean over every rank (one all_reduce)."""
  names = list(scalars)
  values = mesh.all_mean(torch.stack([scalars[k].float() for k in names]))
  return dict(zip(names, values.unbind(0)))


def _load_tapnet(model, tree, batch_stats=None):
  """TAP-Net's parameters, and its running statistics from Flax's
  `batch_stats` tree (by default the model's own)."""
  if batch_stats is None:
    batch_stats = convert.stats_to_flax(dict(model.named_buffers()))
  convert.load_tapnet_params(model, tree, batch_stats)


class _Family(NamedTuple):
  """What the Trainer needs of one model family."""
  # (model, tensors by name) -> the Flax-layout tree of numpy leaves.
  to_flax: Callable
  # Flax-layout tree -> tensors by name (on the CPU).
  from_flax: Callable
  # (model, params tree, batch_stats tree or None): fills the model.
  load: Callable
  # (model config, CPU generator) -> (params tree, batch_stats tree or None).
  init: Callable
  # The model's buffers are running statistics (TrainState.model_state).
  batch_stats: bool = False


_FAMILIES = {
    tapir.TAPIR: _Family(
        to_flax=lambda model, tensors: convert.state_dict_to_flax(tensors),
        from_flax=convert.flax_to_state_dict,
        load=lambda model, tree, _: convert.load_flax_params(model, tree),
        init=lambda cfg, gen: (tapir.init_tapir_params(cfg, gen), None)),
    tapnet.TAPNet: _Family(
        to_flax=lambda model, tensors: convert.state_dict_to_tapnet(tensors),
        from_flax=lambda tree: convert.tapnet_to_state_dict(tree, {}),
        load=_load_tapnet, init=tapnet.init_tapnet_params, batch_stats=True),
    tapnext.TAPNextTracker: _Family(
        to_flax=lambda model, tensors: convert.state_dict_to_tapnext(
            tensors, model.config.num_heads, model.config.patch_size),
        from_flax=convert.tapnext_to_state_dict,
        load=lambda model, tree, _: convert.load_tapnext_params(model, tree),
        init=lambda cfg, gen: (tapnext.init_tapnext_params(cfg, gen), None)),
}


class Trainer:
  """Owns the model and optimizer and runs the training loop, on one device
  or as one rank of a `mesh` (module docstring)."""

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
    device="cpu"); with a `mesh` rank r takes cuda:{r % cards}. mesh: a
    `parallel.mesh.Mesh` over the process group's ranks, or None for one
    device. The port draws its initial parameters without a forward
    pass, so it needs no example batch (the JAX Trainer's init_num_frames
    and init_state's example_batch). Step k draws TAPIR's query order from
    `step_generator(k)` (the JAX loop's split of its rng)."""
    self.family = next((f for cls, f in _FAMILIES.items()
                        if isinstance(model, cls)), None)
    if self.family is None:
      raise NotImplementedError(
          f"the port trains TAPIR, TAP-Net and TAPNext, not "
          f"{type(model).__name__}")
    self.mesh = mesh
    self.device = resolve_device(device) if mesh is None else mesh.device(
        device)
    self.model = model.to(self.device)
    if self.family.batch_stats:
      tsm_resnet.sync_batch_norm(self.model, mesh, mesh_lib.DATA_AXIS)
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

  @property
  def is_chief(self) -> bool:
    """Whether this rank prints, logs, checkpoints and evaluates (rank 0,
    or the only one)."""
    return self.mesh is None or self.mesh.rank == 0

  @staticmethod
  def step_generator(step: int) -> torch.Generator:
    """The CPU generator of step `step`'s draws (TAPIR's query order)."""
    return torch.Generator().manual_seed(step)

  def _flax_tree(self, tensors: Mapping[str, torch.Tensor]):
    """The model's tensors by name (parameters, gradients, moments) as the
    Flax-layout tree of numpy leaves."""
    return self.family.to_flax(self.model, tensors)

  def _from_flax_tree(self, tree) -> Dict[str, torch.Tensor]:
    return {k: v.to(self.device)
            for k, v in self.family.from_flax(tree).items()}

  def load_params(self, tree, batch_stats=None) -> Dict[str, torch.Tensor]:
    """Fills the model's parameters from a Flax-layout tree (TAP-Net: and
    its running statistics from Flax's `batch_stats` tree, by default the
    model's own); returns the parameters by name."""
    self.family.load(self.model, tree, batch_stats)
    return dict(self.model.named_parameters())

  def _model_state(self):
    """TAP-Net's running statistics (the model's buffers, moved in place by
    each training forward), else {}."""
    if not self.family.batch_stats:
      return {}
    return {"batch_stats": dict(self.model.named_buffers())}

  def init_state(self, seed: int = 42) -> TrainState:
    """Fresh parameters (`init_tapir_params`, `init_tapnet_params` (with
    fresh running statistics) or `init_tapnext_params` of `models` from
    `seed`) loaded into the model, and a fresh optimizer state."""
    generator = torch.Generator().manual_seed(seed)
    params = self.load_params(*self.family.init(self.model.config, generator))
    if self.mesh is not None:  # replicated: rank 0's parameters
      self.mesh.broadcast_(list(self.model.parameters())
                           + list(self.model.buffers()))
    return TrainState(params, self.tx.init(params), 0, self._model_state())

  def restore_or_init(self) -> TrainState:
    """The state of `checkpoint_path` if it exists, else `init_state`.
    Under a mesh rank 0 reads the checkpoint and broadcasts it."""
    ckpt = (checkpointing.restore_checkpoint(self.checkpoint_path)
            if self.checkpoint_path and self.is_chief else None)
    if self.mesh is not None:
      ckpt = self.mesh.broadcast_object(ckpt)
    if ckpt is None:
      return self.init_state()
    params = self.load_params(
        ckpt["params"], ckpt.get("model_state", {}).get("batch_stats"))
    opt_state = dict(ckpt["opt_state"])
    for key in ("mu", "nu"):
      if key in opt_state:
        opt_state[key] = self._from_flax_tree(opt_state[key])
    return TrainState(params, opt_state, int(ckpt["step"]),
                      self._model_state())

  def save(self, state: TrainState) -> None:
    """Writes `state` to `checkpoint_path`: parameters, optimizer moments
    and (TAP-Net) the running statistics as Flax-layout trees. Under a mesh
    only rank 0 writes."""
    if not self.is_chief:
      return
    opt_state = dict(state.opt_state)
    for key in ("mu", "nu"):
      if key in opt_state:
        opt_state[key] = self._flax_tree(opt_state[key])
    model_state = dict(state.model_state)
    if "batch_stats" in model_state:
      model_state["batch_stats"] = convert.stats_to_flax(
          model_state["batch_stats"])
    checkpointing.save_checkpoint(self.checkpoint_path, dict(
        params=self._flax_tree(state.params), opt_state=opt_state,
        step=state.step, model_state=model_state))

  @property
  def step_fn(self):
    if self._step_fn is None:
      self._step_fn = make_train_step(self.model, self.tx, self.task,
                                      self.loss_builder, self.mesh)
    return self._step_fn

  def fit(self, state: TrainState, data: Iterator[Batch], num_steps: int,
          log_every: int = 50,
          eval_fn: Optional[Callable[[TrainState], Mapping[str, float]]] = None,
          evaluate_every: int = 0) -> TrainState:
    """Runs `num_steps` training steps, printing and logging the scalars
    every `log_every` steps and checkpointing every `checkpoint_every`.

    If `eval_fn` is given, it is called every `evaluate_every` steps with
    the current state (the reference's in-train eval, experiment.py:193-197;
    `tapvid.evaluate.make_eval_fn` builds one), and its scalars go to the
    same sink with kind "eval".

    Under a mesh every rank reads the same global batches from `data` and
    takes its part; rank 0 alone prints, logs, checkpoints and evaluates."""
    sink = telemetry.ScalarSink(self.log_path if self.is_chief else None)
    last_t = time.time()
    try:
      for i in range(num_steps):
        batch = {k: v.to(self.device) for k, v in next(data).items()}
        if self.mesh is not None:
          batch = mesh_lib.shard_batch(batch, self.mesh)
        state, scalars = self.step_fn(state, batch,
                                      self.step_generator(state.step))
        step = state.step
        if not self.is_chief:
          continue
        if log_every and (i + 1) % log_every == 0:
          scalars = {k: float(v) for k, v in scalars.items()}
          dt = (time.time() - last_t) / log_every
          last_t = time.time()
          lr = float(self.lr_schedule(step))
          parts = [f"step {step} loss {scalars['loss']:.4f}"]
          for key, short in (("position_loss", "pos"),
                             ("occlusion_loss", "occ")):
            if key in scalars:
              parts.append(f"{short} {scalars[key]:.4f}")
          print(" ".join(parts) + f" gnorm {scalars['gradient_norm']:.3f} "
                f"lr {lr:.2e} {dt*1000:.0f} ms/step")
          sink.write(step, dict(scalars, learning_rate=lr,
                                ms_per_step=dt * 1000))
        if (self.checkpoint_path and self.checkpoint_every
            and step % self.checkpoint_every == 0):
          self.save(state)
        if eval_fn is not None and evaluate_every and (
            step % evaluate_every == 0):
          eval_scalars = eval_fn(state)
          print(f"eval @{step} " + " ".join(
              f"{k}={v:.4f}" for k, v in eval_scalars.items()))
          sink.write(step, eval_scalars, kind="eval")
    finally:
      sink.close()
    return state

"""BootsTAP self-training, student and teacher (port of
tapnet_tpu/training/bootstrap.py), on one device or over a mesh.

  * The teacher is an EMA of the student. It predicts tracks on the clean
    video for randomly sampled query points, with no gradient.
  * The student sees a scaled and translated (`_warp_video`: JAX's
    `image.scale_and_translate(method="bilinear")`, whose triangle kernel
    widens by 1 / scale when it downscales, an antialiasing that
    `F.interpolate` and `grid_sample` do not match) and colour-corrupted
    view; its queries are the same points mapped through the transform.
  * The loss is a Huber loss between the student's predictions (every
    unrefined iteration and the final one) and the teacher's mapped into the
    view, plus a BCE of the student's occlusion logits toward the teacher's
    visibility, both masked to points the teacher is confident about and
    that stay inside the view. A batch's "labeled" sub-batch adds the
    supervised TAP loss of the student (`trainer.compute_tapir_loss`).

The student and the teacher are two `models.tapir.TAPIR` modules; their
parameters are updated in place. Each step's draws (the queries, the view
and the colour transform) come from one `torch.Generator`: `fit_bootstrap`
seeds one per step from the step, as the JAX loop splits its rng.

With a `mesh` (`parallel.mesh.Mesh`; JAX's `fit_bootstrap(mesh=...)`), the
student, the teacher and the optimizer are replicated (rank 0's, broadcast)
and each rank takes its part of the unlabeled and labeled batches (clips
over "data", the labeled queries over "model"). The draws are made for the
global batch with the same generator on every rank, each rank taking its
part, and the loss's normaliser (the count of confident points) is summed
over the ranks; the gradients are averaged before the update. The step is
then the single-device step on the global batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Mapping, NamedTuple, Optional

import numpy as np
import torch

from tapnet_tpu_torch.checkpoints import convert
from tapnet_tpu_torch.data import augmentations
from tapnet_tpu_torch.parallel import mesh as mesh_lib
from tapnet_tpu_torch.training import checkpointing, optimizers, telemetry
from tapnet_tpu_torch.training import trainer as trainer_lib
from tapnet_tpu_torch.utils import losses as loss_lib

Batch = Mapping[str, Any]


def _huber(pred_xy: torch.Tensor, target_xy: torch.Tensor,
           delta: float = 4.0) -> torch.Tensor:
  """Per point and frame Huber loss on the xy error."""
  distsqr = (pred_xy - target_xy).square().sum(-1)
  dist = torch.sqrt(distsqr + 1e-12)
  return torch.where(dist < delta, distsqr / 2, delta * (dist - delta / 2))


@dataclasses.dataclass(frozen=True)
class BootstrapConfig:
  """Self-training hyperparameters (the JAX package's)."""

  num_queries: int = 128
  query_chunk_size: int = 32
  ema_decay: float = 0.99
  # The student's view: scale log-uniform in [min_scale, 1], translation
  # uniform within the frame.
  min_scale: float = 0.7
  color_augment: bool = True
  huber_weight: float = 0.05
  occlusion_weight: float = 1.0
  # Only points the teacher marks visible (occlusion logit < gate and
  # expected_dist logit < gate) supervise the student.
  confidence_gate: float = 0.0
  # Weight of the supervised anchor loss of a batch's "labeled" sub-batch.
  supervised_weight: float = 1.0
  supervised_chunk_size: int = 32


class BootstrapState(NamedTuple):
  params: Dict[str, torch.Tensor]  # the student's, updated in place
  teacher_params: Dict[str, torch.Tensor]  # the teacher's, an EMA
  opt_state: Any
  step: int


def _sample_view(generator: torch.Generator, batch: int, height: int,
                 width: int, min_scale: float):
  """Per-example view (scale [B], tx [B], ty [B]): a clean-frame point p
  lands at p * scale + t, inside the frame."""
  u = torch.rand((3, batch), generator=generator, device=generator.device)
  log_min = math.log(min_scale)
  scale = torch.exp(log_min + u[0] * (0.0 - log_min))
  return scale, u[1] * (1.0 - scale) * width, u[2] * (1.0 - scale) * height


def _resample_weights(size: int, scale: torch.Tensor,
                      translation: torch.Tensor) -> torch.Tensor:
  """[B, size, size] weights of JAX's `image.scale_and_translate` along one
  axis (bilinear, antialiased) for per-example `scale` and `translation`
  [B]: the triangle kernel at each output sample's source position,
  normalised over the inputs, zero where the sample falls outside."""
  scale = scale.float()[:, None, None]
  translation = translation.float()[:, None, None]
  inv_scale = 1.0 / scale
  cells = torch.arange(size, dtype=torch.float32, device=scale.device)
  sample_f = ((cells[None, None, :] + 0.5) * inv_scale
              - translation * inv_scale - 0.5)
  x = (sample_f - cells[None, :, None]).abs() / torch.clamp(inv_scale, min=1.0)
  weights = torch.clamp(1.0 - x, min=0.0)
  total = weights.sum(1, keepdim=True)
  weights = torch.where(
      total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
      weights / torch.where(total != 0, total, torch.ones_like(total)),
      torch.zeros_like(weights))
  inside = (sample_f >= -0.5) & (sample_f <= size - 0.5)
  return torch.where(inside, weights, torch.zeros_like(weights))


def _warp_video(video: torch.Tensor, scale: torch.Tensor, tx: torch.Tensor,
                ty: torch.Tensor) -> torch.Tensor:
  """Per-example scale and translation of [B, T, H, W, 3] (same size out):
  a clean-frame point (x, y) lands at (x * s + tx, y * s + ty)."""
  _, _, h, w, _ = video.shape
  wy = _resample_weights(h, scale, ty).to(video.dtype)
  wx = _resample_weights(w, scale, tx).to(video.dtype)
  return torch.einsum("bthwc,bhy,bwx->btyxc", video, wy, wx)


def _sample_queries(generator: torch.Generator, batch: int, num_queries: int,
                    num_frames: int, height: int, width: int) -> torch.Tensor:
  """Random (t, y, x) queries in the clean frame, [B, N, 3] float32."""
  dev = generator.device
  t = torch.randint(0, num_frames, (batch, num_queries), generator=generator,
                    device=dev).float()
  y = torch.rand((batch, num_queries), generator=generator, device=dev) * height
  x = torch.rand((batch, num_queries), generator=generator, device=dev) * width
  return torch.stack([t, y, x], dim=-1)


def make_bootstrap_train_step(model, teacher, tx: optimizers.Optimizer,
                              config: BootstrapConfig = BootstrapConfig(),
                              mesh=None):
  """The self-training step over unlabeled video.

  `train_step(state, batch, generator) -> (state, scalars)`: batch holds
  "video" [B, T, H, W, 3] in [-1, 1] and optionally "labeled" (a supervised
  batch); `generator` draws the queries, the view and the colour transform.
  With a `mesh`, `batch` is this rank's part of the global batch
  (`mesh.shard_batch`) and the step is the global batch's (module
  docstring).
  """
  clips = lambda x: x if mesh is None else mesh_lib.shard(
      x, mesh, mesh_lib.DATA_AXIS, 0)
  queries = lambda x: x if mesh is None else mesh_lib.shard(
      x, mesh, mesh_lib.MODEL_AXIS, 1)
  ranks = 1 if mesh is None else mesh.size()

  def train_step(state: BootstrapState, batch: Batch,
                 generator: torch.Generator):
    video = batch["video"]
    b, t, h, w, _ = video.shape
    dev = video.device
    # The draws are the global batch's (b clips a rank along "data").
    b_all = b if mesh is None else b * mesh.size(mesh_lib.DATA_AXIS)
    qp = queries(clips(_sample_queries(
        generator, b_all, config.num_queries, t, h, w))).to(dev)
    with torch.no_grad():
      out_t = teacher(video, qp, query_chunk_size=config.query_chunk_size)
    t_tracks = out_t["tracks"]
    t_occ = out_t["occlusion"]
    t_expd = out_t.get("expected_dist", torch.zeros_like(t_occ))

    scale, tx_, ty_ = (clips(v).to(dev) for v in _sample_view(
        generator, b_all, h, w, config.min_scale))
    video_s = _warp_video(video, scale, tx_, ty_)
    if config.color_augment:
      draws = augmentations.color_draws(generator, b_all)
      video_s = augmentations.color_augmentation(
          video_s, {k: clips(v) for k, v in draws.items()})
    s_b = scale[:, None]
    qp_s = torch.stack([qp[..., 0], qp[..., 1] * s_b + ty_[:, None],
                        qp[..., 2] * s_b + tx_[:, None]], dim=-1)
    target_xy = (t_tracks * scale[:, None, None, None]
                 + torch.stack([tx_, ty_], -1)[:, None, None])
    conf = (t_occ < config.confidence_gate) & (t_expd < config.confidence_gate)
    inb = ((target_xy[..., 0] >= 0) & (target_xy[..., 0] < w)
           & (target_xy[..., 1] >= 0) & (target_xy[..., 1] < h))
    weight = (conf & inb).float()  # [B, N, T]
    count = weight.sum() if mesh is None else mesh.all_sum(weight.sum())
    # This rank's share: the mean over ranks is the global loss.
    denom = torch.clamp(count, min=1.0) / ranks
    visible_target = (t_occ > 0).float()

    out = model(video_s, qp_s, query_chunk_size=config.query_chunk_size,
                is_training=True,
                query_shard=trainer_lib.query_shard(mesh, qp_s.shape[1]))
    total = 0.0
    scalars = {}
    if "labeled" in batch:
      lb = batch["labeled"]
      sup_out = model(lb["video"], lb["query_points"],
                      query_chunk_size=config.supervised_chunk_size,
                      is_training=True, query_shard=trainer_lib.query_shard(
                          mesh, lb["query_points"].shape[1]))
      sup_loss, _ = trainer_lib.compute_tapir_loss(
          sup_out, lb,
          trainer_lib.TaskConfig(train_chunk_size=config.supervised_chunk_size))
      total = total + config.supervised_weight * sup_loss
      scalars["supervised_loss"] = sup_loss
    preds = list(out.get("unrefined_tracks", ())) + [out["tracks"]]
    occs = list(out.get("unrefined_occlusion", ())) + [out["occlusion"]]
    for i, (tr, oc) in enumerate(zip(preds, occs)):
      pos = config.huber_weight * (_huber(tr, target_xy) * weight).sum() / denom
      occ_bce = loss_lib.sigmoid_binary_cross_entropy(oc, visible_target)
      occ = config.occlusion_weight * (occ_bce * weight).sum() / denom
      total = total + pos + occ
      if i == len(preds) - 1:
        scalars["position_loss"] = pos
        scalars["occlusion_loss"] = occ
    scalars["supervised_frac"] = weight.mean()

    names = list(state.params)
    grads = torch.autograd.grad(total, [state.params[n] for n in names],
                                allow_unused=True)
    grads = {n: torch.zeros_like(state.params[n]) if g is None else g
             for n, g in zip(names, grads)}
    scalars["loss"] = total
    scalars = {k: v.detach() for k, v in scalars.items()}
    if mesh is not None:
      mesh.mean_(list(grads.values()))
      scalars = trainer_lib.global_means(scalars, mesh)
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    optimizers.apply_updates(state.params, updates)
    with torch.no_grad():
      for n, e in state.teacher_params.items():
        e.copy_(config.ema_decay * e + (1.0 - config.ema_decay) * state.params[n])
    scalars["gradient_norm"] = optimizers.global_norm(grads.values())
    return (BootstrapState(state.params, state.teacher_params, opt_state,
                           state.step + 1), scalars)

  return train_step


def init_bootstrap_state(model, teacher, params: Mapping[str, Any],
                         tx: optimizers.Optimizer) -> BootstrapState:
  """Student and teacher both start from `params` (a Flax-layout TAPIR tree,
  e.g. a supervised checkpoint); the teacher takes no gradient."""
  convert.load_flax_params(model, params)
  convert.load_flax_params(teacher, params)
  teacher.requires_grad_(False)
  student = dict(model.named_parameters())
  return BootstrapState(student, dict(teacher.named_parameters()),
                        tx.init(student), 0)


def restore_or_init_bootstrap(model, teacher, params: Mapping[str, Any],
                              tx: optimizers.Optimizer,
                              checkpoint_path: Optional[str], mesh=None
                              ) -> BootstrapState:
  """Resumes a self-training run from its checkpoint, else starts from
  `params` with teacher = student. Under a `mesh` rank 0 reads the
  checkpoint and broadcasts it."""
  chief = mesh is None or mesh.rank == 0
  ckpt = (checkpointing.restore_checkpoint(checkpoint_path)
          if checkpoint_path and chief else None)
  if mesh is not None:
    ckpt = mesh.broadcast_object(ckpt)
  if ckpt is None:
    return init_bootstrap_state(model, teacher, params, tx)
  state = init_bootstrap_state(model, teacher, ckpt["params"], tx)
  convert.load_flax_params(teacher, ckpt["teacher_params"])
  dev = next(model.parameters()).device
  opt_state = dict(ckpt["opt_state"])
  for key in ("mu", "nu"):
    if key in opt_state:
      opt_state[key] = {k: v.to(dev) for k, v in
                        convert.flax_to_state_dict(opt_state[key]).items()}
  return state._replace(opt_state=opt_state, step=int(ckpt["step"]))


def save_bootstrap(checkpoint_path: str, state: BootstrapState) -> None:
  """Writes the student, the teacher and the optimizer state (its moments
  as Flax-layout trees)."""
  opt_state = dict(state.opt_state)
  for key in ("mu", "nu"):
    if key in opt_state:
      opt_state[key] = convert.state_dict_to_flax(opt_state[key])
  checkpointing.save_checkpoint(checkpoint_path, dict(
      params=convert.state_dict_to_flax(state.params),
      teacher_params=convert.state_dict_to_flax(state.teacher_params),
      opt_state=opt_state, step=state.step))


def step_generator(step: int) -> torch.Generator:
  """The CPU generator of step `step`'s draws."""
  return torch.Generator().manual_seed(step)


def fit_bootstrap(
    model,
    teacher,
    state: BootstrapState,
    data: Iterator[Batch],
    tx: optimizers.Optimizer,
    num_steps: int,
    config: BootstrapConfig = BootstrapConfig(),
    log_every: int = 50,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1000,
    log_path: Optional[str] = None,
    eval_fn: Optional[Callable[[BootstrapState], Mapping[str, float]]] = None,
    evaluate_every: int = 0,
    mesh=None,
) -> BootstrapState:
  """Runs the self-training loop over an unlabeled-video iterator.

  Telemetry goes to the supervised trainer's JSONL sink (`log_path`, by
  default `train_log.jsonl` beside the checkpoint) with kind "bootstrap";
  `checkpoint_path` saves the student, the teacher and the optimizer
  (resume with `restore_or_init_bootstrap`). `eval_fn(state)` is the
  in-train eval hook (`state.params`: the student, `state.teacher_params`:
  the EMA teacher).

  With a `mesh` (`parallel.mesh.Mesh`) this is one rank of the run (module
  docstring): every rank reads the same global batches from `data`, the
  state is replicated from rank 0, and rank 0 alone prints, logs,
  checkpoints and evaluates."""
  step_fn = make_bootstrap_train_step(model, teacher, tx, config, mesh)
  dev = next(model.parameters()).device
  chief = mesh is None or mesh.rank == 0
  if mesh is not None:
    mesh.broadcast_(list(state.params.values())
                    + list(state.teacher_params.values())
                    + [state.opt_state[k][n] for k in ("mu", "nu")
                       if k in state.opt_state for n in state.opt_state[k]])
  sink = telemetry.ScalarSink(
      (log_path if log_path is not None
       else telemetry.default_log_path(checkpoint_path)) if chief else None)
  to_dev = lambda d: {k: v.to(dev) for k, v in d.items()}
  try:
    for i in range(num_steps):
      batch = next(data)
      kept = {"video": batch["video"].to(dev)}
      if "labeled" in batch:
        kept["labeled"] = to_dev(batch["labeled"])
      if mesh is not None:
        kept = mesh_lib.shard_batch(kept, mesh)
      state, scalars = step_fn(state, kept, step_generator(state.step))
      step = state.step
      if not chief:
        continue
      if log_every and (i + 1) % log_every == 0:
        scalars = {k: float(v) for k, v in scalars.items()}
        print(f"step {step} loss {scalars['loss']:.4f} "
              f"sup_frac {scalars['supervised_frac']:.3f}")
        sink.write(step, scalars, kind="bootstrap")
      if checkpoint_path and checkpoint_every and (
          step % checkpoint_every == 0):
        save_bootstrap(checkpoint_path, state)
      if eval_fn is not None and evaluate_every and (
          step % evaluate_every == 0):
        eval_scalars = eval_fn(state)
        print(f"eval @{step} " + " ".join(
            f"{k}={v:.4f}" for k, v in eval_scalars.items()))
        sink.write(step, eval_scalars, kind="eval")
  finally:
    sink.close()
  return state

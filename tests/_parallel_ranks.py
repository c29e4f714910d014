"""The rank side of tests/test_torch_parallel.py: functions that
`parallel.launch.run_ranks` calls in each spawned rank. They import PyTorch,
numpy and the port only (no JAX: the ranks are fresh processes that must not
pay for it), and return numpy results for the test to hold against JAX.

`run_cases(rank, world, device, spec)` runs every case named in `spec` in
one spawn (the ranks start once) and returns {case: result}. A case that
raises on every rank returns its traceback under "error".
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import traceback

import numpy as np
import torch

from tapnet_tpu_torch.checkpoints import convert
from tapnet_tpu_torch.parallel import mesh as mesh_lib
from tapnet_tpu_torch.parallel import sequence


def _np(x):
  return x.detach().cpu().numpy()


def _gather_time(x, mesh):
  return mesh_lib.gather(x, mesh, mesh_lib.DATA_AXIS, dim=1)


def sp_scan(mesh, spec):
  """Values and gradients of the sp scan; the zero-h0 default; the
  indivisible length's refusal."""
  x, a, h0 = (torch.from_numpy(spec[k]) for k in ("x", "a", "h0"))
  x.requires_grad_()
  a.requires_grad_()
  y, h = sequence.sequence_parallel_linear_scan(
      sequence.shard_time(x, mesh), sequence.shard_time(a, mesh), h0, mesh)
  # This rank's share of sum(y^2) + sum(h^2): the sum over ranks is the loss.
  ((y ** 2).sum() + (h ** 2).sum() / mesh.size()).backward()
  y0, _ = sequence.sequence_parallel_linear_scan(
      sequence.shard_time(x.detach(), mesh),
      sequence.shard_time(a.detach(), mesh), None, mesh)
  try:
    sequence.shard_time(x[:, :spec["bad_t"]], mesh)
    refused = ""
  except ValueError as e:
    refused = str(e)
  return dict(y=_np(_gather_time(y, mesh)), h=_np(h),
              gx=_np(mesh.all_sum(x.grad)), ga=_np(mesh.all_sum(a.grad)),
              y_zero_h0=_np(_gather_time(y0, mesh)), refused=refused)


def sp_conv(mesh, spec):
  """The sp causal conv on a clip whose parts are shorter than the kernel,
  with gradients; and a second clip continuing from the first's cache."""
  x, w, b = (torch.from_numpy(spec[k]) for k in ("conv_x", "conv_w", "conv_b"))
  t = spec["conv_t"]
  for v in (x, w, b):
    v.requires_grad_()
  y1, cache = sequence.sequence_parallel_causal_conv(
      sequence.shard_time(x[:, :t], mesh), w, b, None, mesh)
  y2, cache2 = sequence.sequence_parallel_causal_conv(
      sequence.shard_time(x[:, t:], mesh), w, b, cache, mesh)
  ((y1 ** 2).sum() + (y2 ** 2).sum()
   + (cache2 ** 2).sum() / mesh.size()).backward()
  return dict(y1=_np(_gather_time(y1, mesh)),
              y2=_np(_gather_time(y2, mesh)), cache=_np(cache),
              cache2=_np(cache2), gx=_np(mesh.all_sum(x.grad)),
              gw=_np(mesh.all_sum(w.grad)), gb=_np(mesh.all_sum(b.grad)))


def tapnext_sp(mesh, spec):
  """TAPNext with its clip split over time: the forward (and the
  bidirectional variant's), and the gradients of a loss on the outputs,
  averaged over the ranks as the Trainer averages them."""
  import dataclasses

  from tapnet_tpu_torch.models import ssm_vit, tapnext
  out = {}
  for name, overrides in (("uni", {}), ("bidir", {"bidirectional_ssm": True})):
    cfg = ssm_vit.SsmVitConfig(**spec["tapnext_config"], **overrides,
                               sp_mesh=mesh)
    model = tapnext.TAPNextTracker(cfg)
    convert.load_tapnext_params(model, spec[f"tapnext_params_{name}"])
    r = model(torch.from_numpy(spec["tapnext_video"]),
              torch.from_numpy(spec["tapnext_qp"]))
    loss = (r.track_logits ** 2).mean() + (r.visible_logits ** 2).mean()
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    mesh.mean_(list(grads.values()))
    out[name] = dict(
        tracks=_np(r.tracks), track_logits=_np(r.track_logits),
        visible_logits=_np(r.visible_logits),
        grads=convert.state_dict_to_tapnext(grads, cfg.num_heads,
                                            cfg.patch_size))
  # The predictor in time chunks (the state carried; each chunk split).
  from tapnet_tpu_torch import inference
  out["chunked"] = inference.TapnextPredictor(
      spec["tapnext_params_uni"], ssm_vit.SsmVitConfig(**spec["tapnext_config"]),
      chunk_size=4, device="cpu", mesh=mesh)(spec["tapnext_video"],
                                             spec["tapnext_qp"])
  try:
    video = np.repeat(spec["tapnext_video"], 2, axis=1)[:, :spec["bad_t"]]
    model(torch.from_numpy(video), torch.from_numpy(spec["tapnext_qp"]))
    out["refused"] = ""
  except ValueError as e:
    out["refused"] = str(e)
  return out


def predictor(mesh, spec):
  """`TapirPredictor(mesh=...)` on a clip whose length the ranks may not
  divide."""
  from tapnet_tpu_torch import inference
  from tapnet_tpu_torch.models import tapir
  from tapnet_tpu_torch.ops import corr_tents, fused_mixer_block
  p = inference.TapirPredictor(
      spec["tapir_params"], tapir.TapirConfig(**spec["tapir_config"]),
      query_bucket=16, query_chunk_size=None, device="cpu", mesh=mesh)
  # The plain versions run on the CPU; count the calls the refinement makes.
  calls = {"corr": 0, "mixer": 0}

  def counted(fn, key):
    @functools.wraps(fn)
    def wrapper(*a, **k):
      calls[key] += 1
      return fn(*a, **k)
    return wrapper

  with _patched(corr_tents, corr_tent_patches=counted(
      corr_tents.corr_tent_patches, "corr")), _patched(
          fused_mixer_block, mixer_block=counted(
              fused_mixer_block.mixer_block, "mixer")):
    out = p(spec["tapir_video"], spec["tapir_queries"])
  return dict(out, calls=calls)


@contextlib.contextmanager
def _patched(module, **values):
  old = {k: getattr(module, k) for k in values}
  for k, v in values.items():
    setattr(module, k, v)
  try:
    yield
  finally:
    for k, v in old.items():
      setattr(module, k, v)


def _capture(tx, grads):
  """The optimizer, keeping the gradients it receives."""
  update = tx.update
  tx.update = lambda g, s, p: (grads.append(g), update(g, s, p))[1]
  return tx


def tapir_train(mesh_of, spec):
  """One `Trainer` step of the TAPIR training golden ("permuted": JAX's
  query order) at each model_parallel of spec["tapir_train_mp"]: the
  scalars and the gradients the optimizer received."""
  from tapnet_tpu_torch.models import tapir
  from tapnet_tpu_torch.training import optimizers, trainer
  from tools import make_tapir_train_golden as g
  gold = g.load()
  out = {}
  with g.jax_draws(gold):
    for mp in spec["tapir_train_mp"]:
      mesh = mesh_of(mp)
      t = trainer.Trainer(
          tapir.TAPIR(g.model_config()), optimizers.OptimizerConfig(
              **g.OPTIMIZER), total_steps=g.TOTAL_STEPS,
          task=trainer.TaskConfig(train_chunk_size=g.CHUNK), device="cpu",
          mesh=mesh)
      named = t.load_params(g.golden_params())
      grads = []
      state = trainer.TrainState(named, _capture(t.tx, grads).init(named), 0,
                                 {})
      batch = {k: torch.from_numpy(v) for k, v in g.golden_batch().items()}
      _, s = t.step_fn(state, mesh_lib.shard_batch(batch, mesh),
                       torch.Generator())
      out[mp] = dict(scalars=[{k: float(v) for k, v in s.items()}],
                     grads=g.flatten(convert.state_dict_to_flax(grads[0])))
  return out


def tapnext_train(mesh_of, spec):
  """STEPS `Trainer` steps of the TAPNext training golden (the whole-clip
  loss) with the queries split over "model"."""
  from tapnet_tpu_torch.models import ssm_vit, tapnext
  from tapnet_tpu_torch.training import optimizers, trainer
  from tools import make_tapnext_train_golden as g
  mesh = mesh_of(spec["tapnext_train_mp"])
  config = ssm_vit.SsmVitConfig(**g.CONFIG)
  t = trainer.Trainer(tapnext.TAPNextTracker(config),
                      optimizers.OptimizerConfig(**g.OPTIMIZER),
                      total_steps=g.TOTAL_STEPS,
                      loss_builder=trainer.tapnext_loss_builder,
                      device="cpu", mesh=mesh)
  state = t.init_state()
  convert.load_tapnext_params(t.model, g.golden_params())
  grads = []
  _capture(t.tx, grads)
  batch = mesh_lib.shard_batch(
      {k: torch.from_numpy(v) for k, v in g.golden_batch().items()}, mesh)
  scalars = []
  for _ in range(g.STEPS):
    state, s = t.step_fn(state, batch)
    scalars.append({k: float(v) for k, v in s.items()})
  tree = lambda d: g.flatten(convert.state_dict_to_tapnext(
      d, config.num_heads, config.patch_size))
  return {"full": dict(grads=tree(grads[0]), scalars=scalars,
                       params=tree(state.params))}


def tapnet_train(mesh_of, spec):
  """One float64 `Trainer` step of TAP-Net (TAP loss) with the batch split
  over "data" (and the queries over "model"): the loss, the scalars, the
  gradients and the running statistics after it."""
  from tapnet_tpu_torch.models import tapnet
  from tapnet_tpu_torch.training import optimizers, trainer
  mesh = mesh_of(spec["tapnet_mp"])
  model = tapnet.TAPNet()
  convert.load_tapnet_params(model, *spec["tapnet_weights"])
  t = trainer.Trainer(model.double(), optimizers.OptimizerConfig(),
                      total_steps=10,
                      task=trainer.TaskConfig(train_chunk_size=2),
                      device="cpu", mesh=mesh)
  grads = []
  _capture(t.tx, grads)
  params = dict(t.model.named_parameters())
  state = trainer.TrainState(params, t.tx.init(params), 0, t._model_state())  # pylint: disable=protected-access
  batch = {k: torch.from_numpy(v) for k, v in spec["tapnet_batch"].items()}
  _, s = t.step_fn(state, mesh_lib.shard_batch(batch, mesh),
                   torch.Generator().manual_seed(0))
  return dict(scalars={k: float(v) for k, v in s.items()},
              grads=convert.state_dict_to_tapnet(grads[0]),
              stats=convert.stats_to_flax(dict(t.model.named_buffers())))


def fit_bootstrap(mesh_of, spec):
  """One `fit_bootstrap` step of the TAPIR training golden's BootsTAP run
  (JAX's draws for the global batch) over the mesh: the scalars (rank 0's
  log), the gradients, the student and the teacher after it."""
  from tapnet_tpu_torch.models import tapir
  from tapnet_tpu_torch.training import bootstrap, optimizers
  from tools import make_tapir_train_golden as g
  mesh = mesh_of(spec["bootstrap_mp"])
  gold = g.load()
  log = os.path.join(spec["tmp"], f"bootstrap_{mesh.size()}.jsonl")
  opt = optimizers.OptimizerConfig(**g.OPTIMIZER)
  grads = []
  with g.jax_draws(gold):
    tx = _capture(optimizers.make_optimizer(
        opt, optimizers.make_lr_schedule(opt, g.TOTAL_STEPS)), grads)
    student = tapir.TAPIR(g.model_config())
    teacher = tapir.TAPIR(g.model_config())
    state = bootstrap.init_bootstrap_state(student, teacher,
                                           g.golden_params(), tx)
    data = iter([{
        "video": torch.from_numpy(g.golden_batch(g.VIDEO_SEED)["video"]),
        "labeled": {k: torch.from_numpy(v)
                    for k, v in g.golden_batch().items()}}])
    state = bootstrap.fit_bootstrap(
        student, teacher, state, data, tx, 1,
        bootstrap.BootstrapConfig(**g.BOOTSTRAP), log_every=1, log_path=log,
        mesh=mesh)
  tree = lambda d: g.flatten(convert.state_dict_to_flax(d))
  out = dict(grads=tree(grads[0]), params=tree(state.params),
             teacher_params=tree(state.teacher_params))
  if mesh.rank == 0:
    with open(log) as f:
      lines = [json.loads(line) for line in f]
    drop = ("step", "time", "kind")
    out["scalars"] = [{k: v for k, v in lines[0].items() if k not in drop}]
    out["log_lines"] = len(lines)
  return out


def run_cli(mesh_of, spec):
  """`training.run --model_parallel 2` on the ranks (this process group):
  a smoke step of TAPIR, then a second invocation that resumes from rank
  0's checkpoint for one more step."""
  del mesh_of
  from tapnet_tpu_torch.training import run
  ckpt = os.path.join(spec["tmp"], f"cli_{torch.distributed.get_world_size()}")
  args = ["--experiment", "tapir", "--smoke", "--synthetic", "--num_steps",
          "1", "--total_steps", "2", "--log_every", "1", "--model_parallel",
          "2", "--device", "cpu", "--checkpoint_dir", ckpt]
  run.main(args)
  state = run.main(args)
  return dict(ckpt=ckpt, step=state.step)


CASES = dict(sp_scan=sp_scan, sp_conv=sp_conv, tapnext_sp=tapnext_sp,
             predictor=predictor)
MESH_CASES = dict(tapir_train=tapir_train, tapnext_train=tapnext_train,
                  tapnet_train=tapnet_train, fit_bootstrap=fit_bootstrap,
                  run_cli=run_cli)


def run_cases(rank, world, device, spec):
  """Every case of spec["cases"], in order, on this rank."""
  del rank, world, device
  meshes = {}

  def mesh_of(model_parallel):
    # Every rank makes the meshes (their groups) in the same order.
    if model_parallel not in meshes:
      meshes[model_parallel] = mesh_lib.make_mesh(model_parallel)
    return meshes[model_parallel]

  results = {}
  for name in spec["cases"]:
    try:
      if name in CASES:
        results[name] = CASES[name](mesh_of(1), spec)
      else:
        results[name] = MESH_CASES[name](mesh_of, spec)
    except Exception:  # pylint: disable=broad-except
      results[name] = {"error": traceback.format_exc()}
  results["_modules"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "tapnet_tpu"))
  return results

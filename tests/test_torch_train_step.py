"""PyTorch port, TAPNext training end to end on the CPU: the train step of
the full-clip loss with deep supervision against the JAX package's (its
Pallas scan in interpret mode) in loss, every gradient leaf and the
parameters after 3 optimizer steps (the time-chunked loss:
tests/test_torch_train_chunked.py); the golden file of tools/make_tapnext_train_golden.py; remat; the
Trainer's loop, telemetry, checkpoints, resume and refusals; the CLI.

The limits are those of tools/make_tapnext_train_golden.py (its docstring
derives them): loss and scalars 1e-5 relative, gradients 1e-4 of the leaf's
largest plus 1e-7 of the model's, parameters 1e-6 relative plus what that
gradient limit lets Adam move.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu_torch import configs
from tapnet_tpu_torch.checkpoints.tapnext_checkpoint import flatten
from tapnet_tpu_torch.data import synthetic
from tapnet_tpu_torch.models import ssm_vit, tapnext
from tapnet_tpu_torch.parallel import mesh as mesh_lib
from tapnet_tpu_torch.training import checkpointing, optimizers, run, trainer
from tools import make_tapnext_train_golden as golden_tool

TINY = dict(width=32, depth=2, mlp_dim=64, num_heads=2, image_size=(32, 32))


def check_against_jax(loss):
  """The port's train step of `loss` against the JAX package's on a fresh
  run's weights (`init_tapnext_params`: Flax's initialisers, zero biases)
  and the golden batch, every element of every leaf compared."""
  batch = golden_tool.golden_batch()
  params = tapnext.init_tapnext_params(
      ssm_vit.SsmVitConfig(**golden_tool.CONFIG),
      torch.Generator().manual_seed(3))
  ref = golden_tool.unpack(golden_tool.jax_training(
      params, batch, (loss,), every_element=True))
  port = golden_tool.run_port("cpu", params=params, batch=batch,
                              builders=(loss,))
  record, failures = golden_tool.judge(ref, port, builders=(loss,))
  assert not failures, failures[:5]
  assert record[loss]["grads_over_limit"] < 1


def test_train_step_matches_jax():
  """The full-clip loss with deep supervision (the chunked loss:
  tests/test_torch_train_chunked.py)."""
  check_against_jax("full")


def test_golden_file_reproduced_on_cpu():
  """The port on the CPU against tests/data/tapnext_train_golden.npz, both
  losses, as chip_smoke.py holds the card to it."""
  record, failures = golden_tool.judge(golden_tool.load(),
                                       golden_tool.run_port("cpu"))
  assert not failures, failures[:5]
  for loss in golden_tool.BUILDERS:
    assert record[loss]["loss"] == pytest.approx(record[loss]["golden_loss"],
                                                 rel=golden_tool.LOSS_REL)


def _tiny_batch(frames=4, seed=0):
  return synthetic.make_batch(torch.Generator().manual_seed(seed), 2, frames,
                              32, 32, 5)


def _model(**overrides):
  model = tapnext.TAPNextTracker(ssm_vit.SsmVitConfig(**TINY, **overrides))
  tree = tapnext.init_tapnext_params(model.config, torch.Generator().manual_seed(0))
  from tapnet_tpu_torch.checkpoints import convert
  convert.load_tapnext_params(model, tree)
  return model


def remat_gradients(builder):
  """(loss, gradients) of `builder` on a tiny model without and with
  remat."""
  batch = _tiny_batch()
  grads = []
  for remat in (False, True):
    model = _model(remat=remat)
    params = dict(model.named_parameters())
    loss, _, g = trainer.loss_and_grads(builder(model, None), params, batch)
    grads.append((loss, g))
  return grads


def assert_same(grads):
  assert torch.equal(grads[0][0], grads[1][0])
  for k in grads[0][1]:
    assert torch.equal(grads[0][1][k], grads[1][1][k]), k


def test_remat_leaves_gradients_unchanged():
  """Remat recomputes each block in the backward: the same numbers, bit for
  bit on the CPU (the chunked loss: tests/test_torch_train_chunked.py)."""
  assert_same(remat_gradients(trainer.tapnext_loss_builder))


def _trainer(tmp_path=None, every=2, **kwargs):
  return trainer.Trainer(
      tapnext.TAPNextTracker(ssm_vit.SsmVitConfig(**TINY)),
      optimizers.OptimizerConfig(warmup_steps=2, max_norm=1.0),
      total_steps=10, loss_builder=trainer.tapnext_loss_builder,
      checkpoint_path=None if tmp_path is None else str(tmp_path / "ckpt.npy"),
      checkpoint_every=every, device="cpu", **kwargs)


def _batches(seed=0):
  gen = torch.Generator().manual_seed(seed)
  while True:
    yield synthetic.make_batch(gen, 2, 3, 32, 32, 5)


def test_fit_logs_jsonl_and_prints(tmp_path, capsys):
  t = _trainer(log_path=str(tmp_path / "log.jsonl"))
  state = t.fit(t.init_state(), _batches(), num_steps=2, log_every=1)
  assert state.step == 2
  lines = [json.loads(l) for l in open(tmp_path / "log.jsonl")]
  assert [l["step"] for l in lines] == [1, 2]
  for line in lines:
    assert line["kind"] == "train"
    for key in ("loss", "coordinate_loss", "huber_loss", "visible_loss",
                "intermediate_loss_0", "intermediate_loss_1", "gradient_norm",
                "learning_rate", "ms_per_step", "time"):
      assert np.isfinite(line[key]), key
  assert lines[0]["learning_rate"] == pytest.approx(t.lr_schedule(1))
  out = capsys.readouterr().out.splitlines()
  assert out[0].startswith("step 1 loss ") and " gnorm " in out[0]
  assert out[0].endswith(" ms/step")


def test_checkpoint_resume_keeps_the_schedule_step(tmp_path):
  """A run checkpointed at step 2 and resumed for a third step ends where
  three uninterrupted steps end, bit for bit; the checkpoint holds the
  parameters as the Flax-layout tree."""
  whole = _trainer()
  state = whole.fit(whole.init_state(), _batches(), num_steps=3, log_every=0)
  first = _trainer(tmp_path)
  data = _batches()
  first.fit(first.init_state(), data, num_steps=2, log_every=0)
  ckpt = checkpointing.restore_checkpoint(str(tmp_path / "ckpt.npy"))
  assert ckpt["step"] == 2 and ckpt["opt_state"]["count"] == 2
  want_keys = set(flatten(tapnext.init_tapnext_params(
      ssm_vit.SsmVitConfig(**TINY), torch.Generator().manual_seed(0))))
  assert set(flatten(ckpt["params"])) == want_keys
  assert set(flatten(ckpt["opt_state"]["mu"])) == want_keys
  resumed = _trainer(tmp_path)
  again = resumed.restore_or_init()
  assert again.step == 2
  again = resumed.fit(again, data, num_steps=1, log_every=0)
  assert again.step == 3
  for k, p in state.params.items():
    assert torch.equal(p, again.params[k]), k
  assert not os.path.exists(str(tmp_path / "ckpt.npy") + "_tmp")


def test_trainer_refusals(monkeypatch, tmp_path):
  model = tapnext.TAPNextTracker(ssm_vit.SsmVitConfig(**TINY))
  cfg = optimizers.OptimizerConfig()
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="device='cpu'"):
      trainer.Trainer(model, cfg, 10)
  # A mesh needs a process group (tests/test_torch_parallel.py runs one).
  with pytest.raises(RuntimeError, match="process group"):
    trainer.Trainer(model, cfg, 10, mesh=mesh_lib.make_mesh(2),
                    device="cpu")
  with pytest.raises(NotImplementedError,
                     match="trains TAPIR, TAP-Net and TAPNext"):
    trainer.Trainer(torch.nn.Linear(2, 2), cfg, 10, device="cpu")
  # TAP-Net and its contrastive loss are ported (tests/test_torch_tapnet.py).
  assert callable(trainer.contrastive_loss_builder(model, trainer.TaskConfig()))
  assert configs.get_experiment("tapnet").model_kind == "tapnet"
  loss_fn = trainer.tapnext_chunked_loss_builder(model, None, chunk_size=2)
  with pytest.raises(ValueError, match="multiple of chunk_size"):
    loss_fn(_tiny_batch(frames=3))
  with pytest.raises(ValueError, match="torchrun"):
    run.main(["--synthetic", "--model_parallel", "2", "--device", "cpu"])
  # The Kubric reader is ported (tests/test_torch_kubric.py): --data_dir
  # reads the directory, and refuses one without examples.
  with pytest.raises(ValueError, match="No npz files"):
    run.main(["--experiment", "tapnext", "--data_dir", str(tmp_path),
              "--device", "cpu"])
  if not torch.cuda.is_available():
    # Without --data_dir the CLI trains on synthetic data, as JAX's does,
    # on the card unless asked for the CPU.
    with pytest.raises(RuntimeError, match="device='cpu'"):
      run.main(["--experiment", "tapnext"])


def test_experiments_mirror_jax():
  """The two TAPNext presets, with the JAX package's hyperparameters."""
  from tapnet_tpu import configs as jax_configs
  for name in ("tapnext", "tapnextpp"):
    port, ref = configs.get_experiment(name), jax_configs.get_experiment(name)
    assert port.model_kind == ref.model_kind == "tapnext"
    assert port.total_steps == ref.total_steps
    assert port.train_time_chunk == ref.train_time_chunk
    assert port.evaluate_every == ref.evaluate_every
    for field, value in dataclass_dict(port.data).items():
      assert value == getattr(ref.data, field), field
    assert dataclass_dict(port.optimizer) == dataclass_dict(ref.optimizer)
    for field in ("width", "depth", "mlp_dim", "num_heads", "remat",
                  "image_size", "patch_size"):
      assert getattr(port.model_config, field) == getattr(ref.model_config, field)


def dataclass_dict(obj):
  return dataclasses.asdict(obj)


@pytest.mark.parametrize("name", ["tapnext", "tapnextpp"])
def test_run_cli_trains_and_checkpoints_on_cpu(tmp_path, capsys, monkeypatch,
                                               name):
  """`python -m tapnet_tpu_torch.training.run --experiment tapnext|tapnextpp
  --synthetic` on the CPU, with a checkpoint: the preset shrunk to a tiny
  width and 32x32 (the presets' own widths are held by
  test_experiments_mirror_jax; tapnextpp trains through chunks of 2)."""
  preset = configs.REGISTRY[name]

  def tiny(**overrides):
    exp = preset(**overrides)
    return dataclasses.replace(
        exp, model_config=dataclasses.replace(exp.model_config, **TINY),
        data=dataclasses.replace(exp.data, train_size=(32, 32)),
        train_time_chunk=exp.train_time_chunk and 2)

  monkeypatch.setitem(configs.REGISTRY, name, tiny)
  state = run.main(["--experiment", name, "--synthetic", "--num_steps",
                    "2", "--batch_size", "1", "--num_frames", "4",
                    "--num_queries", "3", "--log_every", "1", "--device", "cpu",
                    "--checkpoint_dir", str(tmp_path)])
  assert state.step == 2
  out = capsys.readouterr().out
  assert "step 2 loss" in out and "finished at step 2" in out
  ckpt = checkpointing.restore_checkpoint(str(tmp_path / "checkpoint.npy"))
  assert ckpt["step"] == 2
  assert os.path.exists(tmp_path / "train_log.jsonl")

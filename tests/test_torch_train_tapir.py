"""PyTorch port, TAPIR and BootsTAP training on the CPU against the JAX
package: the TAP loss and `compute_tapir_loss`, `init_tapir_params` against
Flax's `model.init`, the colour augmentation and the bootstrap view's warp on
JAX's draws, the training steps of tests/data/tapir_train_golden.npz
(tools/make_tapir_train_golden.py: identity and shared permutation, 3 steps;
one BootsTAP step) reproduced by the port in a process without JAX, the
experiments' hyperparameters, an int8 configuration's derived weights across
optimizer steps, the bootstrap checkpoint, and the CLI's `--smoke` run.

The golden limits are the tool's (its docstring derives them); the losses
1e-6 relative (float32 sums of a few terms), the augmentations 1e-6 (float32
noise of the same arithmetic).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

import jax
import jax.numpy as jnp

from tapnet_tpu import configs as jax_configs
from tapnet_tpu.data import augmentations as jax_aug
from tapnet_tpu.models import tapir as jax_tapir
from tapnet_tpu.training import bootstrap as jax_bootstrap
from tapnet_tpu.training import trainer as jax_trainer
from tapnet_tpu.utils import losses as jax_losses
from tapnet_tpu_torch import configs
from tapnet_tpu_torch.checkpoints import convert
from tapnet_tpu_torch.data import augmentations, synthetic
from tapnet_tpu_torch.models import tapir
from tapnet_tpu_torch.training import (
    bootstrap, checkpointing, optimizers, run, trainer,
)
from tapnet_tpu_torch.utils import losses
from tools import make_tapir_train_golden as golden_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_REL = 1e-6
TINY = dict(num_mixer_blocks=2, num_pips_iter=2, blocks_per_group=(1, 1, 1, 1),
            initial_resolution=(32, 32), mixer_hidden_dim=64)


def _outputs(seed=0, b=2, n=5, t=4, iters=2):
  rng = np.random.RandomState(seed)
  f = lambda *s: rng.randn(*s).astype(np.float32)
  out = dict(tracks=f(b, n, t, 2) * 20 + 30, occlusion=f(b, n, t),
             expected_dist=f(b, n, t))
  for key in ("tracks", "occlusion", "expected_dist"):
    out[f"unrefined_{key}"] = [
        (f(*out[key].shape) * (20 if key == "tracks" else 1)
         + (30 if key == "tracks" else 0)) for _ in range(iters)]
  batch = dict(video=np.zeros((b, t, 64, 48, 3), np.float32),
               target_points=f(b, n, t, 2) * 20 + 30,
               occluded=(rng.rand(b, n, t) < 0.3).astype(np.float32))
  return out, batch


def _to(tree, fn):
  if isinstance(tree, dict):
    return {k: _to(v, fn) for k, v in tree.items()}
  if isinstance(tree, list):
    return [fn(v) for v in tree]
  return fn(tree)


def test_tapnet_loss_and_its_gradients_match_jax():
  out, batch = _outputs()
  args = (out["tracks"], out["occlusion"], batch["target_points"],
          batch["occluded"])
  jax_fn = lambda p, o, e: jax_losses.tapnet_loss(
      p, o, *args[2:], batch["video"].shape, expected_dist=e)
  want, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in
                                (args[0], args[1], out["expected_dist"])))
  leaves = [torch.from_numpy(a).requires_grad_()
            for a in (args[0], args[1], out["expected_dist"])]
  got = losses.tapnet_loss(leaves[0], leaves[1],
                           *(torch.from_numpy(a) for a in args[2:]),
                           batch["video"].shape, expected_dist=leaves[2])
  for g, w in zip(got, want):
    assert float(g.detach()) == pytest.approx(float(w), rel=LOSS_REL)
  cot = (1.0, 2.0, 3.0)
  grads = torch.autograd.grad(got, leaves, [torch.tensor(c) for c in cot])
  for g, w in zip(grads, vjp(tuple(jnp.float32(c) for c in cot))):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                               atol=1e-5 * float(np.abs(w).max()))


def test_compute_tapir_loss_matches_jax():
  """The final output and every unrefined iteration, with JAX's scalar
  names."""
  out, batch = _outputs(seed=1)
  task = trainer.TaskConfig()
  loss, scalars = trainer.compute_tapir_loss(
      _to(out, torch.from_numpy), _to(batch, torch.from_numpy), task)
  jloss, jscalars = jax_trainer.compute_tapir_loss(
      _to(out, jnp.asarray), _to(batch, jnp.asarray),
      jax_trainer.TaskConfig())
  assert set(scalars) == set(jscalars)
  assert float(loss) == pytest.approx(float(jloss), rel=LOSS_REL)
  for k, v in jscalars.items():
    assert float(scalars[k]) == pytest.approx(float(v), rel=LOSS_REL, abs=1e-7), k


def test_init_matches_flax_initialisers():
  """`init_tapir_params` against Flax's `model.init` of a small BootsTAPIR:
  the same tree and shapes, the exact constants (zero biases, offsets and
  ExtraConvs output kernels, unit scales), and per random leaf the spread:
  standard deviations within 10% on leaves of 4,096 or more elements (a few
  percent of sampling noise), within the truncation at 2 standard
  deviations of LeCun's normal."""
  cfg = dict(TINY, num_pips_iter=1)
  tree = tapir.init_tapir_params(tapir.bootstapir_config(**cfg),
                                 torch.Generator().manual_seed(0))
  model = jax_tapir.TAPIR(config=jax_tapir.bootstapir_config(**cfg))
  ref = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 3)),
                            jnp.zeros((1, 1, 3)))["params"]
  got = golden_tool.flatten(tree)
  want = golden_tool.flatten(jax.tree_util.tree_map(np.asarray, ref))
  assert set(got) == set(want)
  for k, w in want.items():
    g = got[k]
    assert g.shape == w.shape and g.dtype == np.float32, k
    if w.std() == 0:
      assert np.array_equal(g, w), k
    elif w.size >= 4096:
      assert g.std() == pytest.approx(w.std(), rel=0.1), k
      fan_in = int(np.prod(w.shape[:-1]))
      assert np.abs(g).max() <= 2 / np.sqrt(fan_in) / tapir._TRUNC_STD * 1.0001, k  # pylint: disable=protected-access


def test_augmentations_match_jax_on_its_draws():
  """The colour augmentation (per video, JAX's draws for one key) and the
  bootstrap view's warp (`jax.image.scale_and_translate`, antialiased
  bilinear) against JAX's."""
  rng = np.random.RandomState(0)
  video = rng.uniform(-1, 1, (3, 3, 24, 20, 3)).astype(np.float32)
  draws = golden_tool._bootstrap_draws(jax.random.PRNGKey(4), 3, 3, 24, 20)  # pylint: disable=protected-access
  keys = jax.random.split(jax.random.split(jax.random.PRNGKey(4), 3)[2], 3)
  want = jax.vmap(jax_aug.color_augmentation)(keys, jnp.asarray(video))
  color = {k.rsplit("/", 1)[-1]: torch.from_numpy(v)
           for k, v in draws.items() if "/color/" in k}
  got = augmentations.color_augmentation(torch.from_numpy(video), color)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
  scale, tx, ty = (np.array(draws[f"bootstrap/draw/{k}"])
                   for k in ("scale", "tx", "ty"))
  want = jax_bootstrap._warp_video(jnp.asarray(video), scale, tx, ty)  # pylint: disable=protected-access
  got = bootstrap._warp_video(torch.from_numpy(video),  # pylint: disable=protected-access
                              *(torch.from_numpy(v) for v in (scale, tx, ty)))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_golden_file_reproduced_on_cpu_without_jax():
  """The port's training steps (identity and shared permutation, 3 steps
  each, 2 chunks) and one BootsTAP step against
  tests/data/tapir_train_golden.npz, in a process that never imports JAX,
  as chip_smoke.py holds the card to it."""
  code = (
      "import sys; sys.path.insert(0, '.'); "
      "from tools import make_tapir_train_golden as g; "
      "gold = g.load(); record, failures = g.judge(gold, g.run_port('cpu', gold)); "
      "assert not failures, failures[:5]; "
      "assert not any(m == 'jax' or m.startswith(('jax.', 'tapnet_tpu.')) "
      "for m in sys.modules), 'JAX imported'; "
      "print({r: v['grads_over_limit'] for r, v in record.items()})")
  # The subprocess takes this worker's share of the cores.
  env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
  done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=600)
  assert done.returncode == 0, done.stderr[-3000:]


def test_experiments_mirror_jax():
  """The TAPIR-family presets, with the JAX package's hyperparameters."""
  for name in ("tapir", "causal_tapir", "bootstapir"):
    port, ref = configs.get_experiment(name), jax_configs.get_experiment(name)
    assert port.name == ref.name and port.model_kind == ref.model_kind == "tapir"
    assert port.total_steps == ref.total_steps
    assert port.task == trainer.TaskConfig(**dataclasses.asdict(ref.task))
    assert dataclasses.asdict(port.optimizer) == dataclasses.asdict(ref.optimizer)
    for field in dataclasses.fields(port.model_config):
      assert getattr(port.model_config, field.name) == getattr(
          ref.model_config, field.name), (name, field.name)
    assert port.loss_builder is trainer.tapir_loss_builder
    assert ref.loss_builder is None
    assert isinstance(port.build_model(), tapir.TAPIR)


def test_int8_configuration_trains_and_requantizes_each_step():
  """An int8 configuration (w8a8 mixer, per-position int8 correlation,
  per-frame int8 ExtraConvs) trains straight-through, and the int8 weights
  derived from the float ones (`layers._derived`) follow the optimizer's
  in-place updates."""
  cfg = tapir.bootstapir_config(**TINY, quantized_mixer=True,
                                quantized_corr=True, quantized_extra_convs=True)
  t = trainer.Trainer(tapir.TAPIR(cfg), optimizers.OptimizerConfig(
      warmup_steps=1), 10, task=trainer.TaskConfig(train_chunk_size=3),
                      device="cpu")
  state = t.init_state()
  batch = synthetic.make_batch(torch.Generator().manual_seed(0), 1, 3, 32, 32, 5)
  block, extra = t.model.mixer.block_0, t.model.extra
  for _ in range(2):
    state, scalars = t.step_fn(state, batch, t.step_generator(state.step))
    assert all(np.isfinite(float(v)) for v in scalars.values())
    from tapnet_tpu_torch.ops import mixer_math, qconv
    w1q, s1 = mixer_math.quantize_weight_cols(block.fc_up.weight.detach().t())
    assert torch.equal(block.quantized_weights()[0], w1q)
    assert torch.equal(block.quantized_weights()[1], s1)
    wuq, su = qconv.quantize_conv_weight(extra.conv_up_0.weight.detach())
    assert torch.equal(extra.quantized_weights(0)[0], wuq)
  assert float(scalars["gradient_norm"]) > 0


def test_training_forward_permutes_chunks_and_keeps_query_order():
  """With a generator the chunks take the queries in a drawn order, and the
  outputs come back in query order: the same values as the identity order
  in the forward."""
  cfg = tapir.bootstapir_config(**TINY)
  model = tapir.TAPIR(cfg)
  convert.load_flax_params(model, tapir.init_tapir_params(
      cfg, torch.Generator().manual_seed(1)))
  batch = synthetic.make_batch(torch.Generator().manual_seed(2), 1, 3, 32, 32, 7)
  with torch.no_grad():
    plain = model(batch["video"], batch["query_points"], query_chunk_size=3,
                  is_training=True)
    drawn = model(batch["video"], batch["query_points"], query_chunk_size=3,
                  is_training=True, generator=torch.Generator().manual_seed(0))
  for key in ("tracks", "occlusion", "expected_dist"):
    torch.testing.assert_close(drawn[key], plain[key], rtol=1e-5, atol=1e-5)
  with pytest.raises(ValueError, match="causal state"):
    grids = model.get_feature_grids(batch["video"])
    qf = model.get_query_features(batch["video"].shape, batch["query_points"],
                                  grids)
    model.estimate_trajectories((32, 32), grids, qf, is_training=True,
                                causal_state=model.construct_initial_causal_state(1, 7))


def test_bootstrap_fit_checkpoints_and_resumes(tmp_path):
  """`fit_bootstrap` with a labeled anchor writes the student, the EMA
  teacher and the optimizer; `restore_or_init_bootstrap` resumes them."""
  cfg = tapir.bootstapir_config(**TINY)
  params = tapir.init_tapir_params(cfg, torch.Generator().manual_seed(0))
  opt = optimizers.OptimizerConfig(warmup_steps=1)
  tx = optimizers.make_optimizer(opt, optimizers.make_lr_schedule(opt, 10))
  student, teacher = tapir.TAPIR(cfg), tapir.TAPIR(cfg)
  state = bootstrap.init_bootstrap_state(student, teacher, params, tx)
  gen = torch.Generator().manual_seed(3)

  def data():
    while True:
      b = synthetic.make_batch(gen, 1, 3, 32, 32, 4)
      yield {"video": b["video"], "labeled": b}

  path = str(tmp_path / "bootstrap.npy")
  config = bootstrap.BootstrapConfig(num_queries=4, query_chunk_size=2,
                                     supervised_chunk_size=2)
  state = bootstrap.fit_bootstrap(student, teacher, state, data(), tx, 2,
                                  config, log_every=1, checkpoint_path=path,
                                  checkpoint_every=2)
  assert state.step == 2
  for name, p in state.params.items():
    e = state.teacher_params[name]
    assert not e.requires_grad
    if not torch.equal(p, e):
      break
  else:
    raise AssertionError("the teacher did not lag the student")
  ckpt = checkpointing.restore_checkpoint(path)
  assert ckpt["step"] == 2
  again = bootstrap.restore_or_init_bootstrap(
      tapir.TAPIR(cfg), tapir.TAPIR(cfg), params, tx, path)
  assert again.step == 2
  for name, p in state.params.items():
    assert torch.equal(again.params[name], p), name
    assert torch.equal(again.teacher_params[name], state.teacher_params[name])
    assert torch.equal(again.opt_state["mu"][name], state.opt_state["mu"][name])


def test_run_cli_smoke_trains_and_checkpoints_on_cpu(tmp_path, capsys):
  """`python -m tapnet_tpu_torch.training.run --experiment bootstapir
  --smoke --synthetic --device cpu` trains, writes a checkpoint in the Flax
  layout, and resumes from it."""
  argv = ["--experiment", "bootstapir", "--smoke", "--synthetic",
          "--num_steps", "2", "--total_steps", "4", "--log_every", "1",
          "--device", "cpu", "--checkpoint_dir", str(tmp_path)]
  state = run.main(argv)
  assert state.step == 2
  out = capsys.readouterr().out
  assert "step 2 loss" in out and " pos " in out and "finished at step 2" in out
  ckpt = checkpointing.restore_checkpoint(str(tmp_path / "checkpoint.npy"))
  assert ckpt["step"] == 2
  smoke = run.smoke(configs.get_experiment("bootstapir"))
  assert set(golden_tool.flatten(ckpt["params"])) == set(golden_tool.flatten(
      tapir.init_tapir_params(smoke.model_config,
                              torch.Generator().manual_seed(0))))
  state = run.main(argv[:5] + ["1"] + argv[6:])
  assert state.step == 3
  with pytest.raises(ValueError, match="tapir-family"):
    run.smoke(configs.get_experiment("tapnext"))

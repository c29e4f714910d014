"""PyTorch port, TAP-Net: the temporal shift, TSM-ResNet, the tracker, its
training (both losses, the running statistics, the Trainer's checkpoint),
the Haiku checkpoint import and the CLI against the JAX package, with the
same seed-made weights through the port's converter.

Small shapes (1 clip of 3 frames at 32x32, 5 queries) in float32. Limits:
tracks 1e-4 px and logits 1e-5 (float32 sums in other orders, through the
soft-argmax's 8 px cells); features and running statistics 1e-5; the loss
1e-5 relative; each gradient leaf 1e-4 of its largest |g| plus 1e-7 of the
model's. The full-width clip is held to tools/make_tapnet_golden.py's
numbers within that tool's limits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

import jax
import jax.numpy as jnp

from tapnet_tpu.checkpoints import tapnet_checkpoint as jax_ckpt
from tapnet_tpu.models import tapnet as jax_tapnet
from tapnet_tpu.models import tsm_resnet as jax_tsm
from tapnet_tpu.training import trainer as jax_trainer
from tapnet_tpu_torch import configs
from tapnet_tpu_torch.checkpoints import convert, tapnet_checkpoint
from tapnet_tpu_torch.models import tapnet, tsm_resnet
from tapnet_tpu_torch.training import checkpointing, optimizers, run, trainer
from tools import make_tapnet_golden
from tools.tapnet_weights import seeded_tapnet_params

B, T, S, N = 1, 3, 32, 5
TRACK_TOL, LOGIT_TOL, TOL = 1e-4, 1e-5, 1e-5


def _numpy(x):
  return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                    np.float32)


def _close(port, ref, tol=TOL):
  np.testing.assert_allclose(_numpy(port), _numpy(ref), rtol=tol, atol=tol)


def _batch(seed=0, size=S, b=B, t=T, n=N):
  rng = np.random.RandomState(seed)
  video = rng.uniform(-1, 1, (b, t, size, size, 3)).astype(np.float32)
  qp = np.stack([rng.randint(0, t, (b, n)), rng.uniform(0, size, (b, n)),
                 rng.uniform(0, size, (b, n))], -1).astype(np.float32)
  target = np.clip(qp[:, :, None, [2, 1]] + rng.uniform(-3, 3, (b, n, t, 2)),
                   0, size).astype(np.float32)
  occluded = (rng.rand(b, n, t) < 0.3).astype(np.float32)
  return dict(video=video, query_points=qp, target_points=target,
              occluded=occluded)


def _torch_batch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_tapnet(params, stats):
  model = tapnet.TAPNet()
  convert.load_tapnet_params(model, params, stats)
  return model


def _stats_apart(port_model, jax_stats):
  port = convert.stats_to_flax(dict(port_model.named_buffers()))
  return max(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
      lambda a, b: float(np.abs(a - np.asarray(b)).max()), port,
      jax.tree_util.tree_map(np.asarray, dict(jax_stats)))))


# ----------------------------------------------------------- temporal shift


@pytest.mark.parametrize("fraction", [0.0, 0.125, 0.25])
@pytest.mark.parametrize("b", [1, 3])
def test_temporal_shift(fraction, b):
  x = np.random.RandomState(1).randn(4 * b, 5, 6, 16).astype(np.float32)
  ref = jax_tsm.temporal_shift(jnp.asarray(x), 4, fraction)
  out = tsm_resnet.temporal_shift(torch.from_numpy(x), 4, fraction)
  np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
  # The model's channels-first layout gives the same shift.
  nchw = tsm_resnet.temporal_shift(torch.from_numpy(x).permute(0, 3, 1, 2), 4,
                                   fraction, dim=1)
  np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(),
                                np.asarray(ref))


@pytest.mark.parametrize("fraction", [0.0, 0.125])
def test_temporal_shift_image_mode(fraction):
  x = np.random.RandomState(2).randn(3, 4, 4, 16).astype(np.float32)
  ref = jax_tsm.temporal_shift_image_mode(jnp.asarray(x), fraction, 0.3)
  out = tsm_resnet.temporal_shift_image_mode(torch.from_numpy(x), fraction, 0.3)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-7, atol=0)


# ----------------------------------------------------------- TSM-ResNet-18


def _backbone_tree(config, endpoint, video, seed=0):
  """Seed-made params and running statistics of JAX's TSMResNetV2 up to
  `endpoint`, at the Flax initialisers' scales."""
  shapes = jax.eval_shape(
      lambda v: jax_tsm.TSMResNetV2(config).init(
          jax.random.PRNGKey(0), v, is_training=False,
          final_endpoint=endpoint), video)
  rng = np.random.RandomState(seed)

  def fill(path, s):
    name = path[-1].key
    if name == "kernel":
      return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
              ).astype(np.float32)
    if name == "mean":
      return (rng.randn(*s.shape) * 0.1).astype(np.float32)
    if name == "var":
      return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
    return ((1.0 if name == "scale" else 0.0)
            + rng.randn(*s.shape) * 0.02).astype(np.float32)

  tree = jax.tree_util.tree_map_with_path(fill, shapes)
  return tree["params"], tree["batch_stats"]


@pytest.mark.parametrize("stride,endpoint,size", [
    (8, "unit_2", (32, 32)),
    (32, "embeddings", (32, 32)),
    (8, "last_conv", (33, 29)),  # odd sizes: SAME pads unevenly
])
@pytest.mark.parametrize("is_training", [False, True])
def test_tsm_resnet18(stride, endpoint, size, is_training):
  """The backbone against Flax's, outputs within 1e-4 (TOL for the pooled
  embeddings), or 3 x JAX's own distance when the video is nudged 16
  float32 ulps, whichever is larger: training at stride 32 normalizes unit
  3's 1 x 1 maps over the batch's 3 frames, where E[x^2] - E[x]^2 leaves
  only float32 noise."""
  config = jax_tsm.TSMResNetConfig(output_stride=stride)
  rng = np.random.RandomState(3)
  video = rng.uniform(-1, 1, (B, T) + size + (3,)).astype(np.float32)
  params, stats = _backbone_tree(config, endpoint, video)
  apply = lambda v: jax_tsm.TSMResNetV2(config).apply(
      {"params": params, "batch_stats": stats}, v,
      is_training=is_training, final_endpoint=endpoint,
      mutable=["batch_stats"])
  ref, moved = apply(video)
  witness = np.abs(np.asarray(apply(make_tapnet_golden.nudged_video(video))[0])
                   - np.asarray(ref)).max()
  model = tsm_resnet.TSMResNetV2(
      tsm_resnet.TSMResNetConfig(output_stride=stride), endpoint)
  convert.load_tapnet_params(model, params, stats)
  out = model(torch.from_numpy(video), is_training=is_training)
  assert out.shape == ref.shape
  base = 1e-4 if endpoint != "embeddings" else TOL
  _close(out, ref, max(base, 3 * float(witness)))
  assert _stats_apart(model, moved["batch_stats"]) <= TOL
  if is_training:  # the running statistics moved
    assert _stats_apart(model, stats) > 1e-3


def test_batch_norm_is_flax_batch_norm():
  """Momentum 0.9 as ra <- 0.9 ra + 0.1 batch, the biased fast variance, and
  the running statistics in eval; torch's BatchNorm2d differs on both."""
  x = np.random.RandomState(4).randn(6, 8, 5, 5).astype(np.float32) * 2 + 1
  norm = tsm_resnet.BatchNorm(8)
  out = norm(torch.from_numpy(x), is_training=True)
  mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3))
  _close(norm.mean, 0.1 * mean, 1e-6)
  _close(norm.var, 0.9 + 0.1 * var, 1e-6)
  _close(out, (x - mean[:, None, None]) / np.sqrt(var[:, None, None] + 1e-5),
         1e-5)
  torch_bn = torch.nn.BatchNorm2d(8, momentum=0.1)
  torch_bn(torch.from_numpy(x))
  assert not np.allclose(torch_bn.running_var.numpy(), norm.var.numpy(),
                         atol=1e-4)
  evaluated = norm(torch.from_numpy(x), is_training=False)
  _close(evaluated, (x - norm.mean.numpy()[:, None, None])
         / np.sqrt(norm.var.numpy()[:, None, None] + 1e-5), 1e-5)


# ------------------------------------------------------------------ TAP-Net


@pytest.fixture(scope="module")
def weights():
  return seeded_tapnet_params(jax_tapnet.TapNetConfig(), 0)


@pytest.mark.parametrize("is_training", [False, True])
def test_tapnet_forward(weights, is_training):
  params, stats = weights
  batch = _batch()
  ref, moved = jax.jit(lambda v, q: jax_tapnet.TAPNet().apply(
      {"params": params, "batch_stats": stats}, v, q, is_training=is_training,
      get_query_feats=True, mutable=["batch_stats"]))(batch["video"],
                                                       batch["query_points"])
  model = _port_tapnet(params, stats)
  tb = _torch_batch(batch)
  out = model(tb["video"], tb["query_points"], query_chunk_size=2,
              is_training=is_training, get_query_feats=True)
  _close(out["tracks"], ref["tracks"], TRACK_TOL)
  _close(out["occlusion"], ref["occlusion"], LOGIT_TOL)
  _close(out["feature_grid"], ref["feature_grid"])
  _close(out["query_feats"], ref["query_feats"])
  assert _stats_apart(model, moved["batch_stats"]) <= TOL
  # Chunked against one pass, and a reused feature grid.
  with torch.no_grad():
    whole = model(tb["video"], tb["query_points"],
                  feature_grid=out["feature_grid"])
  _close(whole["tracks"], out["tracks"], TRACK_TOL)
  _close(whole["occlusion"], out["occlusion"], LOGIT_TOL)


def test_tapnet_ignores_generator(weights):
  model = _port_tapnet(*weights).eval()
  tb = _torch_batch(_batch())
  with torch.no_grad():
    a = model(tb["video"], tb["query_points"])
    b = model(tb["video"], tb["query_points"],
              generator=torch.Generator().manual_seed(5))
  np.testing.assert_array_equal(a["tracks"].numpy(), b["tracks"].numpy())


def _value_and_grads(loss, params, stats, batch, dtype):
  """(JAX's loss, scalars, moved stats, grads; the port's the same) of one
  value_and_grad in `dtype` on both sides."""
  cast = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                             tree)
  params, stats, batch = cast(params), cast(stats), cast(batch)
  task = jax_trainer.TaskConfig(train_chunk_size=2)
  jax_builder = (jax_trainer.tapir_loss_builder if loss == "tap"
                 else jax_trainer.contrastive_loss_builder)
  ref = jax.jit(jax.value_and_grad(jax_builder(jax_tapnet.TAPNet(), task),
                                   has_aux=True))(
      params, {"batch_stats": stats},
      {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
  model = _port_tapnet(params, stats).to(getattr(torch, np.dtype(dtype).name))
  builder = (trainer.tapir_loss_builder if loss == "tap"
             else trainer.contrastive_loss_builder)
  port = trainer.loss_and_grads(
      builder(model, trainer.TaskConfig(train_chunk_size=2)),
      dict(model.named_parameters()), _torch_batch(batch),
      torch.Generator().manual_seed(0))
  return ref, port, model


@pytest.mark.parametrize("loss", ["tap", "contrastive"])
def test_tapnet_value_and_grad(weights, loss):
  """One value_and_grad of each loss against jax.value_and_grad. float32:
  the loss and scalars within 1e-5 relative and the running statistics
  after the step. The gradients leaf by leaf in float64 on both sides
  (jax.enable_x64): in float32 a ReLU input within float32 noise of zero
  (-1.05e-6 in JAX, +8.5e-7 in the port, at unit_2_block_0's norm_1 here)
  takes its gradient on one side only and moves whole leaves upstream by
  up to 25%, between any two float32 implementations; the full-width
  float32 gradients are held by test_tapnet_golden's fingerprints."""
  params, stats = weights
  batch = _batch(seed=6)
  ref, port, model = _value_and_grads(loss, params, stats, batch, np.float32)
  (ref_loss, (ref_scalars, moved)), _ = ref
  value, scalars, _ = port
  np.testing.assert_allclose(float(value), float(ref_loss), rtol=1e-5)
  assert set(scalars) == set(ref_scalars)
  for k, v in scalars.items():
    np.testing.assert_allclose(float(v), float(ref_scalars[k]), rtol=1e-5,
                               atol=1e-7)
  assert _stats_apart(model, moved["batch_stats"]) <= TOL
  with jax.enable_x64(True):
    ref, port, _ = _value_and_grads(loss, params, stats, batch, np.float64)
    (ref_loss, _), ref_grads = ref
    value, _, grads = port
    assert ref_loss.dtype == jnp.float64 and value.dtype == torch.float64
    np.testing.assert_allclose(float(value), float(ref_loss), rtol=1e-5)
    port_tree = convert.state_dict_to_tapnet(grads)
    gmax = max(float(np.abs(g).max())
               for g in jax.tree_util.tree_leaves(ref_grads))
    for path, ref in jax.tree_util.tree_flatten_with_path(ref_grads)[0]:
      node = port_tree
      for key in path:
        node = node[key.key]
      ref = np.asarray(ref)
      tol = 1e-4 * np.abs(ref).max() + 1e-7 * gmax
      np.testing.assert_allclose(node, ref, rtol=0, atol=tol,
                                 err_msg=jax.tree_util.keystr(path))


def test_tapnet_golden():
  """The full-width clip against tools/make_tapnet_golden.py's JAX numbers,
  within that tool's limits."""
  golden = np.load(make_tapnet_golden.OUT)
  r = make_tapnet_golden.judge(golden, make_tapnet_golden.run_port("cpu"))
  assert r["ok"], r


# ----------------------------------------------------- training and the CLI


def test_trainer_checkpoint_flax_layout(tmp_path, weights):
  """A Trainer step moves the running statistics; the checkpoint holds them
  as Flax's batch_stats, which JAX's TAP-Net applies as they are, and a new
  Trainer restores them."""
  path = str(tmp_path / "checkpoint.npy")
  exp = run.smoke(configs.get_experiment("tapnet"))
  t = trainer.Trainer(exp.build_model(), exp.optimizer, total_steps=10,
                      task=exp.task, checkpoint_path=path,
                      loss_builder=exp.loss_builder, device="cpu")
  state = t.init_state()
  assert set(state.model_state) == {"batch_stats"}
  fresh = {k: v.clone() for k, v in state.model_state["batch_stats"].items()}
  batch = _torch_batch(_batch(seed=7))
  state, scalars = t.step_fn(state, batch, t.step_generator(state.step))
  assert np.isfinite(float(scalars["loss"]))
  moved = state.model_state["batch_stats"]
  assert any(not torch.equal(fresh[k], moved[k]) for k in fresh)
  t.save(state)
  ckpt = checkpointing.restore_checkpoint(path)
  stats = ckpt["model_state"]["batch_stats"]
  assert stats["backbone"]["unit_0_block_0"]["norm_pre"]["mean"].shape == (64,)
  assert ckpt["params"]["heads"]["pos_conv"]["kernel"].shape == (1, 3, 3, 1, 16)
  ref = jax_tapnet.TAPNet().apply(
      {"params": ckpt["params"], "batch_stats": stats},
      batch["video"].numpy(), batch["query_points"].numpy())
  t.model.eval()
  with torch.no_grad():
    out = t.model(batch["video"], batch["query_points"])
  _close(out["tracks"], ref["tracks"], TRACK_TOL)
  t2 = trainer.Trainer(exp.build_model(), exp.optimizer, total_steps=10,
                       task=exp.task, checkpoint_path=path, device="cpu")
  restored = t2.restore_or_init()
  assert restored.step == 1
  for k, v in restored.model_state["batch_stats"].items():
    np.testing.assert_array_equal(v.numpy(), moved[k].numpy())
  for k, v in restored.params.items():
    np.testing.assert_array_equal(v.detach().numpy(),
                                  state.params[k].detach().numpy())


def test_tapnet_init_matches_flax_statistics():
  """init_tapnet_params: the Flax tree's structure and shapes, LeCun's
  scale per kernel, fresh running statistics."""
  params, stats = tapnet.init_tapnet_params(tapnet.TapNetConfig(),
                                            torch.Generator().manual_seed(0))
  shapes = jax.eval_shape(
      lambda v, q: jax_tapnet.TAPNet().init(jax.random.PRNGKey(0), v, q,
                                            is_training=True),
      jnp.zeros((1, 2, 32, 32, 3)), jnp.zeros((1, 2, 3)))
  same = jax.tree_util.tree_map(lambda s, a: s.shape == a.shape,
                                dict(shapes["params"]), params)
  assert all(jax.tree_util.tree_leaves(same))
  same = jax.tree_util.tree_map(lambda s, a: s.shape == a.shape,
                                dict(shapes["batch_stats"]), stats)
  assert all(jax.tree_util.tree_leaves(same))
  kernel = params["backbone"]["unit_1_block_0"]["conv_0"]["kernel"]
  np.testing.assert_allclose(kernel.std(), 1 / np.sqrt(9 * 64), rtol=0.05)
  assert (stats["backbone"]["unit_0_block_0"]["norm_pre"]["var"] == 1).all()


def test_training_cli_tapnet(tmp_path):
  state = run.main(["--experiment", "tapnet", "--synthetic", "--smoke",
                    "--num_steps", "2", "--log_every", "1", "--device", "cpu",
                    "--checkpoint_dir", str(tmp_path)])
  assert state.step == 2
  assert all(torch.isfinite(p).all() for p in state.params.values())
  ckpt = checkpointing.restore_checkpoint(str(tmp_path / "checkpoint.npy"))
  assert "batch_stats" in ckpt["model_state"]


def test_tapnet_experiment_registered():
  """The preset, with the JAX package's hyperparameters; the TAP loss, as
  JAX's Trainer default."""
  from tapnet_tpu import configs as jax_configs
  exp, ref = configs.get_experiment("tapnet"), jax_configs.get_experiment("tapnet")
  assert isinstance(exp.build_model(), tapnet.TAPNet)
  assert exp.loss_builder is trainer.tapir_loss_builder
  assert ref.loss_builder is None and ref.model_kind == exp.model_kind
  assert exp.optimizer == optimizers.OptimizerConfig(
      base_lr=2e-3, weight_decay=1e-2, warmup_steps=5000)
  for field in ("base_lr", "weight_decay", "warmup_steps", "adam_b1",
                "adam_b2", "max_norm"):
    assert getattr(exp.optimizer, field) == getattr(ref.optimizer, field)
  assert exp.total_steps == ref.total_steps
  assert exp.task.train_chunk_size == ref.task.train_chunk_size
  assert (exp.data.batch_size, exp.data.num_frames, exp.data.num_queries,
          exp.data.train_size) == (ref.data.batch_size, ref.data.num_frames,
                                   ref.data.num_queries, ref.data.train_size)
  assert (dataclasses.asdict(exp.model_config)
          == dataclasses.asdict(ref.model_config))
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="device='cpu'"):
      run.main(["--experiment", "tapnet", "--synthetic", "--num_steps", "1"])


# -------------------------------------------------------------- checkpoints


def _fabricated_haiku():
  """A Haiku TAP-Net dict with one of each kind of module and state."""
  rng = np.random.RandomState(8)
  a = lambda *s: rng.randn(*s).astype(np.float32)
  root = "tap_net/~/tsm_resnet_video"
  unit = f"{root}/~/tsm_resnet_unit_0/~/block_0/~"
  params = {
      f"{root}/~/tsm_resnet_stem/~/conv2d": {"w": a(7, 7, 3, 64)},
      f"{unit}/batch_norm": {"scale": a(1, 1, 1, 64), "offset": a(1, 1, 1, 64)},
      f"{unit}/batch_norm_1": {"scale": a(1, 1, 1, 64),
                               "offset": a(1, 1, 1, 64)},
      f"{unit}/shortcut_conv": {"w": a(1, 1, 64, 64)},
      f"{unit}/conv_0": {"w": a(3, 3, 64, 64)},
      f"{root}/~/batch_norm": {"scale": a(1, 1, 1, 8), "offset": a(1, 1, 1, 8)},
      "tap_net/~/cost_volume_regression_1": {"w": a(1, 3, 3, 1, 16),
                                             "b": a(16)},
      "tap_net/~/occlusion_out": {"w": a(16, 1), "b": a(1)},
  }
  state = {
      f"{unit}/batch_norm/~/mean_ema": {"average": a(1, 1, 1, 64),
                                        "counter": np.zeros(())},
      f"{unit}/batch_norm_1/~/var_ema": {"average": a(1, 1, 1, 64),
                                         "counter": np.zeros(())},
  }
  return params, state


def test_convert_haiku_tapnet_equals_jax(tmp_path):
  hk_params, hk_state = _fabricated_haiku()
  ref = jax_ckpt.convert_haiku_tapnet(hk_params, hk_state)
  out = tapnet_checkpoint.convert_haiku_tapnet(hk_params, hk_state)
  eq = jax.tree_util.tree_map(np.array_equal, ref, out)
  assert all(jax.tree_util.tree_leaves(eq))
  assert (jax.tree_util.tree_structure(ref)
          == jax.tree_util.tree_structure(out))
  path = str(tmp_path / "tapnet.npy")
  np.save(path, {"params": hk_params, "state": hk_state}, allow_pickle=True)
  loaded = tapnet_checkpoint.load_tapnet_checkpoint(path)
  eq = jax.tree_util.tree_map(np.array_equal, ref, loaded)
  assert all(jax.tree_util.tree_leaves(eq))


def test_load_drops_backbone_past_the_endpoint(weights):
  """A released checkpoint holds the whole backbone; TAP-Net's modules past
  unit_2 are dropped as Flax ignores them, and anything else unknown
  raises."""
  params, stats = weights
  extra = dict(params, backbone=dict(
      params["backbone"],
      unit_3_block_0={"conv_0": {"kernel": np.zeros((3, 3, 256, 512),
                                                    np.float32)}},
      final_norm={"scale": np.ones(512, np.float32)}))
  model = _port_tapnet(extra, stats)
  reference = _port_tapnet(params, stats)
  for k, v in model.state_dict().items():
    np.testing.assert_array_equal(v.numpy(), reference.state_dict()[k].numpy())
  with pytest.raises(ValueError, match="no model parameter"):
    _port_tapnet(dict(params, extra_head={"bias": np.zeros(1, np.float32)}),
                 stats)

"""PyTorch port, multi-device layer (`tapnet_tpu_torch/parallel/`) on the
CPU: 2 and 4 gloo ranks spawned by `parallel.launch.run_ranks`, each a fresh
process without JAX (tests/_parallel_ranks.py), held against the JAX package
on its virtual CPU mesh over `jax.devices()[:P]` (so that JAX pads frames
and queries as the port does) or against the JAX numbers of the training
goldens, which GSPMD's sharded step equals (tests/test_training.py).

One spawn per rank count runs every case (the ranks start once). The
tolerances are JAX's own: 1e-5 for the sequence-parallel scan and conv
(values and gradients; tests/test_sequence_parallel.py), TAPNext's sp
forward 1e-4 (tracks 1e-3) and gradients 1e-3 relative + 1e-4, the sharded
predictor 1e-4 relative + 1e-3 (tests/test_multichip_inference.py), and a
training step within its golden's limits (tools/make_tapir_train_golden.py,
tools/make_tapnext_train_golden.py); TAP-Net's step, whose float32 ReLU
masks flip between any two implementations, in float64 on both sides
within tests/test_torch_tapnet.py's limits.
"""

import concurrent.futures
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

import jax
import jax.numpy as jnp

import _parallel_ranks
from tapnet_tpu import inference as jax_inference
from tapnet_tpu.models import rglru as jax_rglru
from tapnet_tpu.models import ssm_vit as jax_ssm_vit
from tapnet_tpu.models import tapir as jax_tapir
from tapnet_tpu.models import tapnet as jax_tapnet
from tapnet_tpu.models import tapnext as jax_tapnext
from tapnet_tpu.ops import scan as jax_scan
from tapnet_tpu.parallel import mesh as jax_mesh
from tapnet_tpu.parallel import sequence as jax_sequence
from tapnet_tpu.training import trainer as jax_trainer
from tapnet_tpu_torch.inference import TapirPredictor
from tapnet_tpu_torch.models import rglru, tapir
from tapnet_tpu_torch.parallel import launch
from tapnet_tpu_torch.parallel import mesh as mesh_lib
from tapnet_tpu_torch.training import run
from tools import make_tapir_train_golden as tapir_golden
from tools import make_tapnext_train_golden as tapnext_golden
from tools.tapnet_weights import seeded_tapnet_params
from tools.tapnext_weights import seeded_tapnext_params

RANKS = (2, 4)
B, T, C = 2, 16, 16
BAD_T = 15  # divisible by neither rank count
CONV_T = 4  # parts of 2 and 1 frames: shorter than the kernel's history
SCAN_TOL = 1e-5
TAPNEXT_CONFIG = dict(width=32, depth=2, mlp_dim=64, num_heads=2,
                      image_size=(32, 32), posemb_full="sincos2d")
TAPIR_CONFIG = dict(num_mixer_blocks=2, num_pips_iter=2, pyramid_level=0,
                    initial_resolution=(32, 32), blocks_per_group=(1, 1, 1, 1))
TAPIR_FRAMES = 6  # 4 ranks pad it to 8 by repeating the last frame
# Model-parallel sizes of each case, by rank count.
TAPIR_TRAIN_MP = {2: [1], 4: [2]}
OTHER_MP = {2: 1, 4: 2}
TAPNEXT_TRAIN_MP = {2: 2, 4: 2}


def _jax_mesh(p):
  return jax_mesh.make_mesh(jax.devices()[:p], model_parallel=1)


def _spec(p, tmp):
  rng = np.random.RandomState(0)
  f32 = lambda x: np.asarray(x, np.float32)
  spec = dict(
      x=f32(rng.randn(B, T, C) * 0.1), a=f32(rng.rand(B, T, C) * 0.5 + 0.4),
      h0=f32(rng.randn(B, C) * 0.1), bad_t=BAD_T,
      conv_x=f32(rng.randn(B, 2 * CONV_T, C)), conv_w=f32(rng.randn(4, C) * 0.3),
      conv_b=f32(rng.randn(C) * 0.1), conv_t=CONV_T,
      tapnext_config=TAPNEXT_CONFIG,
      tapnext_video=f32(rng.rand(1, 8, 32, 32, 3) * 2 - 1),
      tapnext_qp=f32(np.stack([rng.randint(0, 8, 3), rng.rand(3) * 32,
                               rng.rand(3) * 32], -1)[None]),
      tapir_config=TAPIR_CONFIG,
      tapir_video=f32(rng.rand(1, TAPIR_FRAMES, 64, 64, 3) * 2 - 1),
      tapir_queries=f32(np.stack([rng.randint(0, TAPIR_FRAMES, 16),
                                  rng.rand(16) * 64, rng.rand(16) * 64],
                                 -1)[None]),
      tapir_train_mp=TAPIR_TRAIN_MP[p], tapnext_train_mp=TAPNEXT_TRAIN_MP[p],
      tapnet_mp=OTHER_MP[p], bootstrap_mp=OTHER_MP[p], tmp=str(tmp),
  )
  for name, bidir in (("uni", False), ("bidir", True)):
    cfg = jax_ssm_vit.SsmVitConfig(**TAPNEXT_CONFIG, bidirectional_ssm=bidir)
    spec[f"tapnext_params_{name}"] = seeded_tapnext_params(cfg, 0)
  noise = np.random.RandomState(1)
  spec["tapir_params"] = jax.tree_util.tree_map(
      lambda v: f32(v + 0.05 * noise.randn(*np.shape(v))),
      tapir.init_tapir_params(tapir.TapirConfig(**TAPIR_CONFIG),
                              torch.Generator().manual_seed(0)))
  spec["tapnet_weights"] = seeded_tapnet_params(jax_tapnet.TapNetConfig(), 0)
  spec["tapnet_batch"] = _tapnet_batch()
  spec["cases"] = ["sp_scan", "sp_conv", "tapnext_sp", "predictor",
                   "tapir_train", "tapnext_train", "tapnet_train",
                   "fit_bootstrap"] + (["run_cli"] if p == 2 else [])
  return spec


def _tapnet_batch(seed=6, b=2, t=3, size=32, n=4):
  rng = np.random.RandomState(seed)
  video = rng.uniform(-1, 1, (b, t, size, size, 3))
  qp = np.stack([rng.randint(0, t, (b, n)), rng.uniform(0, size, (b, n)),
                 rng.uniform(0, size, (b, n))], -1)
  target = np.clip(qp[:, :, None, [2, 1]] + rng.uniform(-3, 3, (b, n, t, 2)),
                   0, size)
  occluded = (rng.rand(b, n, t) < 0.3)
  return {k: np.asarray(v, np.float64) for k, v in dict(
      video=video, query_points=qp, target_points=target,
      occluded=occluded).items()}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
  """{P: (spec, [rank results], JAX's references)}: every case on P gloo
  ranks, the rank counts' spawns at once and JAX's references computed
  meanwhile."""
  specs = {p: _spec(p, tmp_path_factory.mktemp(f"ranks{p}")) for p in RANKS}
  with concurrent.futures.ThreadPoolExecutor(len(RANKS)) as pool:
    futures = {p: pool.submit(
        launch.run_ranks, _parallel_ranks.run_cases, p, "gloo", "cpu",
        specs[p], num_threads=1, timeout=900) for p in RANKS}
    refs = {p: _references(specs[p], p) for p in RANKS}
    tapnet = _tapnet_reference()
    for ref in refs.values():
      ref["tapnet"] = tapnet
    return {p: (specs[p], futures[p].result(), refs[p]) for p in RANKS}


def _references(spec, p):
  """JAX's numbers for the cases, on its mesh over `jax.devices()[:p]`."""
  return dict(scan=_jax_scan(spec, p), conv=_jax_conv(spec, p),
              uni=_jax_tapnext(spec, p, False),
              bidir=_jax_tapnext(spec, p, True),
              predictor=_jax_predictor(spec, p))


def _case(spawned, p, name, rank=0):
  spec, results, ref = spawned[p]
  got = results[rank][name]
  assert "error" not in got, got["error"]
  return spec, got, ref


def _close(got, want, tol, atol=None):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                             atol=tol if atol is None else atol)


# ------------------------------------------------------ sequence parallelism


def _jax_scan(spec, p):
  """(y, h, dx, da) of sum(y^2) + sum(h^2), the single-device scan's
  (y, h), and y from a zero h0."""
  mesh = _jax_mesh(p)
  x, a, h0 = (jnp.asarray(spec[k]) for k in ("x", "a", "h0"))

  def loss(x_, a_):
    y, h = jax_sequence.sequence_parallel_linear_scan(x_, a_, h0, mesh)
    return jnp.sum(y ** 2) + jnp.sum(h ** 2), (y, h)

  (_, (y, h)), (gx, ga) = jax.jit(jax.value_and_grad(
      loss, (0, 1), has_aux=True))(x, a)
  y0, _ = jax.jit(lambda x_, a_: jax_sequence.sequence_parallel_linear_scan(
      x_, a_, None, mesh))(x, a)
  one = jax.jit(jax_scan.linear_scan)(x, a, h0)
  return jax.device_get((y, h, gx, ga, one, y0))


@pytest.mark.parametrize("p", RANKS)
def test_sp_scan_values_and_gradients(spawned, p):
  _, got, ref = _case(spawned, p, "sp_scan")
  y, h, gx, ga, (y1, h1), _ = ref["scan"]
  for key, want in (("y", y), ("h", h), ("gx", gx), ("ga", ga)):
    _close(got[key], want, SCAN_TOL)
  # The single-device scan, too.
  _close(got["y"], y1, SCAN_TOL)
  _close(got["h"], h1, SCAN_TOL)
  # Every rank returns the same final state.
  for r in range(p):
    np.testing.assert_array_equal(spawned[p][1][r]["sp_scan"]["h"], got["h"])


@pytest.mark.parametrize("p", RANKS)
def test_sp_scan_zero_h0(spawned, p):
  _, got, ref = _case(spawned, p, "sp_scan")
  _close(got["y_zero_h0"], ref["scan"][-1], SCAN_TOL)


@pytest.mark.parametrize("p", RANKS)
def test_sp_refuses_indivisible_time(spawned, p):
  _, got, _ = _case(spawned, p, "sp_scan")
  assert "not divisible" in got["refused"]
  _, got, _ = _case(spawned, p, "tapnext_sp")
  assert "not divisible" in got["refused"]
  # JAX's rule: a streaming step of one frame takes the local path, an
  # indivisible length raises.
  ours = type("M", (), {"size": lambda self, axis: p})()
  theirs = type("M", (), {"shape": {"data": p}})()
  for t in (1, 8):
    assert (rglru.sp_active((ours, "data"), t)
            == jax_rglru.sp_active((theirs, "data"), t) == (t > 1))
  for rule, mesh in ((rglru.sp_active, ours), (jax_rglru.sp_active, theirs)):
    with pytest.raises(ValueError, match="not divisible"):
      rule((mesh, "data"), BAD_T)


@pytest.mark.parametrize("p", RANKS)
def test_sp_conv_short_parts_and_cache(spawned, p):
  """Parts shorter than the kernel's k-1 frames of history, a second clip
  continuing from the first's cache, and the gradients of both."""
  _, got, ref = _case(spawned, p, "sp_conv")
  for key, want in zip(("y1", "y2", "cache", "cache2", "gx", "gw", "gb"),
                       ref["conv"]):
    _close(got[key], want, SCAN_TOL)


def _jax_conv(spec, p):
  mesh = _jax_mesh(p)
  x, w, b = (jnp.asarray(spec[k]) for k in ("conv_x", "conv_w", "conv_b"))

  def loss(x_, w_, b_):
    y1, cache = jax_sequence.sequence_parallel_causal_conv(
        x_[:, :CONV_T], w_, b_, None, mesh)
    y2, cache2 = jax_sequence.sequence_parallel_causal_conv(
        x_[:, CONV_T:], w_, b_, cache, mesh)
    return (jnp.sum(y1 ** 2) + jnp.sum(y2 ** 2) + jnp.sum(cache2 ** 2),
            (y1, y2, cache, cache2))

  (_, outs), grads = jax.jit(jax.value_and_grad(
      loss, (0, 1, 2), has_aux=True))(x, w, b)
  return jax.device_get(tuple(outs) + tuple(grads))


def _jax_tapnext(spec, p, bidir):
  cfg = jax_ssm_vit.SsmVitConfig(**TAPNEXT_CONFIG, bidirectional_ssm=bidir,
                                 sp_mesh=_jax_mesh(p), sp_axis="data")
  model = jax_tapnext.TAPNextTracker(config=cfg)
  params = spec["tapnext_params_bidir" if bidir else "tapnext_params_uni"]
  video, qp = jnp.asarray(spec["tapnext_video"]), jnp.asarray(spec["tapnext_qp"])

  def loss(prm):
    r = model.apply({"params": prm}, video, qp)
    return (jnp.mean(r.track_logits ** 2) + jnp.mean(r.visible_logits ** 2),
            (r.tracks, r.track_logits, r.visible_logits))

  (_, outs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
  return jax.device_get((outs, grads))


def _check_tapnext(got, outs, grads):
  tracks, logits, vis = outs
  _close(got["track_logits"], logits, 1e-4)
  _close(got["visible_logits"], vis, 1e-4)
  # The port's tracks are [B, Q, T, 2], (y, x): JAX's layout.
  _close(got["tracks"], tracks, 1e-4, 1e-3)
  for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
    node = got["grads"]
    for key in path:
      node = node[key.key]
    np.testing.assert_allclose(node, np.asarray(leaf), rtol=1e-3, atol=1e-4,
                               err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("p", RANKS)
def test_tapnext_sp_forward_and_gradients(spawned, p):
  """The whole TAPNext with its clip split over time (the global-frame-0
  rule of the RG-LRU on the first rank only) against JAX's sp model."""
  _, got, ref = _case(spawned, p, "tapnext_sp")
  _check_tapnext(got["uni"], *ref["uni"])


@pytest.mark.parametrize("p", RANKS)
def test_tapnext_sp_predictor_in_chunks(spawned, p):
  """`TapnextPredictor(mesh=..., chunk_size=4)`: each chunk split over the
  ranks (one frame a rank at 4 ranks) with the recurrent state and the conv
  window carried in, against JAX's one pass."""
  _, got, ref = _case(spawned, p, "tapnext_sp")
  tracks, _, vis = ref["uni"][0]
  _close(got["chunked"]["tracks"], np.flip(tracks, -1), 1e-4, 1e-3)
  _close(got["chunked"]["occlusion"], -vis[..., 0], 1e-4)


@pytest.mark.parametrize("p", RANKS)
def test_tapnext_sp_bidirectional(spawned, p):
  """`bidirectional_ssm`: the time-reversed half is reversed globally."""
  _, got, ref = _case(spawned, p, "tapnext_sp")
  _check_tapnext(got["bidir"], *ref["bidir"])


# ---------------------------------------------------------- sharded serving


@pytest.mark.parametrize("p", RANKS)
def test_sharded_predictor(spawned, p):
  """`TapirPredictor(mesh=...)`: frames over the ranks for the backbone,
  queries for the refinement, a clip length 4 ranks must pad; against JAX's
  sharded predictor and the port's one-rank predictor with the same
  padding. Every rank returns the whole outputs and ran the refinement's
  correlations and mixer blocks."""
  spec, got, ref = _case(spawned, p, "predictor")
  ref = ref["predictor"]
  one = TapirPredictor(spec["tapir_params"], tapir.TapirConfig(**TAPIR_CONFIG),
                       query_bucket=16, query_chunk_size=None,
                       frame_bucket=p, device="cpu")(
                           spec["tapir_video"], spec["tapir_queries"])
  for r in range(p):
    out = spawned[p][1][r]["predictor"]
    assert out["tracks"].shape == (1, 16, TAPIR_FRAMES, 2)
    assert out["calls"]["corr"] > 0 and out["calls"]["mixer"] > 0
    for key in ("tracks", "occlusion", "expected_dist"):
      _close(out[key], ref[key], 1e-4, 1e-3)
      _close(out[key], one[key], 1e-4, 1e-3)


def _jax_predictor(spec, p):
  return jax_inference.TapirPredictor(
      jax.tree_util.tree_map(jnp.asarray, spec["tapir_params"]),
      config=jax_tapir.TapirConfig(**TAPIR_CONFIG), query_bucket=16,
      query_chunk_size=None, mesh=_jax_mesh(p))(
          spec["tapir_video"], spec["tapir_queries"])


# ----------------------------------------------------------------- training


def _judge_first_step(golden, got, run_name):
  """The first step's scalars and gradients within the TAPIR golden's
  limits (`make_tapir_train_golden.judge`'s, for one step)."""
  failures = []
  for sname, value in got["scalars"][0].items():
    want = float(golden[f"{run_name}/scalar/{sname}"][0])
    limit = tapir_golden.scalar_limit(golden, run_name, sname, 0)
    if abs(value - want) > limit:
      failures.append(f"{sname}: {value} vs {want}")
  for key in golden["keys"]:
    idx = golden[f"samples/{key}"]
    limit = tapir_golden.grad_limit(golden, run_name, key, 0)
    grads = np.asarray(got["grads"][key], np.float64).ravel()
    want = golden[f"{run_name}/grad/{key}"][0].astype(np.float64)
    if float(np.max(np.abs(grads[idx] - want))) > limit:
      failures.append(f"gradient {key}")
  return failures


@pytest.mark.parametrize("p", RANKS)
def test_tapir_train_step(spawned, p):
  """One Trainer step of the TAPIR golden's "permuted" run (JAX's query
  order, two chunks of which only the first keeps the refinement's
  gradient) with the clips over "data" and the queries over "model"."""
  _, got, _ = _case(spawned, p, "tapir_train")
  golden = tapir_golden.load()
  for mp, out in got.items():
    failures = _judge_first_step(golden, out, "permuted")
    assert not failures, (mp, failures[:5])


@pytest.mark.parametrize("p", RANKS)
def test_tapnext_train_steps_model_parallel(spawned, p):
  """The TAPNext training golden's three steps (whole-clip loss) with the
  queries split over "model": the model ranks run the whole query set and
  share the loss, whose mask counts are summed over the ranks."""
  _, got, _ = _case(spawned, p, "tapnext_train")
  _, failures = tapnext_golden.judge(tapnext_golden.load(), got,
                                     builders=("full",))
  assert not failures, failures[:5]


def _tapnet_reference():
  """JAX's float64 value_and_grad of TAP-Net's TAP loss on the global batch
  (its moved running statistics are the global batch's)."""
  params, stats = seeded_tapnet_params(jax_tapnet.TapNetConfig(), 0)
  batch = _tapnet_batch()
  with jax.enable_x64(True):
    cast = lambda tree: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64), tree)
    fn = jax.value_and_grad(jax_trainer.tapir_loss_builder(
        jax_tapnet.TAPNet(), jax_trainer.TaskConfig(train_chunk_size=2)),
                            has_aux=True)
    (loss, (scalars, moved)), grads = jax.jit(fn)(
        cast(params), {"batch_stats": cast(stats)}, cast(batch),
        jax.random.PRNGKey(0))
    return jax.device_get((loss, scalars, moved["batch_stats"], grads))


@pytest.mark.parametrize("p", RANKS)
def test_tapnet_train_step_global_batch_norm(spawned, p):
  """TAP-Net's step with the batch split over "data": its BatchNorm
  statistics (and so its forward, loss, gradients and running statistics)
  are the global batch's."""
  _, got, ref = _case(spawned, p, "tapnet_train")
  loss, scalars, stats, grads = ref["tapnet"]
  np.testing.assert_allclose(got["scalars"]["loss"], float(loss), rtol=1e-5)
  for k, v in scalars.items():
    np.testing.assert_allclose(got["scalars"][k], float(v), rtol=1e-5,
                               atol=1e-7)
  for path, want in jax.tree_util.tree_flatten_with_path(stats)[0]:
    node = got["stats"]
    for key in path:
      node = node[key.key]
    _close(node, want, 0, 1e-5)
  gmax = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(grads))
  for path, want in jax.tree_util.tree_flatten_with_path(grads)[0]:
    node = got["grads"]
    for key in path:
      node = node[key.key]
    tol = 1e-4 * float(np.abs(want).max()) + 1e-7 * gmax
    _close(node, want, 0, tol)


@pytest.mark.parametrize("p", RANKS)
def test_fit_bootstrap_step(spawned, p):
  """One `fit_bootstrap(mesh=...)` step of the golden's BootsTAP run: JAX's
  draws for the global batch, the confident-point count summed over the
  ranks; the student, its gradients and the teacher within the golden's
  limits. Only rank 0 logs."""
  _, got, _ = _case(spawned, p, "fit_bootstrap")
  assert got["log_lines"] == 1
  _, failures = tapir_golden.judge(tapir_golden.load(), {"bootstrap": got},
                                   runs=("bootstrap",))
  assert not failures, failures[:5]


def test_run_cli_model_parallel(spawned, tmp_path):
  """`training.run --model_parallel 2` on 2 ranks (as under torchrun), a
  step and then a resumed step (rank 0 reads the checkpoint and broadcasts
  it): each step's loss and gradient norm are the one-rank run's, and only
  rank 0 logged and saved."""
  _, got, _ = _case(spawned, 2, "run_cli")
  args = ["--experiment", "tapir", "--smoke", "--synthetic", "--num_steps",
          "1", "--total_steps", "2", "--log_every", "1", "--device", "cpu",
          "--checkpoint_dir", str(tmp_path)]
  run.main(args)
  run.main(args)

  def logged(directory):
    with open(os.path.join(directory, "train_log.jsonl")) as f:
      return [json.loads(line) for line in f]

  sharded, one = logged(got["ckpt"]), logged(tmp_path)
  assert got["step"] == 2
  assert [r["step"] for r in sharded] == [r["step"] for r in one] == [1, 2]
  for mine, theirs in zip(sharded, one):
    for key in ("loss", "gradient_norm"):
      np.testing.assert_allclose(mine[key], theirs[key], rtol=1e-5)
  assert os.path.exists(os.path.join(got["ckpt"], "checkpoint.npy"))


@pytest.mark.parametrize("p", RANKS)
def test_ranks_import_no_jax(spawned, p):
  """The ranks ran the port without importing JAX or the JAX package."""
  for r in range(p):
    assert spawned[p][1][r]["_modules"] == []


def test_mesh_needs_a_process_group():
  """Without a process group a mesh (and so a sharded predictor or trainer)
  raises; it never runs as one rank."""
  with pytest.raises(RuntimeError, match="process group"):
    mesh_lib.make_mesh()
  with pytest.raises(ValueError, match="torchrun"):
    run.main(["--synthetic", "--model_parallel", "2", "--device", "cpu"])

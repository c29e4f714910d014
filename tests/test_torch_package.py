"""PyTorch port, package boundary: it imports no JAX, Flax or tapnet_tpu
module, directly or indirectly; its entry points refuse to fall back to the
CPU; its kernels build only from its own sources, at first CUDA use.
"""

import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

import tapnet_tpu_torch
from tapnet_tpu_torch.inference import (
    OnlineTapnextPredictor, TapirPredictor, TapnextPredictor, resolve_device,
)
from tapnet_tpu_torch.models.tapir import bootstapir_config
from tapnet_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(tapnet_tpu_torch.__file__)


def _package_modules(pkg=PKG):
  mods = []
  for root, dirs, files in os.walk(pkg):
    dirs[:] = [d for d in dirs if not d.startswith(("_build", "__pycache__"))]
    for f in files:
      if f.endswith(".py"):
        rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
        mod = rel.replace(os.sep, ".")
        mods.append(mod[: -len(".__init__")] if mod.endswith("__init__") else mod)
  return sorted(mods)


def test_import_pulls_in_no_jax():
  code = (
      "import importlib, sys\n"
      f"for m in {_package_modules()!r}:\n"
      "  importlib.import_module(m)\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'tapnet_tpu'))\n"
      "assert not bad, bad\n"
  )
  env = dict(os.environ, PYTHONPATH=REPO)
  res = subprocess.run(
      [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
      text=True, timeout=120,
  )
  assert res.returncode == 0, res.stderr



SLICE_MODULES = (
    "tapnet_tpu_torch.tapvid3d.splits", "tapnet_tpu_torch.tapvid3d.metrics",
    "tapnet_tpu_torch.tapvid3d.evaluate", "tapnet_tpu_torch.tapvid3d.adt",
    "tapnet_tpu_torch.tapvid3d.generation", "tapnet_tpu_torch.utils.viz",
    "tapnet_tpu_torch.tapvid.visualize",
    "tapnet_tpu_torch.tapnextpp.vots_tracker",
    "tapnet_tpu_torch.examples._common",
    "tapnet_tpu_torch.examples.tapir_offline",
    "tapnet_tpu_torch.examples.tapir_online",
    "tapnet_tpu_torch.examples.tapir_rainbow",
    "tapnet_tpu_torch.examples.tapnext_tracking",
    "tapnet_tpu_torch.examples.robotap_clustering",
    "tapnet_tpu_torch.examples.flow_track_assist",
    "tapnet_tpu_torch.examples.trajan_roundtrip",
    "tapnet_tpu_torch.live_demo",
)


def test_slice_modules_run_without_jax():
  """TAPVid-3D, the painted-track output, the VOTS tracker, the examples and
  the live demo are in the import check above, and import neither JAX nor
  the optional cv2, matplotlib or PIL; their numpy and torch paths (the 3D
  metrics, a split list, the painting, the homography pipeline, the integer
  resize, a small VOTS tracker on seed-made weights, an example's helpers)
  run in a fresh process that never imports JAX."""
  assert set(SLICE_MODULES) <= set(_package_modules())
  code = (
      "import importlib, sys, numpy as np, torch\n"
      f"for m in {SLICE_MODULES!r}:\n"
      "  importlib.import_module(m)\n"
      "lazy = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('cv2', 'matplotlib', 'PIL'))\n"
      "assert not lazy, lazy\n"
      "from tapnet_tpu_torch.tapvid3d import metrics, splits\n"
      "from tapnet_tpu_torch.utils import viz\n"
      "from tapnet_tpu_torch.tapnextpp import vots_tracker\n"
      "from tapnet_tpu_torch.examples import _common\n"
      "from tapnet_tpu_torch.models import ssm_vit\n"
      "from tools.tapnext_weights import seeded_tapnext_params\n"
      "rng = np.random.RandomState(0)\n"
      "xyz = rng.rand(4, 6, 3) + [0, 0, 2]\n"
      "m = metrics.compute_tapvid3d_metrics(rng.rand(4, 6) > .8, xyz, "
      "rng.rand(4, 6) > .8, xyz * 2, np.array([100., 100., 32., 32.]))\n"
      "assert m['average_jaccard'] > .5, m\n"
      "assert len(splits.get_minival_files('adt')) == 50\n"
      "video = (rng.rand(3, 24, 32, 3) * 255).astype(np.uint8)\n"
      "tracks = rng.rand(4, 3, 2) * 20\n"
      "assert viz.paint_point_track(video, tracks, np.ones((4, 3), bool))"
      ".shape == video.shape\n"
      "h, _, _ = viz.get_homographies_wrt_frame(tracks, np.zeros((4, 3)), "
      "(32, 24))\n"
      "assert h.shape == (3, 3, 3)\n"
      "r = vots_tracker.resize_linear_u8(torch.from_numpy(video[0]), 40, 40)\n"
      "assert r.shape == (40, 40, 3) and r.dtype == torch.uint8\n"
      "cfg = ssm_vit.SsmVitConfig(width=32, depth=1, mlp_dim=64, "
      "num_heads=2, image_size=(32, 32))\n"
      "t = vots_tracker.VotsPointTracker(seeded_tapnext_params(cfg, 0), cfg, "
      "input_resolution=32, n_support=4, support_radius=8., device='cpu')\n"
      "xy, vis = t.initialize(video[0], np.array([[5., 6.]], np.float32))\n"
      "xy, vis = t.track(video[1])\n"
      "assert xy.shape == (1, 2) and vis.shape == (1,)\n"
      "assert _common.grid_queries(0, 64, 64).shape == (1, 4, 3)\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'tapnet_tpu'))\n"
      "assert not bad, bad\n"
  )
  env = dict(os.environ, PYTHONPATH=REPO)
  res = subprocess.run(
      [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
      text=True, timeout=300,
  )
  assert res.returncode == 0, res.stderr


# Modules of tapnet_tpu/ with no counterpart in tapnet_tpu_torch/, each with
# the reason it has none. Empty: the port carries every module.
UNPORTED = {}


def test_every_jax_module_has_a_counterpart():
  def relative(pkg):
    name = os.path.basename(pkg)
    return {m[len(name):] for m in _package_modules(pkg)}

  missing = (relative(os.path.join(REPO, "tapnet_tpu"))
             - relative(PKG))
  assert missing == set(UNPORTED), sorted(missing - set(UNPORTED))


def test_last_slice_runs_without_jax():
  """The generic ResNet (v1, BatchNorm, max-pool), TokenSubsampling, the
  profiling timers and trace analysis, the TAP-Vid CSV reader and the
  augmentation visualiser run in a fresh process that imports no JAX (nor
  cv2 or imageio, which they import only where they decode or write)."""
  code = (
      "import sys, tempfile, numpy as np, torch\n"
      "from tapnet_tpu_torch.models import resnet, ssm_vit\n"
      "from tapnet_tpu_torch.utils import profiling, trace_analysis\n"
      "from tapnet_tpu_torch.tapvid import generate\n"
      "from tapnet_tpu_torch.data import augmentation_viz\n"
      "cfg = resnet.ResNetConfig(blocks_per_group=(1, 1, 1, 1), "
      "channels_per_group=(8, 8, 16, 16), stem_channels=8, resnet_v2=False, "
      "normalization='batchnorm', use_max_pool=True, bottleneck=True)\n"
      "out = resnet.ResNet(cfg)(torch.randn(2, 3, 33, 30), is_training=True)\n"
      "assert out['group_3'].shape == (2, 16, 3, 2), out['group_3'].shape\n"
      "tok, masked = ssm_vit.TokenSubsampling(0.5, is_training=True)("
      "torch.randn(2, 4, 3, 8), torch.zeros(1, 1, 1, 8), "
      "torch.Generator().manual_seed(0))\n"
      "assert masked.shape == (2, 4) and masked[:, -1].all()\n"
      "s = profiling.benchmark_stats(torch.mm, torch.ones(4, 4), "
      "torch.ones(4, 4), num_measures=2)\n"
      "assert set(s) == {'min', 'median', 'reps'}\n"
      "d = tempfile.mkdtemp()\n"
      "with profiling.trace(d):\n"
      "  torch.ones(3).sum()\n"
      "assert trace_analysis.component_budget(d) == {}\n"
      "path = d + '/t.csv'\n"
      "open(path, 'w').write(','.join(['v', '0', '10'] + ['0.5'] * 750))\n"
      "assert len(generate.read_annotations(path)[('v', 0, 10)]) == 1\n"
      "video, tracks = augmentation_viz.make_dot_video(2, 32, 32)\n"
      "w, t = augmentation_viz.augment('homography', video, tracks, 0, 'cpu')\n"
      "assert w.shape == (2, 32, 32, 3) and t.shape == (2, 1, 2)\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'tapnet_tpu', 'cv2', 'imageio'))\n"
      "assert not bad, bad\n"
  )
  env = dict(os.environ, PYTHONPATH=REPO)
  res = subprocess.run(
      [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
      text=True, timeout=300,
  )
  assert res.returncode == 0, res.stderr


def test_chip_smoke_imports_no_jax():
  """chip_smoke.py runs where JAX is absent: it and the golden clips it
  rebuilds (tools/golden_clip.py) import no JAX, Flax or tapnet_tpu module.
  Its int8 stream limits, read from JAX's committed streams and their
  nudged-input witness, are never below the offline limits and refuse JAX's
  float stream, and the witness moves no query that add_points wrote."""
  code = (
      "import sys\n"
      "import numpy as np\n"
      "import chip_smoke\n"
      "video, queries = chip_smoke.make_clip(num_frames=chip_smoke.CLIP_FRAMES['d'])\n"
      "assert video.shape == (1, 24, 256, 256, 3), video.shape\n"
      "golden = np.load(chip_smoke.GOLDEN_ONLINE_INT8)\n"
      "fl = np.load(chip_smoke.GOLDEN_ONLINE)\n"
      "for name in 'abcd':\n"
      "  tol, witness = chip_smoke.online_int8_limits(golden, name)\n"
      "  offline = chip_smoke.GOLDEN_INT8_FP32_TOL[name]\n"
      "  assert all(tol[k] >= offline[k] for k in offline), (name, tol)\n"
      "  assert not set(witness['flipped']) & set(chip_smoke.ADD_IDX), witness\n"
      "  ref = {k: golden[f'{name}_{k}'] for k in chip_smoke._STREAM_KEYS}\n"
      "  control = {k: fl[f'float32_{k}'] for k in chip_smoke._STREAM_KEYS}\n"
      "  assert not chip_smoke.stream_within(\n"
      "      chip_smoke.stream_apart(control, ref), tol), (name, tol)\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'tapnet_tpu'))\n"
      "assert not bad, bad\n"
  )
  env = dict(os.environ, PYTHONPATH=REPO)
  res = subprocess.run(
      [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
      text=True, timeout=120,
  )
  assert res.returncode == 0, res.stderr

def test_sources_name_no_jax():
  pattern = re.compile(r"\bjax\b|\bflax\b|\btapnet_tpu\.")
  offenders = []
  for root, dirs, files in os.walk(PKG):
    dirs[:] = [d for d in dirs if not d.startswith(("_build", "__pycache__"))]
    for f in files:
      if f.endswith((".py", ".cu", ".cuh")):
        path = os.path.join(root, f)
        with open(path) as fh:
          for i, line in enumerate(fh, 1):
            if pattern.search(line):
              offenders.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
  assert not offenders, "\n".join(offenders)


def test_int8_paths_run_without_jax():
  """The int8 entries (quantizers, both int8 correlations, the w8a8 block, the
  per-frame int8 conv, the per-pixel ExtraConvs layer, a small int8 TAPIR)
  run in a fresh process that never imports JAX."""
  code = (
      "import sys, torch\n"
      "from tapnet_tpu_torch.ops import corr_tents, fused_mixer_block\n"
      "from tapnet_tpu_torch.models import tapir\n"
      "g = torch.randn(2, 9, 8, 16); q = torch.randn(2, 5, 16)\n"
      "cy = torch.rand(2, 5) * 9; cx = torch.rand(2, 5) * 8\n"
      "gq, gs = corr_tents.quantize_per_frame(g)\n"
      "a = corr_tents.corr_tent_patches_prequantized(gq, gs, q, cy, cx)\n"
      "b = corr_tents.corr_tent_patches(g, q, cy, cx, 7, True)\n"
      "assert a.shape == b.shape == (2, 7, 7, 5)\n"
      "c = 16; f = torch.randn\n"
      "y = fused_mixer_block.mixer_block(f(2, 6, c), f(c), f(3, 1, 4 * c), "
      "f(4 * c), f(3, 1, 4 * c), f(4 * c), f(c), f(c, 64), f(64), f(64, c), "
      "f(c), quantized=True)\n"
      "assert y.shape == (2, 6, c)\n"
      "from tapnet_tpu_torch.ops import fused_extra_convs, qconv\n"
      "z = qconv.conv2d_q8(f(2, 16, 5, 4), f(32, 16, 3, 3), f(32))\n"
      "assert z.shape == (2, 32, 5, 4)\n"
      "z = fused_extra_convs.extra_convs_layer(f(2, 5, 4, 16), f(16), f(16), "
      "f(3, 3, 16, 64), f(64), f(3, 3, 64, 16), f(16), True)\n"
      "assert z.shape == (2, 5, 4, 16)\n"
      "cfg = tapir.bootstapir_config(blocks_per_group=(1, 1, 1, 1), "
      "highres_dim=16, lowres_dim=32, mixer_hidden_dim=32, "
      "num_mixer_blocks=1, initial_resolution=(32, 32), num_pips_iter=1, "
      "quantized_mixer=True, quantized_corr='per_frame', "
      "quantized_extra_convs=True)\n"
      "model = tapir.TAPIR(cfg)\n"
      "for p in model.parameters(): torch.nn.init.normal_(p, std=0.05)\n"
      "with torch.no_grad():\n"
      "  out = model(torch.rand(1, 3, 32, 32, 3), "
      "torch.tensor([[[0., 8., 8.], [1., 20., 12.]]]))\n"
      "assert out['tracks'].shape == (1, 2, 3, 2)\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'tapnet_tpu'))\n"
      "assert not bad, bad\n"
  )
  env = dict(os.environ, PYTHONPATH=REPO)
  res = subprocess.run(
      [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
      text=True, timeout=300,
  )
  assert res.returncode == 0, res.stderr


def test_tapnext_paths_run_without_jax():
  """TAPNext (the linear scan, both predictors on seed-made weights from
  tools/tapnext_weights.py) runs in a fresh process that never imports
  JAX."""
  code = (
      "import sys, numpy as np, torch\n"
      "from tapnet_tpu_torch.inference import OnlineTapnextPredictor, "
      "TapnextPredictor\n"
      "from tapnet_tpu_torch.models import ssm_vit\n"
      "from tapnet_tpu_torch.ops import scan\n"
      "from tools.tapnext_weights import seeded_tapnext_params\n"
      "y, h = scan.linear_scan(torch.randn(2, 5, 6), torch.rand(2, 5, 6), "
      "torch.zeros(2, 6))\n"
      "assert y.shape == (2, 5, 6) and h.shape == (2, 6)\n"
      "cfg = ssm_vit.SsmVitConfig(width=32, depth=1, mlp_dim=64, num_heads=2, "
      "image_size=(32, 32))\n"
      "params = seeded_tapnext_params(cfg, 0)\n"
      "video = np.random.RandomState(0).uniform(-1, 1, (1, 5, 32, 32, 3))\n"
      "qp = np.array([[[0., 10., 12.], [3., 20., 5.]]], np.float32)\n"
      "out = TapnextPredictor(params, cfg, chunk_size=2, device='cpu')(video, qp)\n"
      "assert out['tracks'].shape == (1, 2, 5, 2), out['tracks'].shape\n"
      "online = OnlineTapnextPredictor(params, cfg, device='cpu')\n"
      "online.init(video[:, :1], qp)\n"
      "tracks, vis = online.predict(video[:, 1])\n"
      "assert tracks.shape == (1, 2, 2) and vis.shape == (1, 2)\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'tapnet_tpu'))\n"
      "assert not bad, bad\n"
  )
  env = dict(os.environ, PYTHONPATH=REPO)
  res = subprocess.run(
      [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
      text=True, timeout=300,
  )
  assert res.returncode == 0, res.stderr


def test_training_runs_without_jax():
  """A TAPNext training step (the Trainer, both losses, synthetic batches
  made from a torch.Generator, a checkpoint) runs in a fresh process that
  never imports JAX; so does the TAP-Vid evaluation layer (metrics, readers,
  evaluate harness, JHMDB, AJ_RD), the TAPNext torch-checkpoint import, and
  `export_npz` from the committed JAX draws (`synthetic.load_draws`), read
  back and scored, with the tools chip_smoke.py imports (the models run in
  the tests of the port's predictors)."""
  code = (
      "import sys, tempfile, os, numpy as np, torch\n"
      "from tapnet_tpu_torch import configs\n"
      "from tapnet_tpu_torch.data import synthetic\n"
      "from tapnet_tpu_torch.models import ssm_vit, tapnext\n"
      "from tapnet_tpu_torch.training import optimizers, trainer\n"
      "from tapnet_tpu_torch.tapvid import aj_rd, datasets, evaluate, jhmdb, metrics\n"
      "from tapnet_tpu_torch.checkpoints import tapnext_torch_import\n"
      "from tools import golden_clip, make_online_golden\n"
      "d = tempfile.mkdtemp()\n"
      "draws = {k: v[:1] for k, v in synthetic.load_draws("
      "'tests/data/synth_eval_draws.npz', 'b').items()}\n"
      "synthetic.export_npz(d, 1, num_queries=64, num_sprites=12, draws=draws)\n"
      "ds = datasets.create_kubric_dataset(d, 'strided')\n"
      "def still(video, qp):\n"
      "  t = video.shape[1]\n"
      "  return dict(tracks=np.repeat(qp[..., None, 2:0:-1], t, 2),\n"
      "              occlusion=np.full(qp.shape[:2] + (t,), -5.0),\n"
      "              expected_dist=np.full(qp.shape[:2] + (t,), -5.0))\n"
      "m = evaluate.evaluate_dataset(still, ds, 'strided', verbose=False)\n"
      "assert len(m) == 13 and 0 < m['average_jaccard'] < 1, m\n"
      "assert metrics.latex_table(m)\n"
      "cfg = ssm_vit.SsmVitConfig(width=32, depth=1, mlp_dim=64, num_heads=2, "
      "image_size=(32, 32), remat=True)\n"
      "gen = torch.Generator().manual_seed(0)\n"
      "data = iter(lambda: synthetic.make_batch(gen, 1, 4, 32, 32, 3), None)\n"
      "for builder in (trainer.tapnext_loss_builder, lambda m, t: "
      "trainer.tapnext_chunked_loss_builder(m, t, 2)):\n"
      "  d = tempfile.mkdtemp()\n"
      "  t = trainer.Trainer(tapnext.TAPNextTracker(cfg), "
      "optimizers.OptimizerConfig(warmup_steps=1), 10, loss_builder=builder, "
      "checkpoint_path=os.path.join(d, 'c.npy'), checkpoint_every=1, "
      "device='cpu')\n"
      "  state = t.fit(t.restore_or_init(), data, num_steps=1, log_every=1)\n"
      "  assert state.step == 1 and os.path.exists(os.path.join(d, 'c.npy'))\n"
      "assert configs.get_experiment('tapnextpp').train_time_chunk == 128\n"
      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
      "('jax', 'jaxlib', 'flax', 'optax', 'tapnet_tpu'))\n"
      "assert not bad, bad\n"
  )
  env = dict(os.environ, PYTHONPATH=REPO)
  res = subprocess.run(
      [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
      text=True, timeout=300,
  )
  assert res.returncode == 0, res.stderr


def test_int8_products_stay_in_the_ports_own_kernels():
  """No library stands in for an int8 product: the package names neither
  `_int_mm`, cuBLAS nor `torch.compile`, and each int8 entry point of the
  CUDA sources is one the wrappers bind."""
  pattern = re.compile(r"_int_mm|cublas|torch\.compile|_scaled_mm", re.I)
  offenders, sources = [], {}
  for root, dirs, files in os.walk(PKG):
    dirs[:] = [d for d in dirs if not d.startswith(("_build", "__pycache__"))]
    for f in files:
      if f.endswith((".py", ".cu", ".cuh")):
        path = os.path.join(root, f)
        with open(path) as fh:
          sources[f] = text = fh.read()
        offenders += [f"{f}: {m.group(0)}" for m in pattern.finditer(text)]
  assert not offenders, offenders
  for entry, cu, py in (
      ("corr_tents_q8_forward", "corr_tents.cu", "corr_tents.py"),
      ("mixer_block_q8_forward", "fused_mixer_block.cu", "fused_mixer_block.py"),
      ("conv3x3_q8_frame_forward", "extra_convs.cu", "qconv.py"),
      ("extra_convs_q8_pixel_forward", "extra_convs.cu", "qconv.py"),
  ):
    assert f"int {entry}(" in sources[cu] and f'"{entry}"' in sources[py]
  assert "--use_fast_math" not in " ".join(_build.NVCC_FLAGS)


def test_predictor_refuses_cpu_fallback():
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present: the default device is usable")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    TapirPredictor({}, bootstapir_config())
  for predictor in (TapnextPredictor, OnlineTapnextPredictor):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      predictor({})
  with pytest.raises(RuntimeError):
    resolve_device("cuda")
  assert resolve_device("cpu").type == "cpu"


def test_slice_entry_points_refuse_cpu_fallback():
  """RoboTAP's dense tracking and clustering and flow-assisted tracking run
  on the card unless asked for the CPU; without a card they raise before
  any work."""
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present: the default device is usable")
  import numpy as np

  from tapnet_tpu_torch.robotap import clustering, dense_tracking
  from tapnet_tpu_torch.utils import flow_track_assist

  with pytest.raises(RuntimeError, match="device='cpu'"):
    dense_tracking.track_many_points(np.zeros((2, 32, 32, 3), np.uint8), {})
  tracks, vis = np.zeros((4, 3, 2)), np.ones((4, 3))
  with pytest.raises(RuntimeError, match="device='cpu'"):
    clustering.compute_clusters({"e": tracks}, {"e": vis}, ["e"],
                                {"e": (3, 8, 8, 3)}, verbose=False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    flow_track_assist.interpolate_track(np.zeros((2, 8, 8, 2)), (1, 1),
                                        (2, 2), radius=2)


def test_parallel_refuses_single_rank_fallback(monkeypatch):
  """The multi-device layer (parallel/: in the no-JAX import check above)
  never runs a multi-rank request as one rank: a mesh without a process
  group raises, and so does joining torchrun's group when its variables are
  incomplete; a rank's default device is its card."""
  from tapnet_tpu_torch.parallel import launch, mesh as mesh_lib

  assert {"tapnet_tpu_torch.parallel.mesh", "tapnet_tpu_torch.parallel.launch",
          "tapnet_tpu_torch.parallel.sequence"} <= set(_package_modules())
  with pytest.raises(RuntimeError, match="process group"):
    mesh_lib.make_mesh()
  with pytest.raises(RuntimeError, match="process group"):
    TapirPredictor({}, bootstapir_config(), device="cpu",
                   mesh=mesh_lib.make_mesh())
  for key in ("MASTER_ADDR", "MASTER_PORT"):
    monkeypatch.delenv(key, raising=False)
  monkeypatch.setenv("WORLD_SIZE", "2")
  monkeypatch.setenv("RANK", "0")
  with pytest.raises((RuntimeError, ValueError)):
    launch.init_from_env("gloo", device="cpu")
  assert not torch.distributed.is_initialized()
  monkeypatch.setenv("WORLD_SIZE", "1")
  assert launch.init_from_env("gloo", device="cpu") == 1
  if not torch.cuda.is_available():
    mesh = mesh_lib.Mesh.__new__(mesh_lib.Mesh)
    mesh.rank = 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
      mesh.device()
    assert mesh.device("cpu").type == "cpu"


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
  """A build that cannot run raises; nothing falls back to the plain
  versions. Imports needed no toolchain."""
  monkeypatch.setenv("PATH", str(tmp_path))
  monkeypatch.setenv("CUDA_HOME", str(tmp_path))
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
  with pytest.raises(RuntimeError, match="nvcc"):
    _build.build_all(["corr_tents"])


def _package_data_globs():
  """{package directory: [globs]} of pyproject.toml's package data."""
  import tomllib

  with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
    data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
  return {os.path.join(REPO, *pkg.split(".")): globs
          for pkg, globs in data.items()}


def _shipped(path, globs_by_dir):
  import fnmatch

  for pkg_dir, globs in globs_by_dir.items():
    rel = os.path.relpath(path, pkg_dir)
    if not rel.startswith("..") and any(fnmatch.fnmatch(rel, g)
                                        for g in globs):
      return True
  return False


def test_package_data_ships_every_runtime_file():
  """An installed port can build its kernels and its loader and read its
  split lists: every file that ops/_build.py, data/native_loader.py and
  tapvid3d/splits.py read, and every other file of the package but its
  Python modules and Markdown notes, matches a package-data glob of
  pyproject.toml."""
  from tapnet_tpu_torch.data import native_loader
  from tapnet_tpu_torch.tapvid3d import splits

  globs = _package_data_globs()
  read = (sorted(_build.SRC_DIR.glob("*.cu")) + sorted(
      _build.SRC_DIR.glob("*.cuh")) + [native_loader._SRC] + [  # pylint: disable=protected-access
          os.path.join(splits._VENDORED_DIR, f"{s}_{p}.txt")  # pylint: disable=protected-access
          for s in splits.SOURCES for p in splits.SPLITS])
  assert {"q8_tile.cuh", "tma_gemm.cuh", "loader.cc"} <= {
      os.path.basename(str(p)) for p in read}
  missing = [str(p) for p in read if not _shipped(str(p), globs)]
  assert not missing, missing
  others = []
  for root, dirs, files in os.walk(PKG):
    dirs[:] = [d for d in dirs if not d.startswith(("_build", "__pycache__"))]
    others += [os.path.join(root, f) for f in files
               if not f.endswith((".py", ".pyc", ".md"))]
  assert len(others) >= 13, others
  missing = [p for p in others if not _shipped(p, globs)]
  assert not missing, missing


def test_build_key_follows_sources():
  names = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
  assert names == ["corr_tents", "extra_convs", "fused_mixer_block", "scan"]
  paths = {_build._library_path(n) for n in names}  # pylint: disable=protected-access
  assert len(paths) == 4
  assert all(p.parent == _build.BUILD_DIR for p in paths)

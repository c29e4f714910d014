"""PyTorch port, the example scripts (`tapnet_tpu_torch/examples/`) and the
live demo (`tapnet_tpu_torch/live_demo.py`) on the CPU.

Each example's `main()` runs with `--device cpu` at the JAX smoke sizes of
tests/test_examples.py (`--tiny` TAPIR, the `mu` TAPNext variant), writing
to tmp_path; the live demo tracks a small mp4 that the test writes, with
`--no_display`. Against the JAX package: the examples' shared numpy helpers
and synthetic inputs are equal to JAX's, and the offline TAPIR example's
tracks on a written mp4 with a seeded checkpoint are held to JAX's
`TapirPredictor` on the same video and weights: tracks within 1e-3 px
(float32 sums of the whole model in another order), at least 95% of the
visibility flags equal (a flag of random weights can sit at its threshold).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu_torch.examples import (  # noqa: E402
    _common, flow_track_assist, robotap_clustering, tapir_offline,
    tapir_online, tapir_rainbow, tapnext_tracking,
)
from tapnet_tpu_torch import live_demo  # noqa: E402
from tapnet_tpu_torch.models import tapir  # noqa: E402

TRACK_PX, FLAGS_AGREE = 1e-3, 0.95


def _write_mp4(path, frames):
  h, w = frames.shape[1:3]
  writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                           (w, h))
  for frame in frames:
    writer.write(frame[..., ::-1])
  writer.release()


def _smooth_video(t=6, h=64, w=64, seed=0):
  rng = np.random.RandomState(seed)
  yy, xx = np.mgrid[0:h, 0:w]
  base = sum(rng.uniform(20, 50) * np.sin(rng.uniform(0.05, 0.3) * yy
                                           + rng.uniform(0.05, 0.3) * xx
                                           + rng.uniform(0, 6))
             for _ in range(4))
  return np.stack([
      np.clip(np.roll(base, (i, 2 * i), (0, 1))[..., None]
              + np.array([128, 100, 150]), 0, 255) for i in range(t)
  ]).astype(np.uint8)


def test_common_helpers_equal_jax():
  import examples._common as jax_common
  import examples.flow_track_assist as jax_flow
  import examples.robotap_clustering as jax_robotap

  for args in ((0, 64, 64, 32), (3, 48, 80, 16)):
    np.testing.assert_array_equal(_common.grid_queries(*args),
                                  jax_common.grid_queries(*args))
  video = _smooth_video()
  np.testing.assert_array_equal(_common.normalize_video(video),
                                jax_common.normalize_video(video))
  for a, b in zip(robotap_clustering.synthetic_rigid_tracks(),
                  jax_robotap.synthetic_rigid_tracks()):
    np.testing.assert_array_equal(a, b)
  np.testing.assert_array_equal(flow_track_assist.synthetic_rotating_flow(),
                                jax_flow.synthetic_rotating_flow())
  from tapnet_tpu.models import tapir as jax_tapir

  ours = _common.tiny_tapir(tapir.bootstapir_config())
  theirs = jax_common.tiny_tapir(jax_tapir.bootstapir_config())
  assert (ours.num_mixer_blocks, ours.blocks_per_group) == (
      theirs.num_mixer_blocks, theirs.blocks_per_group) == (2, (1, 1, 1, 1))


def test_load_video_reads_and_renders(tmp_path):
  video = _smooth_video(t=4)
  _write_mp4(tmp_path / "v.mp4", video)
  read = _common.load_video(str(tmp_path / "v.mp4"), resize=(32, 48))
  assert read.shape == (4, 32, 48, 3) and read.dtype == np.uint8
  made = _common.load_video(None, num_frames=5, resize=(40, 56))
  assert made.shape == (5, 40, 56, 3) and made.dtype == np.uint8
  np.testing.assert_array_equal(
      made, _common.load_video(None, num_frames=5, resize=(40, 56)))


def test_tapir_offline(tmp_path):
  out = tapir_offline.main(["--resize", "64", "64", "--num_frames", "6",
                            "--tiny", "--out", str(tmp_path / "t.mp4"),
                            "--device", "cpu"])
  assert out["tracks"].shape == (4, 6, 2) and np.isfinite(out["tracks"]).all()
  assert out["painted"].shape == (6, 64, 64, 3)
  assert (tmp_path / "t.mp4").stat().st_size > 0


def test_tapir_offline_matches_jax_predictor(tmp_path):
  """The example on a written mp4 with a seeded tiny BootsTAPIR checkpoint,
  against JAX's TapirPredictor on the same decoded video and weights."""
  from tapnet_tpu import inference as jax_inference
  from tapnet_tpu.models import tapir as jax_tapir

  video = _smooth_video(t=5)
  _write_mp4(tmp_path / "clip.mp4", video)
  cfg = _common.tiny_tapir(tapir.bootstapir_config())
  params = tapir.init_tapir_params(cfg, torch.Generator().manual_seed(3))
  np.save(tmp_path / "ckpt.npy", {"params": params}, allow_pickle=True)
  out = tapir_offline.main(["--video", str(tmp_path / "clip.mp4"),
                            "--checkpoint", str(tmp_path / "ckpt.npy"),
                            "--model", "bootstapir", "--tiny", "--resize",
                            "64", "64", "--out", str(tmp_path / "t.mp4"),
                            "--device", "cpu"])
  decoded = _common.load_video(str(tmp_path / "clip.mp4"), resize=(64, 64))
  jax_cfg = jax_tapir.bootstapir_config(num_mixer_blocks=2,
                                        blocks_per_group=(1, 1, 1, 1))
  predictor = jax_inference.TapirPredictor(params, jax_cfg)
  ref = predictor(_common.normalize_video(decoded),
                  _common.grid_queries(0, 64, 64, 32))
  np.testing.assert_allclose(out["tracks"], ref["tracks"][0], atol=TRACK_PX)
  agree = np.mean(out["visibles"] == predictor.visibles(ref)[0])
  assert agree >= FLAGS_AGREE, agree


def test_tapir_online(tmp_path):
  out = tapir_online.main(["--resize", "64", "64", "--num_frames", "4",
                           "--grid_stride", "32", "--tiny", "--out",
                           str(tmp_path / "t.mp4"), "--device", "cpu"])
  assert out["tracks"].shape == (4, 4, 2) and np.isfinite(out["tracks"]).all()
  assert out["painted"].shape == (4, 64, 64, 3)


def test_tapir_rainbow(tmp_path):
  out = tapir_rainbow.main(["--resize", "64", "64", "--num_frames", "5",
                            "--tiny", "--out", str(tmp_path / "t.mp4"),
                            "--device", "cpu"])
  assert out["homographies"].shape == (5, 3, 3)
  assert out["painted"].shape == (5, 64, 64, 3)


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["offline", "streaming"])
def test_tapnext_tracking(tmp_path, streaming):
  out = tapnext_tracking.main(
      ["--num_frames", "3", "--grid_stride", "128", "--variant", "mu",
       "--out", str(tmp_path / "t.mp4"), "--device", "cpu"]
      + (["--streaming"] if streaming else []))
  assert out["tracks"].shape == (4, 3, 2) and np.isfinite(out["tracks"]).all()
  assert out["painted"].shape == (3, 256, 256, 3)


def test_robotap_clustering():
  out = robotap_clustering.main(["--final_num_cats", "2",
                                 "--iters_before_split", "50",
                                 "--device", "cpu"])
  assert out["classes"].shape == (60,)


def test_flow_track_assist():
  out = flow_track_assist.main(["--radius", "4", "--device", "cpu"])
  track = out["track"]
  assert track.shape == (13, 2)
  np.testing.assert_allclose(track[0], (48.0, 32.0))
  np.testing.assert_allclose(track[-1], np.round(out["chained"][-1]), atol=1)


def test_examples_refuse_cpu_fallback(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present: the default device is usable")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    tapir_offline.main(["--resize", "32", "32", "--num_frames", "2", "--tiny",
                        "--out", str(tmp_path / "t.mp4")])


def test_live_demo_tracks_a_video(tmp_path, capsys):
  """`python -m tapnet_tpu_torch.live_demo --video clip.mp4 --no_display
  --device cpu` with a seeded causal TAPIR checkpoint streams the clip."""
  _write_mp4(tmp_path / "clip.mp4", _smooth_video(t=4, h=48, w=56))
  params = tapir.init_tapir_params(tapir.causal_tapir_config(),
                                   torch.Generator().manual_seed(1))
  np.save(tmp_path / "ckpt.npy", {"params": params}, allow_pickle=True)
  fps = live_demo.main(["--checkpoint", str(tmp_path / "ckpt.npy"),
                        "--video", str(tmp_path / "clip.mp4"),
                        "--resolution", "64", "--num_slots", "4",
                        "--no_display", "--device", "cpu"])
  assert fps > 0
  assert "mean throughput" in capsys.readouterr().out


def test_live_demo_loop():
  """run_demo's loop: init on the first frame (resized to the resolution)
  with every slot at the centre at t = 0, then one predict a later frame,
  and no query added without a click."""

  class Capture:
    def __init__(self, frames):
      self.frames = list(frames)

    def read(self):
      return (True, self.frames.pop(0)) if self.frames else (False, None)

  class Recorder:
    def __init__(self):
      self.calls = []

    def init(self, frame, qp):
      self.calls.append(("init", frame.shape, qp.shape))

    def add_points(self, frame, qp, idx):
      self.calls.append(("add", qp.tolist(), list(idx)))

    def predict(self, frame):
      self.calls.append(("predict", frame.shape))
      return np.zeros((1, 4, 2)), np.ones((1, 4), bool)

  rec = Recorder()
  live_demo.run_demo(rec, Capture(_smooth_video(t=3, h=40, w=40)),
                     resolution=32, num_slots=4, display=False)
  assert rec.calls[0] == ("init", (1, 32, 32, 3), (1, 4, 3))
  assert not any(c[0] == "add" for c in rec.calls)
  assert [c[0] for c in rec.calls[1:]] == ["predict", "predict"]

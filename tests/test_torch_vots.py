"""PyTorch port, the TAPNext++ VOTS tracker (`tapnet_tpu_torch/tapnextpp/
vots_tracker.py`) against the JAX package's, on the same seed-made weights
(tools/tapnext_weights.py, through each package's loader) and inputs.

  * Support points, coordinate transforms and query-file parsing: equal.
  * `resize_linear_u8`: bit-equal to `cv2.resize(INTER_LINEAR)` on seeded
    uint8 frames (the JAX tracker's resize), up, down, at exact 2x
    downscales (OpenCV's INTER_AREA there) and at odd sizes.
  * `VotsPointTracker` at tests/test_vots_generate.py's tiny configuration
    (width 32, depth 1, 32x32, patch 8), at 32 and at 64 input (posembs
    adapted), `initialize` and three `track` steps, and `run_folder_protocol`
    at its defaults (512 input, 64 support points): within
    tools/make_vots_golden.py's limits (`judge`), TAPNext's float32 limits:
    visibility logits within 2e-3, tracks within 0.05 px in model space
    (display error over the display / model scale), flags equal except
    where JAX's logit lies within 2e-3 of 0.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.models import ssm_vit as jax_ssm_vit
from tapnet_tpu.tapnextpp import vots_tracker as jax_vots
from tapnet_tpu_torch.models import ssm_vit
from tapnet_tpu_torch.tapnextpp import vots_tracker
from tools import make_vots_golden
from tools.tapnext_weights import seeded_tapnext_params

TINY = dict(width=32, depth=1, mlp_dim=64, num_heads=2, patch_size=(1, 8, 8),
            image_size=(32, 32))


@pytest.mark.parametrize("n,w,h", [(64, 64.0, 64.0), (16, 20.0, 50.0),
                                   (7, 30.0, 10.0), (0, 5.0, 5.0)])
def test_support_points_equal_jax(n, w, h):
  np.testing.assert_array_equal(vots_tracker.grid_support_points(n, w, h),
                                jax_vots.grid_support_points(n, w, h))
  q = np.array([[2.0, 2.0], [500.0, 500.0], [100.5, 40.25]], np.float32)
  np.testing.assert_array_equal(
      vots_tracker.local_support_points(q, n, h / 2, 512, 384),
      jax_vots.local_support_points(q, n, h / 2, 512, 384))


def test_transforms_and_query_files_equal_jax(tmp_path):
  xy = np.random.RandomState(0).rand(9, 2).astype(np.float32) * 400
  for disp_h, disp_w, size in ((480, 640, 512), (240, 428, 512), (48, 64, 32)):
    m = vots_tracker.display_to_model(xy, disp_h, disp_w, size)
    np.testing.assert_array_equal(
        m, jax_vots.display_to_model(xy, disp_h, disp_w, size))
    np.testing.assert_array_equal(
        vots_tracker.model_to_display(m, disp_h, disp_w, size),
        jax_vots.model_to_display(m, disp_h, disp_w, size))
  path = tmp_path / "query_a.txt"
  path.write_text("10.5,20\npoint: 3,4\n\npoint 7;8\n")
  np.testing.assert_array_equal(vots_tracker._parse_query_file(str(path)),  # pylint: disable=protected-access
                                jax_vots._parse_query_file(str(path)))  # pylint: disable=protected-access


RESIZES = [
    ((48, 64), (512, 512)),     # up, the tracker's own
    ((240, 428), (512, 512)),   # up, vots-golden's display
    ((480, 854), (512, 512)),   # up in height, down in width
    ((720, 1280), (512, 512)),  # down
    ((256, 256), (512, 512)),   # exact 2x up
    ((64, 64), (32, 32)),       # exact 2x down: INTER_AREA
    ((96, 130), (48, 65)),      # exact 2x down, not square
    ((97, 130), (48, 65)),      # 2x in one axis only
    ((63, 65), (32, 32)),       # odd
    ((7, 9), (31, 17)),         # odd, tiny source
    ((100, 37), (13, 71)),      # odd, mixed
]


@pytest.mark.parametrize("src,dst", RESIZES, ids=lambda v: "x".join(map(str, v)))
def test_resize_bit_equal_to_cv2(src, dst):
  rng = np.random.RandomState(sum(src) + sum(dst))
  frames = rng.randint(0, 256, (2,) + src + (3,)).astype(np.uint8)
  got = vots_tracker.resize_linear_u8(torch.from_numpy(frames), *dst).numpy()
  for frame, ours in zip(frames, got):
    want = cv2.resize(frame, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert ours.shape == want.shape
    np.testing.assert_array_equal(ours, want)


def test_resize_refuses_float_frames():
  with pytest.raises(ValueError, match="uint8"):
    vots_tracker.resize_linear_u8(torch.zeros(4, 4, 3), 2, 2)


@pytest.fixture(scope="module")
def tiny_params():
  return seeded_tapnext_params(ssm_vit.SsmVitConfig(**TINY), 0)


@pytest.mark.parametrize("resolution", [32, 64])
def test_tracker_matches_jax(tiny_params, resolution):
  frames, queries = make_vots_golden.vots_clip(frames=4, hw=(48, 64),
                                               queries=2, seed=3)
  kwargs = dict(input_resolution=resolution, n_support=4, support_radius=8.0)
  ref = make_vots_golden.run_stream(
      make_vots_golden.jax_tracker(tiny_params, jax_ssm_vit.SsmVitConfig(**TINY),
                                   **kwargs), frames, queries)
  tracker = vots_tracker.VotsPointTracker(
      tiny_params, ssm_vit.SsmVitConfig(**TINY), device="cpu", **kwargs)
  got = make_vots_golden.run_stream(tracker, frames, queries)
  assert got["xy"].shape == (4, 2, 2) and got["visible"].shape == (4, 2)
  r = make_vots_golden.judge(got, ref, (48, 64), resolution)
  assert r["ok"], r
  # The support points are tracked and hidden: 2 real + 2 x 4 support.
  assert tracker.num_real == 2
  assert tracker.predictor._state.query_points.shape[1] == 10  # pylint: disable=protected-access


def test_run_folder_protocol_matches_jax(tiny_params, tmp_path):
  """The VOT folder protocol at the tracker's defaults (512 input, 64
  support points in a 32 px radius) on PNG frames: the same output files,
  numbers within the limits."""
  frames, queries = make_vots_golden.vots_clip(frames=3, hw=(40, 56),
                                               queries=3, seed=5)
  paths = []
  for i, frame in enumerate(frames):
    name = f"{i:08d}.png"
    cv2.imwrite(str(tmp_path / name), frame[..., ::-1])
    paths.append(name)
  (tmp_path / "frames_color.txt").write_text("\n".join(paths) + "\n")
  (tmp_path / "query_1.txt").write_text(
      "\n".join(f"{x},{y}" for x, y in queries[:2]) + "\n")
  (tmp_path / "query_2.txt").write_text(
      "point: {},{}\n".format(*queries[2]))
  outputs = {}
  for name, run in (
      ("jax", lambda: jax_vots.run_folder_protocol(
          tiny_params, jax_ssm_vit.SsmVitConfig(**TINY), str(tmp_path))),
      ("ours", lambda: vots_tracker.run_folder_protocol(
          tiny_params, ssm_vit.SsmVitConfig(**TINY), str(tmp_path),
          device="cpu"))):
    run()
    outputs[name] = {}
    for f in sorted(os.listdir(tmp_path)):
      if f.startswith("output_"):
        outputs[name][f] = (tmp_path / f).read_text()
        os.remove(tmp_path / f)
  assert sorted(outputs["ours"]) == sorted(outputs["jax"]) == [
      "output_1.txt", "output_1_visible.txt", "output_2.txt",
      "output_2_visible.txt"]
  scale = np.array([56 / 512, 40 / 512])
  parse = lambda t: np.array([[float(v) for v in row.replace(";", ",").split(
      ",")] for row in t.splitlines()])
  for f, text in outputs["jax"].items():
    ours, theirs = parse(outputs["ours"][f]), parse(text)
    real = 2 if f.startswith("output_1") else 1
    if f.endswith("_visible.txt"):
      assert ours.shape == (3, real)
      np.testing.assert_array_equal(ours, theirs)
    else:
      # Written with 2 decimals: within the track limit and the rounding.
      assert ours.shape == theirs.shape == (3, 2 * real)
      err = np.abs(ours - theirs).reshape(3, real, 2) / scale
      assert err.max() <= (make_vots_golden.TRACK_MODEL_PX
                           + 0.005 / scale.min()), err.max()


def test_tracker_refuses_cpu_fallback(tiny_params):
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present: the default device is usable")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    vots_tracker.VotsPointTracker(tiny_params, ssm_vit.SsmVitConfig(**TINY),
                                  input_resolution=32)

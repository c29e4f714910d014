"""PyTorch port, painted-track output (`tapnet_tpu_torch/utils/viz.py`,
`tapvid/visualize.py`, `tapvid/evaluate.py`'s visualization_dir) against
the JAX package's, on the same numpy inputs made from a seed.

The painting and the matplotlib plots (Agg backend) are held equal frame
for frame: JAX's `plot_tracks` draws its colour permutation from numpy's
global state, the port's from the generator it is given, so the JAX side
runs after `np.random.seed(s)` and the port's with `RandomState(s)`. The
homography pipeline is float64 numpy on both sides: held to 1e-6.
"""

import os
import pickle

import numpy as np
import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("matplotlib")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.tapvid import evaluate as jax_evaluate
from tapnet_tpu.tapvid import visualize as jax_visualize
from tapnet_tpu.utils import viz as jax_viz
from tapnet_tpu_torch.tapvid import evaluate, visualize
from tapnet_tpu_torch.utils import viz

HOMOG_TOL = 1e-6


def _tracks(seed=0, n=6, t=4, h=48, w=64):
  rng = np.random.RandomState(seed)
  video = (rng.rand(t, h, w, 3) * 255).astype(np.uint8)
  start = rng.rand(n, 1, 2) * np.array([w, h])
  tracks = start + np.cumsum(rng.randn(n, t, 2) * 2, axis=1)
  tracks[0, 1] = [-5.0, h + 3.0]  # off the frame: clipped
  occluded = rng.rand(n, t) > 0.7
  return video, tracks.astype(np.float32), occluded


@pytest.mark.parametrize("n", [1, 7, 40])
def test_get_colors_equals_jax(n):
  assert viz.get_colors(n, seed=3) == jax_viz.get_colors(n, seed=3)


@pytest.mark.parametrize("hw", [(48, 64), (8, 10)])
def test_paint_point_track_equals_jax(hw):
  video, tracks, occluded = _tracks(1, h=hw[0], w=hw[1])
  colors = viz.get_colors(tracks.shape[0], seed=0)
  ours = viz.paint_point_track(video, tracks, ~occluded, colors)
  theirs = jax_viz.paint_point_track(video, tracks, ~occluded, colors)
  assert ours.shape == video.shape and ours.dtype == np.uint8
  np.testing.assert_array_equal(ours, theirs)
  assert not np.array_equal(ours, video)


@pytest.mark.parametrize("groups", [False, True], ids=["tracks", "groups"])
def test_plot_tracks_equals_jax(groups):
  video, tracks, occluded = _tracks(2)
  gt = tracks + 1.5
  trackgroup = np.array([0, 0, 1, 2, 2, 1]) if groups else None
  np.random.seed(5)
  theirs = jax_viz.plot_tracks(video, tracks, occluded.astype(np.float32),
                               gt, occluded.astype(np.float32), trackgroup)
  ours = viz.plot_tracks(video, tracks, occluded.astype(np.float32), gt,
                         occluded.astype(np.float32), trackgroup,
                         rng=np.random.RandomState(5))
  assert ours.shape == video.shape
  np.testing.assert_array_equal(ours, theirs)


def test_plot_tracks_grid_equals_jax():
  video, tracks, occluded = _tracks(3, n=8)
  occ = occluded.astype(np.float32)
  np.random.seed(2)
  theirs = jax_viz.plot_tracks_grid(video, tracks, occ)
  ours = viz.plot_tracks_grid(video, tracks, occ, rng=np.random.RandomState(2))
  assert ours.shape == (4, 96, 128, 3)
  np.testing.assert_array_equal(ours, theirs)


def _homography_tracks(seed=0, n=40, t=6, w=64.0, h=48.0):
  """Background points moved by a slow per-frame homography, a few
  outliers and occlusions."""
  rng = np.random.RandomState(seed)
  base = rng.rand(n, 2) * [w, h]
  tracks, frames = [], []
  for i in range(t):
    hom = np.array([[1 + 0.01 * i, 0.02 * i, 1.5 * i],
                    [-0.01 * i, 1 - 0.005 * i, -0.7 * i],
                    [1e-4 * i, 0.0, 1.0]])
    frames.append(jax_viz.apply_homography(hom, base))
  tracks = np.stack(frames, axis=1) + rng.randn(n, t, 2) * 0.05
  tracks[:4] += rng.randn(4, t, 2) * 10  # outliers
  occ = (rng.rand(n, t) > 0.85).astype(np.float32)
  return tracks, occ, (w, h)


def test_ransac_and_canonical_points_equal_jax():
  tracks, occ, _ = _homography_tracks(1)
  vis = (occ[:, 0] == 0) & (occ[:, 3] == 0)
  h_ours, in_ours = viz.ransac_homography(tracks[:, 3], tracks[:, 0], vis,
                                          thresh=1.0, seed=4)
  h_jax, in_jax = jax_viz.ransac_homography(tracks[:, 3], tracks[:, 0], vis,
                                            thresh=1.0, seed=4)
  np.testing.assert_allclose(h_ours, h_jax, atol=HOMOG_TOL, rtol=HOMOG_TOL)
  np.testing.assert_array_equal(in_ours, in_jax)
  assert in_ours.sum() >= 30
  ours = viz.maybe_ransac_homography(tracks[:, 2], occ[:, 2], tracks[:, 0],
                                     occ[:, 0], thresh=1.0, seed=1)
  theirs = jax_viz.maybe_ransac_homography(tracks[:, 2], occ[:, 2],
                                           tracks[:, 0], occ[:, 0],
                                           thresh=1.0, seed=1)
  for a, b in zip(ours, theirs):
    np.testing.assert_allclose(a, b, atol=HOMOG_TOL, rtol=HOMOG_TOL)
  err = np.abs(np.random.RandomState(0).randn(6, 40))
  tformed = np.transpose(tracks, (1, 0, 2))
  c_ours, bad_ours = viz.compute_canonical_points(
      tformed, occ.T, err, 0.5, 1.0, 0.6, np.random.RandomState(9))
  c_jax, bad_jax = jax_viz.compute_canonical_points(
      tformed, occ.T, err, 0.5, 1.0, 0.6, np.random.RandomState(9))
  np.testing.assert_allclose(c_ours, c_jax, atol=HOMOG_TOL, rtol=HOMOG_TOL)
  np.testing.assert_array_equal(bad_ours, bad_jax)
  assert bad_ours.any() and not bad_ours.all()


@pytest.mark.parametrize("reference_frame", [None, 0])
def test_homographies_wrt_frame_equal_jax(reference_frame):
  tracks, occ, dims = _homography_tracks(2)
  ours = viz.get_homographies_wrt_frame(tracks, occ, dims,
                                        reference_frame=reference_frame)
  theirs = jax_viz.get_homographies_wrt_frame(tracks, occ, dims,
                                              reference_frame=reference_frame)
  for a, b in zip(ours, theirs):
    np.testing.assert_allclose(a, b, atol=HOMOG_TOL, rtol=HOMOG_TOL)
  homogs = ours[0]
  assert homogs.shape == (6, 3, 3) and np.isfinite(homogs).all()


def test_plot_tracks_tails_equals_jax():
  tracks, occ, (w, h) = _homography_tracks(3, n=12, t=4)
  video = (np.random.RandomState(3).rand(4, int(h), int(w), 3) * 255).astype(
      np.uint8)
  homogs, _, _ = viz.get_homographies_wrt_frame(tracks, occ, (w, h))
  ours = viz.plot_tracks_tails(video, tracks, occ, homogs)
  theirs = jax_viz.plot_tracks_tails(video, tracks, occ, homogs)
  assert ours.shape == video.shape
  np.testing.assert_array_equal(ours, theirs)


def _read_frames(path):
  cap = cv2.VideoCapture(path)
  frames = []
  while True:
    ok, frame = cap.read()
    if not ok:
      break
    frames.append(frame[..., ::-1])
  cap.release()
  return np.stack(frames)


def test_write_visualization_equals_jax(tmp_path):
  video, tracks, occluded = _tracks(4)
  occ = occluded.astype(np.float32)
  np.random.seed(1)
  jax_viz.write_visualization(video[None], tracks[None], occ[None],
                              [str(tmp_path / "jax.mp4")])
  viz.write_visualization(video[None], tracks[None], occ[None],
                          [str(tmp_path / "ours.mp4")],
                          rng=np.random.RandomState(1))
  ours, theirs = (_read_frames(str(tmp_path / f"{n}.mp4"))
                  for n in ("ours", "jax"))
  assert ours.shape == video.shape
  np.testing.assert_array_equal(ours, theirs)


def test_visualize_example_equals_jax(tmp_path, monkeypatch):
  """tapvid/visualize on a TAP-Vid pickle entry (JPEG frames through PIL,
  taller than 360 so both resize to 360x640 with cv2): the same video. The
  palette `paint_point_track` shuffles without a seed is seeded on both
  sides."""
  import io

  from PIL import Image

  for module in (viz, jax_viz):
    monkeypatch.setattr(module, "get_colors",
                        lambda n, seed=None, f=module.get_colors: f(n, 0))

  rng = np.random.RandomState(6)
  jpegs = []
  for _ in range(3):
    buf = io.BytesIO()
    Image.fromarray((rng.rand(400, 500, 3) * 255).astype(np.uint8)).save(
        buf, format="JPEG")
    jpegs.append(buf.getvalue())
  example = dict(video=jpegs, points=rng.rand(5, 3, 2),
                 occluded=rng.rand(5, 3) > 0.6)
  visualize.visualize_example(example, str(tmp_path / "ours.mp4"))
  jax_visualize.visualize_example(example, str(tmp_path / "jax.mp4"))
  ours, theirs = (_read_frames(str(tmp_path / f"{n}.mp4"))
                  for n in ("ours", "jax"))
  assert ours.shape == (3, 360, 640, 3)
  np.testing.assert_array_equal(ours, theirs)
  with open(tmp_path / "davis.pkl", "wb") as f:
    pickle.dump({"a": example}, f)
  visualize.main(["--input_path", str(tmp_path / "davis.pkl"),
                  "--output_path", str(tmp_path / "cli.mp4"), "--index", "0"])
  np.testing.assert_array_equal(_read_frames(str(tmp_path / "cli.mp4")), ours)


def test_evaluate_dataset_writes_visualizations_as_jax(tmp_path):
  """evaluate_dataset(visualization_dir=...) on a tiny reader writes one mp4
  per video, as JAX's does, with the same metrics."""
  rng = np.random.RandomState(7)
  t, q, h, w = 4, 5, 32, 48
  examples = []
  for _ in range(3):
    examples.append({"e": dict(
        video=rng.uniform(-1, 1, (1, t, h, w, 3)).astype(np.float32),
        query_points=np.stack([np.zeros(q), rng.rand(q) * h, rng.rand(q) * w],
                              -1)[None].astype(np.float32),
        target_points=(rng.rand(1, q, t, 2) * [w, h]).astype(np.float32),
        occluded=rng.rand(1, q, t) > 0.7)})

  def predict(video, query_points):
    return dict(tracks=np.repeat(query_points[..., None, 2:0:-1], t, 2) + 1.0,
                occlusion=np.full((1, q, t), -3.0),
                expected_dist=np.full((1, q, t), -3.0))

  dirs = {name: str(tmp_path / name) for name in ("ours", "jax")}
  ours = evaluate.evaluate_dataset(predict, iter(examples), "first",
                                   verbose=False,
                                   visualization_dir=dirs["ours"])
  theirs = jax_evaluate.evaluate_dataset(predict, iter(examples), "first",
                                         verbose=False,
                                         visualization_dir=dirs["jax"])
  assert ours == pytest.approx(theirs, rel=0, abs=0)
  listing = {n: sorted(os.listdir(d)) for n, d in dirs.items()}
  assert listing["ours"] == listing["jax"] == [
      f"video_{i:04d}.mp4" for i in range(3)]
  assert _read_frames(os.path.join(dirs["ours"], "video_0000.mp4")).shape == (
      t, h, w, 3)

"""PyTorch port, the TAP-Vid dataset generator (tapvid/generate.py) and the
augmentation visualiser (data/augmentation_viz.py) against the JAX
package's: the same mp4 and CSV give equal shards, which the port's Kinetics
reader reads back; the visualiser warps on the CPU to JAX's frames.
"""

import csv
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
imageio = pytest.importorskip("imageio")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.data import augmentation_viz as jax_viz  # noqa: E402
from tapnet_tpu.tapvid import generate as jax_generate  # noqa: E402
from tapnet_tpu_torch.data import augmentation_viz  # noqa: E402
from tapnet_tpu_torch.tapvid import datasets, generate  # noqa: E402

CLIP = "abcdefghijk_000010_000020"
FRAMES, HEIGHT, WIDTH = 260, 48, 64


@pytest.fixture(scope="module")
def source(tmp_path_factory):
  """A 64x48 mp4 of 260 frames (a moving gradient) and a CSV with two
  tracks of its clip."""
  root = tmp_path_factory.mktemp("tapvid_source")
  videos = root / "videos" / "k"
  videos.mkdir(parents=True)
  writer = cv2.VideoWriter(str(videos / f"{CLIP}.mp4"),
                           cv2.VideoWriter_fourcc(*"mp4v"), 25,
                           (WIDTH, HEIGHT))
  yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
  for t in range(FRAMES):
    frame = np.stack([(xx * 4 + t) % 256, (yy * 5 + 2 * t) % 256,
                      np.full_like(xx, (3 * t) % 256)], -1).astype(np.uint8)
    writer.write(frame)
  writer.release()
  rng = np.random.RandomState(0)
  rows = []
  for _ in range(2):
    pts = np.concatenate([rng.rand(250, 2), rng.rand(250, 1) > 0.7], -1)
    rows.append(["abcdefghijk", "10", "20"]
                + [f"{v:.6f}" for v in pts.reshape(-1)])
  csv_path = root / "tracks.csv"
  with open(csv_path, "w", newline="") as f:
    csv.writer(f).writerows(rows)
  return str(csv_path), str(root / "videos")


def _shards(out):
  data = {}
  for name in sorted(os.listdir(out)):
    with open(os.path.join(out, name), "rb") as f:
      data[name] = pickle.load(f)
  return data


def test_generate_matches_jax(source, tmp_path):
  csv_path, video_root = source
  outs = {}
  for name, module in (("jax", jax_generate), ("port", generate)):
    out = str(tmp_path / name)
    assert module.generate_dataset(csv_path, video_root, out,
                                   num_shards=2, verbose=False) == 1
    outs[name] = _shards(out)
  assert list(outs["port"]) == list(outs["jax"]) == [
      "tapvid_kinetics_0000_of_0002.pkl", "tapvid_kinetics_0001_of_0002.pkl"]
  for shard, ref in outs["jax"].items():
    ours = outs["port"][shard]
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
      assert len(a["video"]) == 250
      assert list(a["video"]) == list(b["video"])
      np.testing.assert_array_equal(a["points"], b["points"])
      np.testing.assert_array_equal(a["occluded"], b["occluded"])
      assert a["points"].shape == (2, 250, 2) and a["occluded"].dtype == bool

  (element,) = list(datasets.create_kinetics_dataset(
      str(tmp_path / "port"), query_mode="first", resolution=(32, 48)))
  example = element["kinetics"]
  assert example["video"].shape == (1, 250, 32, 48, 3)
  assert example["target_points"].shape == (1, 2, 250, 2)
  assert np.abs(example["video"]).max() <= 1.0


def test_generate_cli_and_csv_checks(source, tmp_path, capsys, monkeypatch):
  csv_path, video_root = source
  out = str(tmp_path / "cli")
  monkeypatch.setattr(sys, "argv", [
      "generate", "--csv_path", csv_path, "--video_root_path", video_root,
      "--output_base_path", out, "--num_shards", "1"])
  generate.main()
  assert "done: 1 examples" in capsys.readouterr().out
  bad = tmp_path / "bad.csv"
  bad.write_text("a,1,2,0.5\n")
  with pytest.raises(ValueError, match="Expected 753 fields"):
    generate.read_annotations(str(bad))


def test_augmentation_viz_matches_jax(monkeypatch):
  """16 frames of each augmentation, warped on the CPU, within one grey
  level of JAX's; the warped track's ring lies on the red dot."""
  captured = []
  monkeypatch.setattr(imageio, "mimsave",
                      lambda path, frames, **kw: captured.append(frames))
  for mode in ("roll", "homography"):
    jax_viz.visualize(mode, "unused.gif", num_frames=16, seed=0)
    ref = np.stack(captured.pop())
    ours = np.stack(augmentation_viz.render(mode, 16, seed=0, device="cpu"))
    assert ours.shape == ref.shape == (16, 256, 256, 3)
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1, (mode, diff.max())
    video, tracks = augmentation_viz.make_dot_video(16)
    warped, moved = augmentation_viz.augment(mode, video, tracks, 0, "cpu")
    on_red = [augmentation_viz.is_red(warped[t, int(y), int(x)])
              for t, (x, y) in enumerate(moved[:, 0])
              if 0 <= x < 256 and 0 <= y < 256]
    assert np.mean(on_red) >= 0.95, (mode, on_red)

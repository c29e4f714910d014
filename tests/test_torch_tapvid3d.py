"""PyTorch port, TAPVid-3D (`tapnet_tpu_torch/tapvid3d/`): the metrics, the
evaluation CLI, the split lists, the ADT assembly and the annotation
downloads against the JAX package's, on the same numpy inputs made from a
seed. Both sides are host numpy with the same operations in the same order,
so every output is held equal (tolerance 0).
"""

import io
import json
import os
import sys
import urllib.error

import numpy as np
import pytest

pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.tapvid3d import adt as jax_adt
from tapnet_tpu.tapvid3d import evaluate as jax_eval3d
from tapnet_tpu.tapvid3d import generation as jax_generation
from tapnet_tpu.tapvid3d import metrics as jax_metrics3d
from tapnet_tpu.tapvid3d import splits as jax_splits
from tapnet_tpu_torch.tapvid3d import adt, generation, splits
from tapnet_tpu_torch.tapvid3d import evaluate as eval3d
from tapnet_tpu_torch.tapvid3d import metrics as metrics3d

SCALINGS = ("none", "median", "mean", "median_on_queries", "per_trajectory",
            "reproduce_2d", "local_neighborhood")


def random_case(seed=0, n=8, t=12):
  rng = np.random.RandomState(seed)
  gt_occ = rng.rand(n, t) > 0.75
  gt_tracks = rng.rand(n, t, 3) * np.array([2.0, 2.0, 5.0]) + np.array(
      [-1.0, -1.0, 1.0])
  pred_occ = rng.rand(n, t) > 0.7
  pred_tracks = gt_tracks * 1.1 + rng.randn(n, t, 3) * 0.05
  intrinsics = np.array([500.0, 510.0, 128.0, 128.0])
  qp = np.stack([rng.randint(0, t, n).astype(np.float64), rng.rand(n) * 256,
                 rng.rand(n) * 256], axis=-1)
  return gt_occ, gt_tracks, pred_occ, pred_tracks, intrinsics, qp


def _equal(ours, theirs):
  assert set(ours) == set(theirs)
  for k in theirs:
    np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(theirs[k]),
                                  err_msg=k)


@pytest.mark.parametrize("fixed", [False, True], ids=["adaptive", "fixed"])
@pytest.mark.parametrize("trackwise", [False, True], ids=["video", "track"])
@pytest.mark.parametrize("order", ["n t", "t n"])
@pytest.mark.parametrize("scaling", SCALINGS)
def test_metrics_equal_jax(scaling, order, trackwise, fixed):
  gt_occ, gt_tracks, pred_occ, pred_tracks, intr, qp = random_case(
      seed=SCALINGS.index(scaling))
  if order == "t n":
    gt_occ, pred_occ = gt_occ.T, pred_occ.T
    gt_tracks = np.transpose(gt_tracks, (1, 0, 2))
    pred_tracks = np.transpose(pred_tracks, (1, 0, 2))
  kwargs = dict(gt_occluded=gt_occ, gt_tracks=gt_tracks,
                pred_occluded=pred_occ, pred_tracks=pred_tracks,
                intrinsics_params=intr, scaling=scaling, query_points=qp,
                get_trackwise_metrics=trackwise,
                use_fixed_metric_threshold=fixed, order=order)
  ours = metrics3d.compute_tapvid3d_metrics(**kwargs)
  _equal(ours, jax_metrics3d.compute_tapvid3d_metrics(**kwargs))
  assert len(ours) == 13
  assert all(np.all((v >= 0) & (v <= 1)) for v in ours.values())


@pytest.mark.parametrize("order", ["b n t", "b t n"])
def test_batched_orders_equal_jax(order):
  """Two videos in one call, both batched orders, under the scalings whose
  factor broadcasts over a batch. The global scalings (median, mean) and
  local_neighborhood refuse a batch on both sides: JAX's median factor is
  [b, 1, 1] against [b, n, t, 3] tracks, which the port keeps."""
  cases = [random_case(seed=s) for s in (11, 12)]
  stack = lambda i: np.stack([c[i] for c in cases])
  gt_occ, gt_tracks, pred_occ, pred_tracks = (stack(i) for i in range(4))
  if order == "b t n":
    gt_occ, pred_occ = (np.swapaxes(x, 1, 2) for x in (gt_occ, pred_occ))
    gt_tracks, pred_tracks = (np.transpose(x, (0, 2, 1, 3))
                              for x in (gt_tracks, pred_tracks))
  kwargs = dict(gt_occluded=gt_occ, gt_tracks=gt_tracks,
                pred_occluded=pred_occ, pred_tracks=pred_tracks,
                intrinsics_params=cases[0][4], query_points=stack(5),
                order=order)
  for scaling in ("none", "per_trajectory", "reproduce_2d"):
    for trackwise in (False, True):
      _equal(metrics3d.compute_tapvid3d_metrics(
          scaling=scaling, get_trackwise_metrics=trackwise, **kwargs),
             jax_metrics3d.compute_tapvid3d_metrics(
                 scaling=scaling, get_trackwise_metrics=trackwise, **kwargs))
  for module in (metrics3d, jax_metrics3d):
    with pytest.raises(ValueError, match="local_neighborhood"):
      module.compute_tapvid3d_metrics(scaling="local_neighborhood", **kwargs)
    for scaling in ("median", "mean"):
      with pytest.raises(ValueError, match="broadcast"):
        module.compute_tapvid3d_metrics(scaling=scaling, **kwargs)


def test_projection_equal_jax():
  rng = np.random.RandomState(4)
  intr = np.array([500.0, 510.0, 128.0, 126.0])
  xyz = rng.rand(6, 5, 3) + np.array([-0.5, -0.5, 1.0])
  uv = metrics3d.project_to_pixels(xyz, intr)
  np.testing.assert_array_equal(uv, jax_metrics3d.project_to_pixels(xyz, intr))
  np.testing.assert_array_equal(
      metrics3d.unproject_pixels(uv, xyz[..., 2], intr),
      jax_metrics3d.unproject_pixels(uv, xyz[..., 2], intr))
  np.testing.assert_allclose(metrics3d.unproject_pixels(uv, xyz[..., 2], intr),
                             xyz, rtol=1e-12)


def _jpeg(frame):
  from PIL import Image

  buf = io.BytesIO()
  Image.fromarray(frame).save(buf, format="JPEG")
  return buf.getvalue()


@pytest.fixture(scope="module")
def npz_dirs(tmp_path_factory):
  """Three ground-truth / prediction npz pairs (JPEG frames through PIL,
  two image sizes), in a flat directory and under per-source subdirs."""
  root = tmp_path_factory.mktemp("tapvid3d")
  rng = np.random.RandomState(0)
  for source in ("", "adt", "pstudio"):
    gt_dir, pred_dir = root / "gt" / source, root / "pred" / source
    gt_dir.mkdir(parents=True, exist_ok=True)
    pred_dir.mkdir(parents=True, exist_ok=True)
    for v, (h, w) in enumerate([(64, 96), (80, 48), (64, 64)]):
      t, n = 5, 7
      jpeg = _jpeg((rng.rand(h, w, 3) * 255).astype(np.uint8))
      tracks = rng.rand(t, n, 3) + np.array([0, 0, 2.0])
      vis = rng.rand(t, n) > 0.3
      np.savez(gt_dir / f"vid{v}.npz",
               images_jpeg_bytes=np.array([jpeg] * t, object),
               queries_xyt=rng.rand(n, 3) * np.array([w, h, t - 1]),
               tracks_XYZ=tracks, visibility=vis,
               fx_fy_cx_cy=np.array([100.0, 110.0, w / 2, h / 2]))
      np.savez(pred_dir / f"vid{v}.npz",
               tracks_XYZ=tracks * 1.7 + rng.randn(t, n, 3) * 0.02,
               visibility=rng.rand(t, n) > 0.3)
  return str(root / "gt"), str(root / "pred")


def test_evaluate_directory_equals_jax(npz_dirs):
  gt_dir, pred_dir = npz_dirs
  scalings = ["median", "mean", "per_trajectory", "local_neighborhood"]
  ours = eval3d.evaluate_directory(gt_dir, pred_dir, scalings, verbose=False)
  theirs = jax_eval3d.evaluate_directory(gt_dir, pred_dir, scalings,
                                         verbose=False)
  assert ours == theirs and set(ours) == set(scalings)
  assert 0 < ours["median"]["average_jaccard"] < 1
  pair = [os.path.join(d, "vid1.npz") for d in npz_dirs]
  _equal(eval3d.evaluate_npz_pair(*pair, ["median"])["median"],
         jax_eval3d.evaluate_npz_pair(*pair, ["median"])["median"])
  assert eval3d.rescale_factor_for_short_side(64, 96) == 4.0


def test_evaluate_cli_equals_jax(npz_dirs, tmp_path, monkeypatch, capsys):
  """`python -m tapnet_tpu_torch.tapvid3d.evaluate` with the JAX CLI's
  flags (per-source subdirs, two scalings) writes the JAX CLI's JSON."""
  gt_dir, pred_dir = npz_dirs
  flags = ["--gt_dir", gt_dir, "--pred_dir", pred_dir, "--data_sources",
           "adt,pstudio", "--depth_scalings", "median,none"]
  ours_json, theirs_json = str(tmp_path / "o.json"), str(tmp_path / "t.json")
  ours = eval3d.main(flags + ["--output_json", ours_json])
  monkeypatch.setattr(sys, "argv", ["evaluate"] + flags
                      + ["--output_json", theirs_json])
  jax_eval3d.main()
  assert json.load(open(ours_json)) == json.load(open(theirs_json))
  assert set(ours) == {"adt", "pstudio"}
  assert '"average_jaccard"' in capsys.readouterr().out


@pytest.mark.parametrize("source", splits.SOURCES)
def test_split_lists_equal_jax(source):
  for split in splits.SPLITS:
    assert splits.get_split_files(source, split) == \
        jax_splits.get_split_files(source, split)
  assert splits.get_all_files(source) == jax_splits.get_all_files(source)
  for split in splits.SPLITS:
    name = f"{source}_{split}.txt"
    with open(os.path.join(splits._VENDORED_DIR, name), "rb") as a, open(  # pylint: disable=protected-access
        os.path.join(jax_splits._VENDORED_DIR, name), "rb") as b:  # pylint: disable=protected-access
      assert a.read() == b.read()


def test_split_env_override_and_refusals(tmp_path, monkeypatch):
  (tmp_path / "adt_minival.txt").write_text("a.npz\nb.npz\n")
  monkeypatch.setenv(splits.SPLITS_DIR_ENV, str(tmp_path))
  assert splits.get_minival_files("adt") == ["a.npz", "b.npz"]
  with pytest.raises(ValueError, match="source"):
    splits.get_split_files("kinetics", "minival")
  with pytest.raises(ValueError, match="split"):
    splits.get_split_files("adt", "train")


def _adt_fixture(root):
  """The fake ADT reader and released-style annotation of
  tests/test_tapvid3d.py's TestAdtGeneration, written under `root`."""
  rng = np.random.RandomState(0)
  total = 2 * adt.N_FRAMES
  yy, xx = np.mgrid[0:8, 0:8]
  video = np.stack([
      np.stack([(yy * 16 + i) % 256, (xx * 16) % 256,
                np.full_like(yy, i % 256)], -1) for i in range(total)
  ]).astype(np.uint8)

  class FakeReader:
    timestamps_ns = np.arange(total) * 100

    def read_chunk(self, ts):
      return [video[int(t) // 100] for t in ts]

  n, t = 5, adt.N_FRAMES
  chunk_frames = [adt.rotate_upright(f) for f in video[adt.N_FRAMES:]]
  ann = dict(queries_xyt=rng.rand(n, 3).astype(np.float32),
             tracks_XYZ=rng.rand(t, n, 3).astype(np.float32),
             visibility=(rng.rand(t, n) > 0.3),
             video_means=np.stack([f.mean(axis=(0, 1)) for f in chunk_frames]))
  in_dir = root / "in"
  in_dir.mkdir()
  np.savez(in_dir / "MySeq_seq001_1.npz", **ann)
  return FakeReader, str(in_dir)


def test_adt_process_sequence_equals_jax(tmp_path):
  reader, in_dir = _adt_fixture(tmp_path)
  outputs = []
  for name, module in (("ours", adt), ("jax", jax_adt)):
    out_dir = str(tmp_path / name)
    written = module.process_sequence("", in_dir, out_dir, "MySeq_seq001",
                                      [1], reader=reader())
    assert written == [os.path.join(out_dir, "MySeq_seq001_1.npz")]
    with np.load(written[0], allow_pickle=True) as z:
      outputs.append({k: z[k] for k in z.files})
  ours, theirs = outputs
  assert set(ours) == set(theirs)
  for k in theirs:
    if k == "images_jpeg_bytes":
      assert list(ours[k]) == list(theirs[k])
    else:
      np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
  assert generation.verify_example(
      os.path.join(tmp_path, "ours", "MySeq_seq001_1.npz")) == \
      jax_generation.verify_example(
          os.path.join(tmp_path, "jax", "MySeq_seq001_1.npz"))


def test_adt_helpers_equal_jax(tmp_path):
  for v1 in ("Apartment_release_multiskeleton_party_seq114",
             "Lite_release_recognition_BambooPlate_seq031",
             "Apartment_release_clean_seq131"):
    assert adt.adt_v2_sequence_name(v1) == jax_adt.adt_v2_sequence_name(v1)
  im = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
  np.testing.assert_array_equal(adt.rotate_upright(im),
                                jax_adt.rotate_upright(im))
  in_dir, out_dir = tmp_path / "in", tmp_path / "out"
  in_dir.mkdir(), out_dir.mkdir()
  for name in ("Seq_A_seq01_0.npz", "Seq_A_seq01_2.npz", "Seq_B_seq02_1.npz"):
    np.savez(in_dir / name, x=np.zeros(1))
  np.savez(out_dir / "Seq_A_seq01_2.npz", x=np.zeros(1))
  pending = adt.pending_chunks_by_sequence(str(in_dir), str(out_dir))
  assert pending == jax_adt.pending_chunks_by_sequence(str(in_dir),
                                                       str(out_dir))
  assert pending == {"Seq_A_seq01": [0], "Seq_B_seq02": [1]}
  frames = [np.random.RandomState(1).randint(0, 255, (4, 4, 3), np.uint8)]
  ann = dict(queries_xyt=np.zeros((1, 3)), tracks_XYZ=np.zeros((1, 1, 3)),
             visibility=np.zeros((1, 1), bool), video_means=np.zeros((1, 3)))
  with pytest.raises(ValueError, match="video_means"):
    adt.assemble_example(frames, ann)


def test_download_split_over_file_url(tmp_path):
  """download_split / download_annotations fetch from a file:// base URL
  (a bucket mirror) into the same files as JAX's; the CLI's drivetrack
  path does the same."""
  src = tmp_path / "bucket" / "drivetrack"
  src.mkdir(parents=True)
  names = splits.get_minival_files("drivetrack")[:2]
  for i, name in enumerate(names):
    np.savez(src / name, x=np.arange(3) + i)
  base = "file://" + str(tmp_path / "bucket")
  got = generation.download_split("drivetrack", "minival",
                                  str(tmp_path / "ours"), base_url=base,
                                  debug=True, verbose=False)
  want = jax_generation.download_split("drivetrack", "minival",
                                       str(tmp_path / "jax"), base_url=base,
                                       debug=True, verbose=False)
  assert [os.path.relpath(p, tmp_path / "ours") for p in got] == \
      [os.path.relpath(p, tmp_path / "jax") for p in want]
  with np.load(got[0]) as z:
    np.testing.assert_array_equal(z["x"], np.arange(3))
  both = generation.download_annotations("drivetrack", names,
                                         str(tmp_path / "two"), base_url=base,
                                         verbose=False)
  assert [os.path.basename(p) for p in both] == names
  generation.main(["--source", "drivetrack", "--split", "minival",
                   "--output_dir", str(tmp_path / "cli"), "--debug",
                   "--base_url", base])
  assert os.listdir(tmp_path / "cli" / "drivetrack") == [names[0]]


def test_missing_download_fails_loudly(tmp_path):
  for module in (generation, jax_generation):
    with pytest.raises(urllib.error.URLError):
      module.download_annotations(
          "drivetrack", ["does_not_exist.npz"], str(tmp_path / "out"),
          base_url="file://" + str(tmp_path / "bucket"), verbose=False)
    assert not os.path.exists(tmp_path / "out" / "drivetrack" /
                              "does_not_exist.npz")
  with pytest.raises(ValueError, match="source"):
    generation.download_annotations("kinetics", [], str(tmp_path))


def test_join_pstudio_frames_equals_jax(tmp_path):
  """A PStudio annotation without a frame list, joined with the sorted jpgs
  of its camera directory (cv2 decode + encode), equal to JAX's npz."""
  import cv2

  frames_dir = tmp_path / "ims" / "3"
  frames_dir.mkdir(parents=True)
  rng = np.random.RandomState(2)
  for i in range(3):
    cv2.imwrite(str(frames_dir / f"{i:03d}.jpg"),
                (rng.rand(16, 24, 3) * 255).astype(np.uint8))
  ann = tmp_path / "seq_3.npz"
  np.savez(ann, queries_xyt=rng.rand(2, 3), tracks_XYZ=rng.rand(3, 2, 3),
           visibility=rng.rand(3, 2) > 0.5,
           fx_fy_cx_cy=np.array([20.0, 20.0, 12.0, 8.0]))
  outs = []
  for name, module in (("ours", generation), ("jax", jax_generation)):
    out = module.join_pstudio_frames(str(ann), str(frames_dir),
                                     str(tmp_path / f"{name}.npz"))
    with np.load(out, allow_pickle=True) as z:
      outs.append({k: z[k] for k in z.files})
  assert set(outs[0]) == set(outs[1])
  assert list(outs[0]["images_jpeg_bytes"]) == list(outs[1]["images_jpeg_bytes"])
  assert generation.verify_example(str(tmp_path / "ours.npz"))["num_frames"] == 3

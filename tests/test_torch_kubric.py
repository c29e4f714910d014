"""PyTorch port, the Kubric training reader against the JAX package
(`data/augmentations.py`, `data/kubric.py`, `data/kubric_convert.py`,
`data/native_loader.py`, `training/run.py --data_dir`).

The TAPNext++ augmentations' draws (numpy RandomState, as in JAX) equal
JAX's bit for bit; `compose_homographies` and `transform_points` within
HOMOG_TOL; `warp_video` within WARP_TOL; `warp_video_u8` equal except for
values one step apart where JAX's float lies within U8_MIDPOINT of a
rounding midpoint (counted); `prepare_batch` on JAX's own draws (query
tracks and frames, colour transform) exported as numpy: video within
VIDEO_TOL, query points and tracks equal. The reader path as
tests/test_configs_data.py drives JAX's (write_examples -> KubricNpzReader ->
training_iterator, the geometric augmentation, the CLI); the native loader
on the port's own copy of loader.cc as tests/test_native_loader.py drives
JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.data import augmentations as jax_aug
from tapnet_tpu.data import kubric as jax_kubric
from tapnet_tpu_torch.data import augmentations, kubric, kubric_convert
from tapnet_tpu_torch.data import native_loader

# float64 matrices on both sides (numpy): summation order only.
HOMOG_TOL = 1e-6
# float32 warps: the inverse homography and the sampling weights.
WARP_TOL = 1e-5
U8_MIDPOINT = 1e-4
# float32 resize (antialiased bilinear) and colour transform.
VIDEO_TOL = 1e-5
NATIVE_TOL = 1e-5


# ------------------------------------------------------- augmentations


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_augmentation_draws_equal_jax(seed):
  t, h, w = 9, 40, 56
  for cls, jcls in ((augmentations.RollAugmentation, jax_aug.RollAugmentation),
                    (augmentations.HomographyAugmentation,
                     jax_aug.HomographyAugmentation)):
    ours, theirs = cls(seed=seed, device="cpu"), jcls(seed=seed)
    for _ in range(3):
      a = ours.sample_homographies(t, h, w)
      b = theirs.sample_homographies(t, h, w)
      assert (a is None) == (b is None)
      if a is not None:
        np.testing.assert_array_equal(a, b)


def _homographies(seed=0, t=4, h=24, w=32):
  roll = jax_aug.RollAugmentation(seed=seed, p=1.0)
  homog = jax_aug.HomographyAugmentation(seed=seed + 1, p=1.0)
  return roll.sample_homographies(t, h, w), homog.sample_homographies(t, h, w)


def test_compose_and_transform_points():
  r, m = _homographies()
  composed = augmentations.compose_homographies(m, r)
  np.testing.assert_allclose(composed, jax_aug.compose_homographies(m, r),
                             rtol=HOMOG_TOL, atol=0)
  pts = np.random.RandomState(1).rand(4, 7, 2) * [32, 24]
  np.testing.assert_allclose(augmentations.transform_points(composed, pts),
                             jax_aug.transform_points(composed, pts),
                             rtol=HOMOG_TOL, atol=HOMOG_TOL)


def test_warp_video_and_uint8():
  r, m = _homographies()
  composed = augmentations.compose_homographies(m, r)
  rng = np.random.RandomState(2)
  video = (rng.rand(4, 24, 32, 3) * 255).astype(np.float32)
  want = np.asarray(jax_aug.warp_video(jnp.asarray(video),
                                       jnp.asarray(composed)))
  got = augmentations.warp_video(torch.from_numpy(video),
                                 torch.as_tensor(composed, dtype=torch.float32))
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=WARP_TOL * np.abs(want).max())
  assert (want == 0).any() and (want > 0).any()

  u8 = video.astype(np.uint8)
  want_u8 = np.asarray(jax_aug.warp_video_u8(jnp.asarray(u8),
                                             jnp.asarray(composed)))
  got_u8 = augmentations.warp_video_u8(
      torch.from_numpy(u8), torch.as_tensor(composed, dtype=torch.float32)
  ).numpy()
  want_f = np.asarray(jax_aug.warp_video(jnp.asarray(u8.astype(np.float32)),
                                         jnp.asarray(composed)))
  apart = got_u8.astype(int) - want_u8.astype(int)
  near_midpoint = np.abs(want_f - np.floor(want_f) - 0.5) <= U8_MIDPOINT
  assert np.abs(apart).max() <= 1
  assert not (apart != 0)[~near_midpoint].any()
  assert (apart != 0).sum() <= near_midpoint.sum()


def test_roll_call_moves_video_and_tracks():
  r = augmentations.RollAugmentation(seed=4, p=1.0, device="cpu")
  jr = jax_aug.RollAugmentation(seed=4, p=1.0)
  rng = np.random.RandomState(3)
  data = dict(video=rng.rand(3, 16, 20, 3).astype(np.float32),
              tracks=(rng.rand(3, 5, 2) * [20, 16]).astype(np.float32))
  got, want = r(data), jr(data)
  np.testing.assert_allclose(got["video"], want["video"], rtol=0, atol=WARP_TOL)
  np.testing.assert_allclose(got["tracks"], want["tracks"], rtol=HOMOG_TOL,
                             atol=1e-4)


# ------------------------------------------------------- prepare_batch


def _jax_draws(key, batch, num_queries):
  """JAX prepare_batch's own draws from `key`: per example the query tracks
  and frames, and per video the colour transform."""
  occ = np.asarray(batch["occluded"], np.float32)
  b, n, t = occ.shape
  rngs = jax.random.split(key, b + 1)
  tracks, frames = [], []
  for i in range(b):
    k1, k2 = jax.random.split(rngs[1 + i])
    visible = 1.0 - jnp.asarray(occ[i])
    track_w = visible.sum(-1) + 1e-6
    tr = jax.random.choice(k1, n, (num_queries,), p=track_w / track_w.sum())
    logits = jnp.where(visible[tr] > 0, 0.0, -1e9)
    tracks.append(np.asarray(tr))
    frames.append(np.asarray(jax.random.categorical(k2, logits, axis=-1)))
  draws = dict(query_tracks=torch.tensor(np.stack(tracks)).long(),
               query_frames=torch.tensor(np.stack(frames)).long())
  ranges = dict(brightness=(-32.0 / 255.0, 32.0 / 255.0),
                saturation=(0.6, 1.4), hue=(-0.2, 0.2), contrast=(0.6, 1.4),
                augment=(0.0, 1.0), drop=(0.0, 1.0))
  color = {k: [] for k in ranges}
  for video_key in jax.random.split(rngs[0], b):
    keys = jax.random.split(video_key, 7)
    for i, (name, (lo, hi)) in enumerate(ranges.items()):
      color[name].append(float(jax.random.uniform(keys[i], (), minval=lo,
                                                   maxval=hi)))
  draws.update({f"color/{k}": torch.tensor(v, dtype=torch.float32)
                for k, v in color.items()})
  return draws


def _batch(b=3, t=5, h=40, w=36, n=7, seed=0):
  rng = np.random.RandomState(seed)
  occ = rng.rand(b, n, t) > 0.6
  occ[0, 2] = True  # a track never visible
  return dict(video=(rng.rand(b, t, h, w, 3) * 255).astype(np.uint8),
              target_points=(rng.rand(b, n, t, 2) * [w, h]).astype(np.float32),
              occluded=occ)


@pytest.mark.parametrize("color_augment", [False, True])
def test_prepare_batch_on_jax_draws(color_augment):
  batch = _batch()
  key = jax.random.PRNGKey(5)
  want = jax_kubric.prepare_batch(
      key, {k: jnp.asarray(v) for k, v in batch.items()}, (24, 32), 9,
      color_augment)
  draws = _jax_draws(key, batch, 9)
  got = kubric.prepare_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                             draws, (24, 32), color_augment)
  assert got["video"].shape == (3, 5, 24, 32, 3)
  np.testing.assert_allclose(got["video"].numpy(), np.asarray(want["video"]),
                             rtol=0, atol=VIDEO_TOL)
  for key_ in ("query_points", "target_points", "occluded"):
    np.testing.assert_array_equal(got[key_].numpy(), np.asarray(want[key_]))


def test_batch_draws_take_visible_frames():
  batch = _batch(seed=1)
  occ = torch.from_numpy(batch["occluded"])
  d = kubric.batch_draws(torch.Generator().manual_seed(0), occ, 50)
  assert d["query_tracks"].shape == d["query_frames"].shape == (3, 50)
  assert set(d) >= {"color/brightness", "color/augment", "color/drop"}
  for b in range(3):
    for tr, fr in zip(d["query_tracks"][b], d["query_frames"][b]):
      assert not occ[b, tr, fr]  # only the never-visible track has none
  assert not (d["query_tracks"][0] == 2).any()


# -------------------------------------------------- reader and convert


def _make_npz_dir(path, n=3, t=4, h=24, w=24, tracks=6):
  rng = np.random.RandomState(0)
  for i in range(n):
    np.savez(
        os.path.join(path, f"ex_{i}.npz"),
        video=(rng.rand(t, h, w, 3) * 255).astype(np.uint8),
        target_points=(rng.rand(tracks, t, 2) * [w, h]).astype(np.float32),
        occluded=rng.rand(tracks, t) > 0.7)
  return str(path)


def _check_contract(batch, b=2, q=5, t=4, size=16, atol=1e-5):
  assert batch["video"].shape == (b, t, size, size, 3)
  assert batch["query_points"].shape == (b, q, 3)
  assert batch["target_points"].shape == (b, q, t, 2)
  assert batch["occluded"].shape == (b, q, t)
  qp, tp, occ = (batch[k].numpy() for k in
                 ("query_points", "target_points", "occluded"))
  for i in range(b):
    for j in range(q):
      f = int(qp[i, j, 0])
      assert occ[i, j, f] == 0.0
      np.testing.assert_allclose(qp[i, j, 1:], tp[i, j, f][::-1], rtol=atol,
                                 atol=atol)


@pytest.mark.parametrize("geometric", [False, True])
def test_training_iterator(tmp_path, geometric):
  path = _make_npz_dir(tmp_path)
  it = kubric.training_iterator(
      path, batch_size=2, train_size=(16, 16), num_queries=5,
      color_augment=not geometric, geometric_augment=geometric, seed=7,
      device="cpu")
  batch = next(it)
  _check_contract(batch, atol=1e-4 if geometric else 1e-5)
  assert batch["video"].dtype == torch.float32
  if not geometric:
    assert batch["target_points"].max() <= 16.0 + 1e-4
  assert it.reader.wait_s >= 0.0


def test_geometric_transform_moves_tracks_with_video():
  t, h, w = 4, 48, 48
  video = np.zeros((t, h, w, 3), np.uint8)
  pos = np.array([[24.0, 24.0]] * t, np.float32)
  for i in range(t):
    x, y = int(pos[i, 0]), int(pos[i, 1])
    video[i, y - 1:y + 2, x - 1:x + 2] = 255
  example = dict(video=video, target_points=pos[None],
                 occluded=np.zeros((1, t), bool))
  out = kubric.geometric_augmentation(seed=3, device="cpu")(example)
  want = jax_kubric.geometric_augmentation(seed=3)(example)
  np.testing.assert_allclose(out["target_points"], want["target_points"],
                             rtol=HOMOG_TOL, atol=1e-4)
  assert np.abs(out["video"].astype(int) - want["video"].astype(int)).max() <= 1
  assert out["video"].dtype == np.uint8 and out["video"].shape == video.shape
  moved = False
  for i in range(t):
    x, y = out["target_points"][0, i]
    if not (1 <= x < w - 1 and 1 <= y < h - 1):
      continue
    patch = out["video"][i, int(y) - 2:int(y) + 3, int(x) - 2:int(x) + 3]
    assert patch.max() > 100, f"frame {i}: track lost the dot"
    moved |= not np.allclose(out["target_points"][0, i], pos[i], atol=0.5)
  assert moved


def _pipeline_examples(n=2, t=4, h=24, w=24, tracks=6):
  rng = np.random.RandomState(1)
  for i in range(n):
    ex = dict(video=rng.rand(t, h, w, 3).astype(np.float32) * 2.0 - 1.0,
              target_points=rng.rand(tracks, t, 2).astype(np.float64) * [w, h],
              occluded=rng.rand(tracks, t) > 0.7)
    yield {k: v[None] for k, v in ex.items()} if i == 0 else ex


def test_convert_then_ingest(tmp_path):
  out_dir = str(tmp_path / "npz")
  assert kubric_convert.write_examples(_pipeline_examples(), out_dir) == 2
  from tapnet_tpu.data import kubric_convert as jax_convert
  for ex in _pipeline_examples():
    ours, theirs = (m.example_to_npz_arrays(ex)
                    for m in (kubric_convert, jax_convert))
    for k in theirs:
      np.testing.assert_array_equal(ours[k], theirs[k])
  batch = next(kubric.training_iterator(
      out_dir, batch_size=2, train_size=(16, 16), num_queries=5,
      color_augment=False, device="cpu"))
  assert batch["video"].shape == (2, 4, 16, 16, 3)
  assert batch["video"].min() >= -1.0 - 1e-5
  assert batch["query_points"].shape == (2, 5, 3)


def test_num_examples_cap_and_schema_errors(tmp_path):
  out_dir = str(tmp_path / "cap")
  assert kubric_convert.write_examples(_pipeline_examples(n=5), out_dir,
                                       num_examples=3) == 3
  assert len(list((tmp_path / "cap").glob("*.npz"))) == 3
  with pytest.raises(KeyError):
    kubric_convert.example_to_npz_arrays({"video": np.zeros((2, 4, 4, 3))})
  with pytest.raises(ValueError):
    kubric_convert.example_to_npz_arrays({
        "video": np.zeros((2, 4, 4, 3), np.uint8),
        "target_points": np.zeros((3, 9, 2)),
        "occluded": np.zeros((3, 9), bool)})
  with pytest.raises(ImportError, match="kubric"):
    next(kubric_convert.kubric_tf_source())


def test_reader_refuses_the_cpu_unless_asked(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present: the default device is usable")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    kubric.training_iterator(_make_npz_dir(tmp_path), batch_size=1)


def test_run_cli_trains_from_data_dir(tmp_path):
  from tapnet_tpu_torch.training import run

  data_dir = str(tmp_path / "kubric")
  examples = ({
      "video": (np.random.RandomState(i).rand(3, 40, 48, 3) * 255).astype(
          np.uint8),
      "target_points": np.random.RandomState(i).rand(6, 3, 2) * [48, 40],
      "occluded": np.random.RandomState(i).rand(6, 3) > 0.5} for i in range(2))
  kubric_convert.write_examples(examples, data_dir)
  state = run.main(["--experiment", "bootstapir", "--data_dir", data_dir,
                    "--smoke", "--num_steps", "1", "--log_every", "1",
                    "--device", "cpu"])
  assert state.step == 1


# ---------------------------------------------------------- native loader


@pytest.fixture(scope="module")
def video_files(tmp_path_factory):
  d = tmp_path_factory.mktemp("videos")
  rng = np.random.RandomState(0)
  paths = []
  for i, (t, h, w) in enumerate([(6, 40, 56), (3, 24, 24), (8, 31, 17)]):
    p = str(d / f"vid_{i}.npy")
    np.save(p, (rng.rand(t, h, w, 3) * 255).astype(np.uint8))
    paths.append(p)
  return paths


def test_native_library_builds():
  assert native_loader.load_library() is not None
  assert native_loader._library_path().parent == native_loader.BUILD_DIR  # pylint: disable=protected-access


def test_native_matches_numpy_oracle(video_files):
  from tapnet_tpu.data import native_loader as jax_native

  loader = native_loader.NativeVideoLoader(
      video_files[:1], batch_size=1, num_frames=6, height=32, width=48,
      num_threads=2, shuffle=False)
  assert loader.is_native
  batch = next(loader)
  assert batch.shape == (1, 6, 32, 48, 3)
  video = np.load(video_files[0])
  ref = native_loader.resize_normalize_reference(video, 32, 48)
  np.testing.assert_array_equal(
      ref, jax_native.resize_normalize_reference(video, 32, 48))
  np.testing.assert_allclose(batch[0], ref, rtol=NATIVE_TOL, atol=NATIVE_TOL)
  loader.close()


def test_native_short_clip_repeats_last_frame(video_files):
  loader = native_loader.NativeVideoLoader(
      video_files[1:2], batch_size=1, num_frames=5, height=16, width=16,
      num_threads=1, shuffle=False)
  batch = next(loader)
  np.testing.assert_array_equal(batch[0, 2], batch[0, 3])
  np.testing.assert_array_equal(batch[0, 2], batch[0, 4])
  loader.close()


def test_native_python_path_same_semantics(video_files):
  kw = dict(batch_size=3, num_frames=4, height=20, width=20, shuffle=False)
  nat = native_loader.NativeVideoLoader(video_files, num_threads=1, **kw)
  py = native_loader.NativeVideoLoader(video_files, num_threads=0, **kw)
  assert nat.is_native and not py.is_native
  np.testing.assert_allclose(next(nat), next(py), rtol=NATIVE_TOL,
                             atol=NATIVE_TOL)
  nat.close()


def test_native_many_batches_multithreaded(video_files):
  loader = native_loader.NativeVideoLoader(
      video_files, batch_size=2, num_frames=4, height=24, width=24,
      num_threads=4, prefetch=3, shuffle=True)
  for _ in range(10):
    batch = next(loader)
    assert batch.shape == (2, 4, 24, 24, 3)
    assert np.isfinite(batch).all()
    assert batch.min() >= -1.0 and batch.max() <= 1.0
  loader.close()


def test_native_bad_file_reports_error(tmp_path):
  bad = str(tmp_path / "bad.npy")
  with open(bad, "wb") as f:
    f.write(b"not an npy")
  loader = native_loader.NativeVideoLoader(
      [bad], batch_size=1, num_frames=2, height=8, width=8, num_threads=1)
  with pytest.raises(RuntimeError, match="npy"):
    next(loader)
  loader.close()


def test_native_float_video_rejected(tmp_path):
  p = str(tmp_path / "f32.npy")
  np.save(p, np.zeros((2, 8, 8, 3), np.float32))
  loader = native_loader.NativeVideoLoader(
      [p], batch_size=1, num_frames=2, height=8, width=8, num_threads=1)
  with pytest.raises(RuntimeError):
    next(loader)
  loader.close()


def test_native_build_failure_raises(tmp_path, monkeypatch):
  """A build that cannot run raises; nothing falls back to the numpy path."""
  monkeypatch.setenv("PATH", str(tmp_path))
  monkeypatch.setattr(native_loader, "_LIB", None)
  monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "_build")
  with pytest.raises(RuntimeError, match="build failed"):
    native_loader.NativeVideoLoader(["x.npy"], num_threads=1)

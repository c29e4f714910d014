"""PyTorch port, the TAP-Vid evaluation layer against the JAX package: the
metrics (`compute_tapvid_metrics` in both query modes, `latex_table`,
`compute_pck_metrics`, `aj_rd.compute_redetection_metrics`,
`jhmdb.pck_evaluate`), the query samplers and every reader, on seeded numpy
inputs and tiny files written to tmp_path, must be exactly equal to JAX's;
the committed draws of the held-out set a, rendered by the port, give the
JAX package's exported video 0; the TAPNext torch-checkpoint import gives
JAX's flat tree bit for bit.
"""

import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.checkpoints import tapnext_torch_import as jax_import
from tapnet_tpu.data import synthetic as jax_synthetic
from tapnet_tpu.tapvid import aj_rd as jax_aj_rd
from tapnet_tpu.tapvid import datasets as jax_datasets
from tapnet_tpu.tapvid import jhmdb as jax_jhmdb
from tapnet_tpu.tapvid import metrics as jax_metrics
from tapnet_tpu_torch.checkpoints import convert, tapnext_checkpoint
from tapnet_tpu_torch.checkpoints import tapnext_torch_import
from tapnet_tpu_torch.data import synthetic
from tapnet_tpu_torch.models import ssm_vit, tapnext
from tapnet_tpu_torch.tapvid import aj_rd, datasets, jhmdb, metrics
from tools import make_eval_draws
from tools.tapnext_weights import seeded_tapnext_params


def _assert_same(ours, theirs, where=""):
  """Equal nested dicts / arrays / scalars (NaN equal to NaN)."""
  if isinstance(theirs, dict):
    assert set(ours) == set(theirs), where
    for k in theirs:
      _assert_same(ours[k], theirs[k], f"{where}/{k}")
  elif isinstance(theirs, str):
    assert ours == theirs, where
  else:
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, where
    np.testing.assert_array_equal(ours, theirs, err_msg=where)


# ------------------------------------------------------------------ metrics


def _tapvid_case(seed=0, b=2, n=12, t=24):
  rng = np.random.RandomState(seed)
  query_points = np.stack([rng.randint(0, t, (b, n)).astype(np.float64),
                           rng.rand(b, n) * 256, rng.rand(b, n) * 256], -1)
  gt_occ = rng.rand(b, n, t) > 0.7
  gt_tracks = rng.rand(b, n, t, 2) * 256
  pred_occ = rng.rand(b, n, t) > 0.6
  pred_tracks = gt_tracks + rng.randn(b, n, t, 2) * 4
  return query_points, gt_occ, gt_tracks, pred_occ, pred_tracks


@pytest.mark.parametrize("trackwise", [False, True], ids=["video", "track"])
@pytest.mark.parametrize("mode", ["strided", "first"])
def test_tapvid_metrics_equal_jax(mode, trackwise):
  case = _tapvid_case(seed=3)
  ours = metrics.compute_tapvid_metrics(*case, mode, trackwise)
  _assert_same(ours, jax_metrics.compute_tapvid_metrics(*case, mode, trackwise))
  assert ours["average_jaccard"].shape == ((2, 12) if trackwise else (2,))
  with pytest.raises(ValueError, match="query mode"):
    metrics.compute_tapvid_metrics(*case, "dense")


def test_latex_table_and_pck_equal_jax():
  rng = np.random.RandomState(4)
  scalars = {k: float(rng.rand()) for k in metrics.TABLE_FIELDS}
  assert metrics.latex_table(scalars) == jax_metrics.latex_table(scalars)
  pck = {f"PCK@0.{k}": float(rng.rand()) for k in range(1, 6)}
  assert metrics.latex_table(pck) == jax_metrics.latex_table(pck)
  dist, scale = rng.rand(3, 15, 20) * 40, rng.rand(3, 1, 20) * 100 + 10
  assert metrics.compute_pck_metrics(dist, scale) == (
      jax_metrics.compute_pck_metrics(dist, scale))


def test_redetection_metrics_equal_jax():
  rng = np.random.RandomState(5)
  b, t, n = 2, 40, 6
  gt_vis = rng.rand(b, t, n) > 0.4
  gt_tracks = rng.rand(b, t, n, 2) * 256
  pred_vis = rng.rand(b, t, n) > 0.4
  pred_tracks = gt_tracks + rng.randn(b, t, n, 2) * 3
  args = (pred_tracks, pred_vis, gt_tracks, gt_vis)
  ours = aj_rd.compute_redetection_metrics(*args)
  assert not np.isnan(ours["AJ_RD"])
  _assert_same(ours, jax_aj_rd.compute_redetection_metrics(*args))
  # No reappearance at all: every entry NaN on both sides.
  always = np.ones_like(gt_vis)
  _assert_same(aj_rd.compute_redetection_metrics(pred_tracks, pred_vis,
                                                 gt_tracks, always),
               jax_aj_rd.compute_redetection_metrics(pred_tracks, pred_vis,
                                                     gt_tracks, always))


def test_pck_evaluate_equal_jax():
  rng = np.random.RandomState(6)
  results = []
  for _ in range(3):
    gt = rng.rand(1, jhmdb.NUM_JOINTS, 9, 2) * [[[[60, 40]]]]
    gt[0, rng.randint(jhmdb.NUM_JOINTS), 0, 0] = -3.0  # an invalid joint
    results.append(dict(pred_pose=gt + rng.randn(*gt.shape) * 4,
                        gt_pose_orig=gt, im_size=np.array([40, 60])))
  _assert_same(jhmdb.pck_evaluate(results), jax_jhmdb.pck_evaluate(results))


# ---------------------------------------------------------------- samplers


def _tracks(seed=0, n=7, t=13):
  rng = np.random.RandomState(seed)
  occ = rng.rand(n, t) > 0.6
  occ[0] = True  # a track never visible
  return occ, (rng.rand(n, t, 2) * 50).astype(np.float32), (
      rng.rand(t, 4, 5, 3) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("sampler", ["sample_queries_strided",
                                     "sample_queries_first"])
def test_samplers_equal_jax(sampler):
  args = _tracks(seed=7)
  _assert_same(getattr(datasets, sampler)(*args),
               getattr(jax_datasets, sampler)(*args))


# ----------------------------------------------------------------- readers


def _video(rng, t, h, w):
  return (rng.rand(t, h, w, 3) * 255).astype(np.uint8)


def _pickle_examples(rng, num, t=5, h=32, w=40, n=3, jpeg=True):
  """Pickle-benchmark examples; `jpeg` stores the frames as JPEG bytes."""
  import cv2

  out = []
  for _ in range(num):
    video = _video(rng, t, h, w)
    frames = ([cv2.imencode(".jpg", f)[1].tobytes() for f in video]
              if jpeg else video)
    out.append(dict(video=frames, points=rng.rand(n, t, 2).astype(np.float32),
                    occluded=rng.rand(n, t) > 0.7))
  return out


def _write_pickle(path, obj):
  with open(path, "wb") as f:
    pickle.dump(obj, f)
  return str(path)


def _same_reader(name, *args, **kwargs):
  ours = list(getattr(datasets, name)(*args, **kwargs))
  theirs = list(getattr(jax_datasets, name)(*args, **kwargs))
  assert len(ours) == len(theirs) > 0
  for a, b in zip(ours, theirs):
    _assert_same(a, b)
  return ours


@pytest.mark.parametrize("resolution", [(32, 40), (16, 16)],
                         ids=["native", "resized"])
@pytest.mark.parametrize("mode", ["strided", "first"])
def test_pickle_readers_equal_jax(tmp_path, mode, resolution):
  """DAVIS (a dict of JPEG-byte videos), RGB-stacking (a list) and Kinetics
  (sharded pickles) decode, resize, scale and sample as JAX's readers do."""
  rng = np.random.RandomState(8)
  davis = _write_pickle(tmp_path / "davis.pkl", {
      f"v{i}": ex for i, ex in enumerate(_pickle_examples(rng, 2))})
  robotics = _write_pickle(tmp_path / "robotics.pkl",
                           _pickle_examples(rng, 2, jpeg=False))
  kinetics = tmp_path / "kinetics"
  kinetics.mkdir()
  for s in range(2):
    _write_pickle(kinetics / f"part_{s}_of_0002.pkl", _pickle_examples(rng, 1))
  kw = dict(query_mode=mode, resolution=resolution)
  out = _same_reader("create_davis_dataset", davis, **kw)
  assert out[0]["davis"]["video"].shape == (1, 5) + resolution + (3,)
  _same_reader("create_rgb_stacking_dataset", robotics, **kw)
  _same_reader("create_kinetics_dataset", str(kinetics), **kw)


@pytest.mark.parametrize("train_size", [(32, 40), (16, 16)],
                         ids=["native", "resized"])
def test_kubric_reader_equals_jax(tmp_path, train_size):
  rng = np.random.RandomState(9)
  for i in range(3):
    np.savez(tmp_path / f"ex_{i:03d}.npz", video=_video(rng, 4, 32, 40),
             target_points=rng.rand(5, 4, 2).astype(np.float32) * [40, 32],
             occluded=rng.rand(5, 4) > 0.8)
  for mode in ("strided", "first"):
    _same_reader("create_kubric_dataset", str(tmp_path), mode, train_size)
  assert len(_same_reader("create_kubric_dataset", str(tmp_path), "first",
                          train_size, max_dataset_size=2)) == 2
  with pytest.raises(ValueError, match="No npz"):
    list(datasets.create_kubric_dataset(str(tmp_path / "none")))


def test_csv_reader_equals_jax(tmp_path):
  """A CSV of normalized (x, y, occluded) triplets beside an mp4 written
  with cv2; the video is split into segments of `max_video_frames`."""
  import cv2

  rng = np.random.RandomState(10)
  t, h, w, n = 6, 32, 40, 3
  writer = cv2.VideoWriter(str(tmp_path / "clip.mp4"),
                           cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
  for frame in _video(rng, t, h, w):
    writer.write(frame)
  writer.release()
  rows = [["clip"] + [f"{v:.4f}" for v in np.stack(
      [rng.rand(t), rng.rand(t), rng.rand(t) > 0.7], -1).ravel()]
          for _ in range(n)]
  with open(tmp_path / "points.csv", "w") as f:
    f.write("\n".join(",".join(r) for r in rows) + "\n")
  out = _same_reader("create_csv_dataset", "robotap", str(tmp_path / "points.csv"),
                     str(tmp_path), "first", (16, 16), max_video_frames=4)
  assert len(out) == 2 and out[0]["robotap"]["video"].shape[1] == 3
  assert datasets.read_video_file(str(tmp_path / "clip.mp4")).shape == (t, h, w, 3)


def test_jhmdb_reader_equals_jax(tmp_path):
  """A JHMDB tree: a split file, a joint_positions.mat and PNG frames (one
  joint outside the first frame, marked invalid)."""
  import scipy.io as sio
  from PIL import Image

  rng = np.random.RandomState(11)
  t, h, w = 4, 24, 32
  (tmp_path / "splits").mkdir()
  (tmp_path / "splits" / "wave_test_split1.txt").write_text(
      "clipA.avi 2\nclipB.avi 1\n")
  joints = tmp_path / "joint_positions" / "wave" / "clipA"
  joints.mkdir(parents=True)
  pos = rng.rand(2, 15, t) * np.array([w, h])[:, None, None]
  pos[0, 3, 0] = w + 5.0
  sio.savemat(joints / "joint_positions.mat", {"pos_img": pos})
  frames = tmp_path / "Rename_Images" / "wave" / "clipA"
  frames.mkdir(parents=True)
  for i, f in enumerate(_video(rng, t, h, w)):
    Image.fromarray(f).save(frames / f"{i:05d}.png")
  out = _same_reader("create_jhmdb_dataset", str(tmp_path), (16, 16))
  assert out[0]["jhmdb"]["gt_pose"][0, 3, 0, 0] == -1.0


# ------------------------------------------------------------- eval draws


def test_committed_draws_render_jax_export(tmp_path):
  """Video 0 of the held-out set a, rendered by the port from the committed
  draws, against JAX's `export_npz`: the occlusion equal, the points within
  1e-6 relative (`render_batch`'s own limit against `make_batch`: XLA may
  contract a track's multiply-add into one rounding, so a point can sit a
  float32 step or two apart, 3e-5 px at 128-256 px), and at most 1e-4 of
  the uint8 pixels one level apart: the video agrees within 1e-6 before the
  truncating uint8 conversion, which moves a value sitting on a level."""
  spec = dict(synthetic.HELD_OUT_SETS["a"], num_examples=1)
  jax_synthetic.export_npz(str(tmp_path / "jax"), **spec)
  draws = {k: v[:1] for k, v in synthetic.load_draws(make_eval_draws.DRAWS,
                                                     "a").items()}
  # The committed draws are the tool's (JAX's keys, split as export_npz).
  _assert_same(make_eval_draws.jax_draws(**spec), draws)
  synthetic.export_npz(str(tmp_path / "port"), draws=draws, **spec)
  ref = np.load(tmp_path / "jax" / "synth_0000.npz")
  got = np.load(tmp_path / "port" / "synth_0000.npz")
  assert got["video"].dtype == np.uint8 and got["video"].shape == (24, 256, 256, 3)
  diff = np.abs(got["video"].astype(np.int16) - ref["video"])
  assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
  np.testing.assert_allclose(got["target_points"], ref["target_points"],
                             rtol=1e-6, atol=0)
  assert got["occluded"].dtype == bool
  np.testing.assert_array_equal(got["occluded"], ref["occluded"])
  # The port's own generator writes the same layout.
  synthetic.export_npz(str(tmp_path / "own"), 1, num_frames=3, height=32,
                       width=32, num_queries=4)
  own = np.load(tmp_path / "own" / "synth_0000.npz")
  assert own["video"].shape == (3, 32, 32, 3) and own["occluded"].shape == (4, 3)


def test_held_out_records_cover_every_video():
  """The committed draws hold every video of each held-out set, and JAX's
  metrics hold every scored run complete, on the sets as the port defines
  them: chip_smoke.py compares the card with JAX on all the videos."""
  with open(make_eval_draws.METRICS) as f:
    doc = json.load(f)
  assert doc["sets"] == synthetic.HELD_OUT_SETS
  assert doc["query_mode"] == synthetic.HELD_OUT_QUERY_MODE
  assert doc["predictor"] == (f"TapirPredictor(query_chunk_size="
                              f"{synthetic.HELD_OUT_QUERY_CHUNK_SIZE})")
  runs = {f"{s}:{p}" for s, ps in make_eval_draws.PRECISIONS.items()
          for p in ps}
  assert set(doc["runs"]) == runs
  for name, spec in synthetic.HELD_OUT_SETS.items():
    n = spec["num_examples"]
    draws = synthetic.load_draws(make_eval_draws.DRAWS, name)
    assert {len(v) for v in draws.values()} == {n}
    assert draws["t_query"].shape == (n, spec["num_queries"])
    for key in (k for k in runs if k.startswith(f"{name}:")):
      run = doc["runs"][key]
      assert run["complete"] and run["videos"] == len(run["per_video"]) == n
      for k, v in run["mean"].items():
        assert v == pytest.approx(
            np.mean([m[k] for m in run["per_video"]]), rel=1e-12), (key, k)


# ---------------------------------------------------------- TAPNext import

_SMALL = dict(width=16, depth=2, mlp_dim=32, num_heads=2, patch_size=(1, 8, 8),
              image_size=(32, 32))


def _reference_state_dict(flat, num_heads):
  """The reference torch TAPNext layout of a released flat tree (the
  reference's JAX -> torch mapping), as torch tensors."""
  sd = {"lin_proj.weight": flat["backbone/embedding/kernel"][0].transpose(3, 2, 0, 1),
        "lin_proj.bias": flat["backbone/embedding/bias"],
        "mask_token": flat["backbone/mask_token"],
        "point_query_token": flat["backbone/point_query_token"],
        "unknown_token": flat["backbone/unknown_token"],
        "image_pos_emb": flat["backbone/pos_embedding"],
        "encoder_norm.weight": flat["backbone/Transformer/encoder_norm/scale"],
        "encoder_norm.bias": flat["backbone/Transformer/encoder_norm/bias"]}
  layer = 0
  while f"backbone/Transformer/encoderblock_{layer}/vit_block/LayerNorm_0/scale" in flat:
    pre = f"backbone/Transformer/encoderblock_{layer}"
    for k, v in flat.items():
      if k.startswith(f"{pre}/ssm_block/"):
        suffix = k[len(f"{pre}/ssm_block/"):]
        name = suffix.replace("/", ".").replace("kernel", "weight")
        sd[f"blocks.{layer}.ssm_block.{name}"] = v.T if "kernel" in suffix else v
    vj, vp = f"{pre}/vit_block", f"blocks.{layer}.vit_block."
    for i, ln in ((0, "ln_1"), (1, "ln_2")):
      sd[vp + ln + ".weight"] = flat[f"{vj}/LayerNorm_{i}/scale"]
      sd[vp + ln + ".bias"] = flat[f"{vj}/LayerNorm_{i}/bias"]
    for i, idx in ((0, 0), (1, 3)):
      sd[f"{vp}mlp.{idx}.weight"] = flat[f"{vj}/MlpBlock_0/Dense_{i}/kernel"].T
      sd[f"{vp}mlp.{idx}.bias"] = flat[f"{vj}/MlpBlock_0/Dense_{i}/bias"]
    attn = f"{vj}/MultiHeadDotProductAttention_0"
    embed = flat[f"{attn}/out/bias"].shape[0]
    sd[vp + "self_attention.in_proj_weight"] = np.concatenate(
        [flat[f"{attn}/{n}/kernel"].reshape(embed, embed).T
         for n in ("query", "key", "value")])
    sd[vp + "self_attention.in_proj_bias"] = np.concatenate(
        [flat[f"{attn}/{n}/bias"].reshape(embed) for n in ("query", "key", "value")])
    sd[vp + "self_attention.out_proj.weight"] = flat[f"{attn}/out/kernel"].reshape(
        embed, embed).T
    sd[vp + "self_attention.out_proj.bias"] = flat[f"{attn}/out/bias"]
    layer += 1
  for head in ("visible_head", "coordinate_head"):
    for idx in (0, 3, 6):
      sd[f"{head}.{idx}.weight"] = flat[f"{head}/layers_{idx}/kernel"].T
      sd[f"{head}.{idx}.bias"] = flat[f"{head}/layers_{idx}/bias"]
    for idx in (1, 4):
      sd[f"{head}.{idx}.weight"] = flat[f"{head}/layers_{idx}/scale"]
      sd[f"{head}.{idx}.bias"] = flat[f"{head}/layers_{idx}/bias"]
  return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def test_tapnext_torch_import_equals_jax(tmp_path):
  """A reference-layout state dict made from seed-made weights: the port's
  flat tree equals JAX's bit for bit and gives back every weight it maps;
  a wrapped .pt file loads to JAX's tree and into the port's model."""
  config = ssm_vit.SsmVitConfig(**_SMALL)
  flat = tapnext_checkpoint.flatten(seeded_tapnext_params(config, 3))
  sd = _reference_state_dict(flat, config.num_heads)
  ours = tapnext_torch_import.state_dict_to_flat_jax(sd, config.num_heads)
  _assert_same(ours, jax_import.state_dict_to_flat_jax(sd, config.num_heads))
  assert set(flat) - set(ours) == {"backbone/pos_embedding_full"}
  for k, v in ours.items():
    np.testing.assert_array_equal(v, flat[k], err_msg=k)
  path = str(tmp_path / "tapnext.pt")
  torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
  tree = tapnext_torch_import.load_tapnext_torch_checkpoint(
      path, num_heads=config.num_heads)
  _assert_same(tree, jax_import.load_tapnext_torch_checkpoint(
      path, num_heads=config.num_heads))
  tree["backbone"]["pos_embedding_full"] = flat["backbone/pos_embedding_full"]
  model = tapnext.TAPNextTracker(config)
  convert.load_tapnext_params(model, tree)
  np.testing.assert_array_equal(
      model.state_dict()["visible_head.layers_0.weight"].numpy(),
      flat["visible_head/layers_0/kernel"].T)

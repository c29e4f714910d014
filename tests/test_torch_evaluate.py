"""PyTorch port, the evaluation harness end to end against the JAX package:
`evaluate_dataset` over two 4-frame Kubric-format videos with a narrow
seed-made BootsTAPIR (JAX's predictor and the port's `device="cpu"` one),
the evaluate CLI, `make_eval_fn` on the port's own modules, and in-train
evaluation through `training.run --eval_dir`.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu import inference as jax_inference
from tapnet_tpu.models import tapir as jax_tapir
from tapnet_tpu.tapvid import evaluate as jax_evaluate
from tapnet_tpu_torch import configs
from tapnet_tpu_torch.checkpoints.convert import load_flax_params
from tapnet_tpu_torch.data import synthetic
from tapnet_tpu_torch.inference import TapirPredictor
from tapnet_tpu_torch.models import ssm_vit, tapir
from tapnet_tpu_torch.tapvid import datasets, evaluate
from tapnet_tpu_torch.training import run

SMALL = dict(
    blocks_per_group=(1, 1, 1, 1), highres_dim=16, lowres_dim=32,
    mixer_hidden_dim=32, num_mixer_blocks=1, initial_resolution=(64, 64),
    num_pips_iter=1,
)
T, H, W, Q = 4, 64, 64, 12
# fp32 on both sides: the tracks agree within 1e-3 px and the logits within
# 1e-4 (tests/test_torch_tapir.py), so a metric moves only where a
# point-frame sits within that of a threshold, and one point-frame of the
# two videos moves a metric by more than 1e-3.
METRIC_TOL = 1e-3


def _seeded_params(shapes, rng):
  """Numpy weights in the layout of Flax's `init` (traced, not compiled):
  fan-in scaled normal kernels, scales near one, small biases."""
  def make(path, leaf):
    name = path[-1].key
    if name in ("kernel", "w"):
      fan_in = int(np.prod(leaf.shape[:-1]))
      return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
    base = 1.0 if name == "scale" else 0.0
    return (base + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
  return jax.tree_util.tree_map_with_path(make, shapes)


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
  """Two 4-frame 64x64 videos written by the port's `export_npz`, and
  narrow seed-made BootsTAPIR weights."""
  data_dir = str(tmp_path_factory.mktemp("kubric"))
  synthetic.export_npz(data_dir, 2, seed=3, num_frames=T, height=H, width=W,
                       num_queries=Q)
  model = jax_tapir.TAPIR(config=jax_tapir.bootstapir_config(**SMALL))
  shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 2, H, W, 3)), jnp.zeros((1, 2, 3)))
  return data_dir, _seeded_params(shapes["params"], np.random.RandomState(1))


def test_evaluate_dataset_matches_jax(eval_setup):
  data_dir, params = eval_setup
  ours = evaluate.evaluate_dataset(
      TapirPredictor(params, tapir.bootstapir_config(**SMALL),
                     query_chunk_size=16, device="cpu"),
      datasets.create_kubric_dataset(data_dir, "strided", (H, W)), "strided",
      verbose=False)
  theirs = jax_evaluate.evaluate_dataset(
      jax_inference.TapirPredictor(params, jax_tapir.bootstapir_config(**SMALL),
                                   query_chunk_size=16),
      datasets.create_kubric_dataset(data_dir, "strided", (H, W)), "strided",
      verbose=False)
  assert set(ours) == set(theirs) and len(ours) == 13
  for k, v in theirs.items():
    assert abs(ours[k] - v) <= METRIC_TOL, (k, ours[k], v)
  # The weights are random: the comparison rests on the occlusion accuracy
  # and the position scores, which are neither 0 nor 1.
  for k in ("occlusion_accuracy", "average_pts_within_thresh"):
    assert 0.0 < ours[k] < 1.0, (k, ours[k])


def test_evaluate_cli_on_cpu(eval_setup, tmp_path, monkeypatch, capsys):
  """`python -m tapnet_tpu_torch.tapvid.evaluate --device cpu` with the
  precision flags, on a checkpoint file: the weights load into the
  predictor, the flags reach its configuration, and the metrics of its
  outputs are printed and written (the predictor's outputs are stand-ins
  here: test_evaluate_dataset_matches_jax runs the model), and
  --visualization_dir writes a painted video. The narrow weights stand in
  for the preset's widths (monkeypatched)."""
  from tapnet_tpu_torch import inference

  data_dir, params = eval_setup
  ckpt = str(tmp_path / "ckpt.npy")
  np.save(ckpt, {"params": params}, allow_pickle=True)
  preset = tapir.bootstapir_config
  monkeypatch.setattr(tapir, "bootstapir_config", lambda: preset(**SMALL))
  built = []
  real = inference.TapirPredictor

  def predictor(params, config, **kwargs):
    built.append((config, kwargs))
    real(params, config, **kwargs)  # the weights load
    return lambda video, qp: dict(
        tracks=np.zeros(qp.shape[:2] + video.shape[1:2] + (2,), np.float32),
        occlusion=np.zeros(qp.shape[:2] + video.shape[1:2], np.float32),
        expected_dist=np.zeros(qp.shape[:2] + video.shape[1:2], np.float32))

  monkeypatch.setattr(inference, "TapirPredictor", predictor)
  base = ["--checkpoint", ckpt, "--model", "bootstapir", "--dataset",
          "kubric", "--data_path", data_dir, "--query_mode", "strided",
          "--query_chunk_size", "16", "--device", "cpu"]
  out_json = str(tmp_path / "out.json")
  int8 = evaluate.main(base + ["--max_videos", "1", "--output_json", out_json,
                               "--quantized_mixer", "--quantized_corr",
                               "per_frame", "--quantized_extra_convs", "true",
                               "--num_pips_iter", "2", "--bfloat16"])
  assert json.load(open(out_json)) == pytest.approx(int8) and len(int8) == 13
  assert "AJ & " in capsys.readouterr().out
  (config, kwargs), = built
  assert (config.quantized_mixer, config.quantized_corr,
          config.quantized_extra_convs, config.num_pips_iter) == (
              True, "per_frame", True, 2)
  assert kwargs == dict(query_chunk_size=16, bfloat16=True, device="cpu")
  # --visualization_dir writes one painted mp4 per video.
  viz_dir = tmp_path / "viz"
  evaluate.main(base + ["--max_videos", "1", "--visualization_dir",
                        str(viz_dir)])
  assert sorted(os.listdir(viz_dir)) == ["video_0000.mp4"]
  assert os.path.getsize(viz_dir / "video_0000.mp4") > 0
  with pytest.raises(SystemExit):
    evaluate.main(["--checkpoint", "x.pt", "--model", "tapnext", "--dataset",
                   "kubric", "--data_path", data_dir, "--bfloat16"])


def test_make_eval_fn_runs_the_module_in_eval_mode(tmp_path):
  """`make_eval_fn` on the port's own module (a small TAPNext): its current
  weights (updated in place between calls), eval() under no_grad, the mode
  put back."""
  from tapnet_tpu_torch.models import tapnext

  synthetic.export_npz(str(tmp_path), 1, seed=5, num_frames=4, height=32,
                       width=32, num_queries=3)
  torch.manual_seed(0)
  model = tapnext.TAPNextTracker(ssm_vit.SsmVitConfig(
      width=32, depth=1, mlp_dim=64, num_heads=2, image_size=(32, 32)))
  model.train()
  seen = []  # (training, grad enabled, the first weight's sum) a forward
  model.register_forward_pre_hook(lambda m, args: seen.append(
      (m.training, torch.is_grad_enabled(), float(next(m.parameters()).sum()))))
  eval_fn = evaluate.make_eval_fn(
      model, lambda: datasets.create_kubric_dataset(str(tmp_path), "strided",
                                                    (32, 32)))
  assert len(eval_fn(None)) == 13
  assert model.training and seen and all(s[:2] == (False, False) for s in seen)
  with torch.no_grad():
    next(model.parameters()).add_(1.0)
  eval_fn(None)
  assert seen[-1][2] != seen[0][2]  # the forward read the updated weights


def test_run_cli_evaluates_in_training(tmp_path, monkeypatch, capsys):
  """`training.run --eval_dir` on two exported videos at the train-golden
  size (TAPNext width 32, 32x32, 4 frames), one step: the eval scalars go to
  the run's JSONL with kind "eval", as JAX's in-train eval logs them."""
  eval_dir = str(tmp_path / "eval")
  synthetic.export_npz(eval_dir, 2, seed=4, num_frames=4, height=32, width=32,
                       num_queries=3)
  preset = configs.REGISTRY["tapnext"]

  def tiny(**overrides):
    exp = preset(**overrides)
    return dataclasses.replace(
        exp, model_config=ssm_vit.SsmVitConfig(
            width=32, depth=2, mlp_dim=64, num_heads=2, image_size=(32, 32)),
        data=dataclasses.replace(exp.data, train_size=(32, 32)))

  monkeypatch.setitem(configs.REGISTRY, "tapnext", tiny)
  state = run.main(["--experiment", "tapnext", "--synthetic", "--num_steps",
                    "1", "--batch_size", "1", "--num_frames", "4",
                    "--num_queries", "3", "--log_every", "1", "--device",
                    "cpu", "--checkpoint_dir", str(tmp_path), "--eval_dir",
                    eval_dir, "--eval_every", "1", "--eval_max_videos", "2"])
  assert state.step == 1
  assert "eval @1 " in capsys.readouterr().out
  records = [json.loads(line) for line in open(tmp_path / "train_log.jsonl")]
  evals = [r for r in records if r["kind"] == "eval"]
  assert len(evals) == 1 and evals[0]["step"] == 1
  assert 0.0 <= evals[0]["average_jaccard"] <= 1.0
  assert os.path.exists(tmp_path / "checkpoint.npy")

"""TAP-Vid evaluation harness and CLI of the port (the counterpart of
tapnet_tpu/tapvid/evaluate.py).

Runs a tracker over a TAP-Vid dataset and reports AJ / <delta^x_avg / OA
(reference protocol: tapnet/training/supervised_point_prediction.py:553-658;
predictions at 256x256, metrics at 256x256). The trackers run on the CUDA
card unless `--device cpu` is given; the metrics are numpy on the host.

CLI:
  python -m tapnet_tpu_torch.tapvid.evaluate --checkpoint tapir.npy \
      --dataset davis --data_path /path/tapvid_davis.pkl --query_mode first
  python -m tapnet_tpu_torch.tapvid.evaluate --model bootstapir \
      --checkpoint runs/bootstapir_synth/trained_params_f16.npy \
      --dataset kubric --data_path DIR --query_mode strided \
      [--bfloat16] [--quantized_mixer] [--quantized_corr per_frame] \
      [--quantized_extra_convs true] [--num_pips_iter 2] [--device cpu] \
      [--visualization_dir DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch

from tapnet_tpu_torch.tapvid import datasets as tapvid_datasets
from tapnet_tpu_torch.tapvid import metrics as tapvid_metrics


def evaluate_dataset(
    predict_fn: Callable[[np.ndarray, np.ndarray], Mapping[str, np.ndarray]],
    dataset: Iterable,
    query_mode: str,
    max_videos: Optional[int] = None,
    verbose: bool = True,
    visualization_dir: Optional[str] = None,
) -> Mapping[str, float]:
  """Evaluates `predict_fn` over a reader generator.

  Args:
    predict_fn: (video [1,T,H,W,3] in [-1,1], query_points [1,Q,3]) ->
      {"tracks" [1,Q,T,2], "occlusion", "expected_dist" logits} as numpy
      arrays (a predictor of `tapnet_tpu_torch.inference`).
    dataset: generator of {name: example} dicts from tapvid datasets.
    query_mode: "first" or "strided".
    max_videos: optional cap for smoke runs.
    visualization_dir: if set, writes one painted-track mp4 per video
      there (`video_{i:04d}.mp4`: predictions as dots, ground truth as
      diamonds, `utils.viz.write_visualization`; cv2 and matplotlib are
      imported then). The plots' colours are drawn from
      `np.random.default_rng(i)`.

  Returns:
    mean metrics over videos (floats in [0, 1]).
  """
  sums: dict = {}
  count = 0
  for i, element in enumerate(dataset):
    if max_videos is not None and i >= max_videos:
      break
    (example,) = element.values()
    video = example["video"]
    query_points = example["query_points"]

    t0 = time.time()
    out = predict_fn(video, query_points)
    dt = time.time() - t0

    pred_occluded = _occluded_from_logits(out["occlusion"],
                                          out.get("expected_dist"))

    # Metrics are computed at 256x256 scale per benchmark convention.
    h, w = video.shape[2:4]
    scale = np.array([256.0 / w, 256.0 / h])
    video_metrics = tapvid_metrics.compute_tapvid_metrics(
        example["query_points"],
        example["occluded"],
        example["target_points"] * scale,
        pred_occluded,
        out["tracks"] * scale,
        query_mode=query_mode,
    )
    count += 1
    if visualization_dir:
      from tapnet_tpu_torch.utils import viz

      os.makedirs(visualization_dir, exist_ok=True)
      video_u8 = ((video + 1.0) * 127.5).astype(np.uint8)
      viz.write_visualization(
          video_u8,
          out["tracks"],
          pred_occluded,
          [os.path.join(visualization_dir, f"video_{i:04d}.mp4")],
          gt_points=example["target_points"],
          gt_occluded=example["occluded"],
          rng=np.random.default_rng(i),
      )
    for k, v in video_metrics.items():
      sums[k] = sums.get(k, 0.0) + float(np.mean(v))
    if verbose:
      running_aj = sums["average_jaccard"] / count
      print(
          f"[{count}] frames={video.shape[1]} queries="
          f"{query_points.shape[1]} aj={float(np.mean(video_metrics['average_jaccard'])):.4f}"
          f" running_aj={running_aj:.4f} ({dt:.2f}s)"
      )

  if count == 0:
    raise ValueError("Dataset produced no videos.")
  return {k: v / count for k, v in sums.items()}


def _occluded_from_logits(occ_logits, expd_logits):
  """Combine occlusion + uncertainty logits (reference:
  supervised_point_prediction.py:620-624)."""

  def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))

  pred_visible = sigmoid(occ_logits) <= 0.5
  if expd_logits is not None:
    pred_visible = pred_visible & (
        (1.0 - sigmoid(occ_logits)) * (1.0 - sigmoid(expd_logits)) > 0.5
    )
  return ~pred_visible


DATASET_BUILDERS = {
    "davis": lambda path, mode: tapvid_datasets.create_davis_dataset(
        path, query_mode=mode
    ),
    "robotics": lambda path, mode: tapvid_datasets.create_rgb_stacking_dataset(
        path, query_mode=mode
    ),
    "kinetics": lambda path, mode: tapvid_datasets.create_kinetics_dataset(
        path, query_mode=mode
    ),
    # Held-out synthetic data in the training format (the reference's
    # eval_kubric mode, supervised_point_prediction.py:686-693); data_path
    # is a directory of Kubric npz files.
    "kubric": lambda path, mode: tapvid_datasets.create_kubric_dataset(
        path, query_mode=mode
    ),
}


def make_eval_fn(
    model: torch.nn.Module,
    dataset_builder: Callable[[], Iterable],
    query_mode: str = "strided",
    query_chunk_size: int = 16,
    max_videos: Optional[int] = None,
):
  """Builds a `Trainer.fit(eval_fn=...)` hook from any dataset reader.

  The reference runs in-train eval epochs over kubric/davis readers
  (experiment.py:193-197 -> supervised_point_prediction.py:660-733). Here
  `eval_fn(state)` runs `model` (the trainer's own module: a TAPNextTracker
  or a TAPIR) with its current weights, on its device, in `eval()` mode
  under `torch.no_grad()`, over `dataset_builder()`, and returns mean
  TAP-Vid metrics for the telemetry sink; the module's mode is restored
  afterwards. The predictor wraps the module itself (no copy, no round trip
  through the Flax layout), so `state` is not read: the trainer updates the
  module's parameters in place.

  Example (the reference's eval_kubric mode):
    eval_fn = make_eval_fn(
        trainer.model,
        lambda: tapvid_datasets.create_kubric_dataset(val_dir, "strided"),
    )
    trainer.fit(state, data, steps, eval_fn=eval_fn, evaluate_every=1000)
  """
  from tapnet_tpu_torch import inference
  from tapnet_tpu_torch.models import tapnext

  # Cost-volume trackers go through TapirPredictor, the ViT-SSM tracker
  # through TapnextPredictor.
  if isinstance(model, tapnext.TAPNextTracker):
    predictor = inference.TapnextPredictor.from_model(model)
  else:
    predictor = inference.TapirPredictor.from_model(
        model, query_chunk_size=query_chunk_size)

  def eval_fn(state) -> Mapping[str, float]:
    del state  # the module's own parameters are the state's
    was_training = model.training
    model.eval()
    try:
      with torch.no_grad():
        return dict(evaluate_dataset(predictor, dataset_builder(), query_mode,
                                     max_videos=max_videos, verbose=False))
    finally:
      model.train(was_training)

  return eval_fn


def _config_value(text: str):
  """A TapirConfig quantization value from the command line."""
  return {"true": True, "false": False}.get(text.lower(), text)


def main(argv=None):
  parser = argparse.ArgumentParser(description="TAP-Vid evaluation")
  parser.add_argument("--checkpoint", required=True)
  parser.add_argument(
      "--dataset", choices=sorted(DATASET_BUILDERS) + ["robotap",
                                                       "perception_test"],
      required=True,
  )
  parser.add_argument("--data_path", required=True)
  parser.add_argument("--video_base_path", default=None,
                      help="for CSV datasets")
  parser.add_argument("--query_mode", choices=["first", "strided"],
                      default="first")
  parser.add_argument("--max_videos", type=int, default=None)
  parser.add_argument(
      "--model",
      choices=[
          "tapir",
          "causal_tapir",
          "bootstapir",
          "causal_bootstapir",
          "tapnext",
      ],
      default="tapir",
  )
  parser.add_argument("--query_chunk_size", type=int, default=64)
  parser.add_argument("--output_json", default=None)
  parser.add_argument(
      "--visualization_dir", default=None,
      help="write one painted-track mp4 per video here",
  )
  parser.add_argument("--device", default=None,
                      help="torch device; default the CUDA card")
  # The served precisions of TAPIR (TapirPredictor's bfloat16 and the int8
  # fields of TapirConfig).
  parser.add_argument("--bfloat16", action="store_true")
  parser.add_argument("--quantized_mixer", action="store_true")
  parser.add_argument("--quantized_corr", type=_config_value,
                      choices=[True, "per_frame"], default=False,
                      help="true (per position) or per_frame")
  parser.add_argument("--quantized_extra_convs", type=_config_value,
                      choices=[True, "per_pixel"], default=False,
                      help="true (per frame) or per_pixel")
  parser.add_argument("--num_pips_iter", type=int, default=None)
  args = parser.parse_args(argv)
  if args.model == "tapnext" and (
      args.bfloat16 or args.quantized_mixer or args.quantized_corr
      or args.quantized_extra_convs or args.num_pips_iter is not None):
    parser.error("the precision flags are TAPIR's")

  from tapnet_tpu_torch import inference

  if args.model == "tapnext":
    if args.checkpoint.endswith((".pt", ".ckpt", ".pth")):
      # TAPNext++ weights are released as torch state dicts only.
      from tapnet_tpu_torch.checkpoints import tapnext_torch_import

      params = tapnext_torch_import.load_tapnext_torch_checkpoint(
          args.checkpoint
      )
    else:
      from tapnet_tpu_torch.checkpoints import tapnext_checkpoint

      params = tapnext_checkpoint.load_tapnext_checkpoint(args.checkpoint)
    predictor = inference.TapnextPredictor(params, device=args.device)
  else:
    from tapnet_tpu_torch.checkpoints import tapir_checkpoint
    from tapnet_tpu_torch.models import tapir as tapir_lib

    overrides = dict(quantized_mixer=args.quantized_mixer,
                     quantized_corr=args.quantized_corr,
                     quantized_extra_convs=args.quantized_extra_convs)
    if args.num_pips_iter is not None:
      overrides["num_pips_iter"] = args.num_pips_iter
    config = dataclasses.replace(
        getattr(tapir_lib, f"{args.model}_config")(), **overrides)
    params = tapir_checkpoint.load_tapir_checkpoint(args.checkpoint)
    predictor = inference.TapirPredictor(
        params, config, query_chunk_size=args.query_chunk_size,
        bfloat16=args.bfloat16, device=args.device,
    )

  if args.dataset in DATASET_BUILDERS:
    ds = DATASET_BUILDERS[args.dataset](args.data_path, args.query_mode)
  else:
    ds = tapvid_datasets.create_csv_dataset(
        args.dataset, args.data_path, args.video_base_path, args.query_mode
    )

  results = evaluate_dataset(
      predictor,
      ds,
      args.query_mode,
      max_videos=args.max_videos,
      visualization_dir=args.visualization_dir,
  )
  print(tapvid_metrics.latex_table(results))
  print(json.dumps(results, indent=2))
  if args.output_json:
    with open(args.output_json, "w") as f:
      json.dump(results, f, indent=2)
  return results


if __name__ == "__main__":
  main()

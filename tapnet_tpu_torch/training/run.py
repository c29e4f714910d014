"""Training CLI of the port (the counterpart of tapnet_tpu/training/run.py):

  python -m tapnet_tpu_torch.training.run \
      --experiment tapir|tapnet|causal_tapir|bootstapir|tapnext|tapnextpp \
      (--synthetic | --data_dir DIR) [--num_steps N] [--checkpoint_dir D] \
      [--total_steps S] [--batch_size B] [--num_frames T] [--num_queries Q] \
      [--seed 0] [--log_every 50] [--smoke] [--device cpu] \
      [--model_parallel M] [--eval_dir DIR [--eval_every N] \
      [--eval_max_videos V]]

Multi-GPU: run it under torchrun, which starts one process a rank,

  torchrun --nproc_per_node N -m tapnet_tpu_torch.training.run ... \
      [--model_parallel M]

and the CLI builds a (data N/M, model M) mesh over the ranks
(`parallel/mesh.py`; the backend is NCCL when every rank has a card, else
gloo). Every rank makes the same global batches from `--seed` and takes its
part; rank r trains on cuda:{r % cards}, and rank 0 alone logs and
checkpoints. Without torchrun, `--model_parallel` above 1 raises.

Trains on the synthetic sprite generator, batches made on the device, or
with `--data_dir` on Kubric-format npz examples (`data/kubric.py`: a host
reader thread, resize, query sampling and the experiment's colour and
geometric augmentation on the device; `data/kubric_convert.py` writes such
files). It runs on the CUDA card and raises without one unless given
`--device cpu`; the kernels build from the repo's sources at their first
launch.
`--smoke` shrinks a TAPIR-family model and its data for a quick run, as the
JAX CLI's does (2 mixer blocks, 2 refinement steps, 32x32, ResNet blocks
(1, 1, 1, 1); 2 clips of 3 frames, 8 queries in chunks of 4); for TAP-Net
it shrinks the data and the chunks alike (the model keeps its
TSM-ResNet-18).
`--eval_dir` (a directory of Kubric-format npz videos, e.g. from
`data.synthetic.export_npz`) evaluates the model on it every `--eval_every`
steps (default: the preset's `evaluate_every`) and logs the TAP-Vid metrics
to the same JSONL with kind "eval".
"""

from __future__ import annotations

import argparse
import os


def make_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description="tapnet_tpu_torch training")
  parser.add_argument("--experiment", default="tapir",
                      help="registry name: tapir / tapnet / causal_tapir / "
                      "bootstapir / tapnext / tapnextpp")
  parser.add_argument("--data_dir", default=None,
                      help="Kubric-format npz examples to train on")
  parser.add_argument("--synthetic", action="store_true",
                      help="train on the synthetic sprite generator")
  parser.add_argument("--num_steps", type=int, default=None,
                      help="steps to run in THIS invocation")
  parser.add_argument(
      "--total_steps", type=int, default=None,
      help="schedule horizon; defaults to --num_steps. Keep it fixed "
      "across resumed invocations: the schedule is indexed by the absolute "
      "step.")
  parser.add_argument("--checkpoint_dir", default=None)
  parser.add_argument("--checkpoint_every", type=int, default=1000)
  parser.add_argument("--log_every", type=int, default=50)
  parser.add_argument("--batch_size", type=int, default=None)
  parser.add_argument("--model_parallel", type=int, default=1,
                      help="ranks along the mesh's query axis (under "
                      "torchrun)")
  parser.add_argument("--eval_dir", default=None,
                      help="Kubric-format npz videos for in-train eval")
  parser.add_argument("--eval_every", type=int, default=None,
                      help="steps between in-train evals "
                      "(default: the preset's evaluate_every)")
  parser.add_argument("--eval_max_videos", type=int, default=None)
  parser.add_argument("--num_frames", type=int, default=None)
  parser.add_argument("--num_queries", type=int, default=None)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--device", default=None,
                      help="torch device; default the CUDA card")
  parser.add_argument("--smoke", action="store_true",
                      help="shrink model and data for a quick correctness "
                      "run (tapir-family and tapnet experiments)")
  return parser


def make_data(args, exp, device):
  """The training batches: the synthetic generator with `--synthetic` (or
  without `--data_dir`), else the Kubric reader over `--data_dir`, as the
  JAX CLI chooses (run.py:95-116 there)."""
  batch_size = args.batch_size or exp.data.batch_size
  num_frames = args.num_frames or exp.data.num_frames
  num_queries = args.num_queries or exp.data.num_queries
  if args.synthetic or args.data_dir is None:
    from tapnet_tpu_torch.data import synthetic

    if args.data_dir is None and not args.synthetic:
      print("no --data_dir given; training on synthetic data")
    return synthetic.batch_iterator(
        seed=args.seed, device=device, batch_size=batch_size,
        num_frames=num_frames, height=exp.data.train_size[0],
        width=exp.data.train_size[1], num_queries=num_queries)
  from tapnet_tpu_torch.data import kubric

  return kubric.training_iterator(
      args.data_dir, batch_size, train_size=exp.data.train_size,
      num_queries=num_queries, color_augment=exp.data.color_augment,
      geometric_augment=exp.data.geometric_augment, seed=args.seed,
      device=device)


def main(argv=None):
  args = make_parser().parse_args(argv)

  from tapnet_tpu_torch import configs
  from tapnet_tpu_torch.inference import resolve_device
  from tapnet_tpu_torch.training import trainer as trainer_lib

  mesh = make_mesh(args)
  device = resolve_device(args.device) if mesh is None else mesh.device(
      args.device)
  exp = configs.get_experiment(args.experiment)
  if args.smoke:
    exp = smoke(exp)
  num_steps = args.num_steps or exp.total_steps
  data = make_data(args, exp, device)
  ckpt_path = (os.path.join(args.checkpoint_dir, "checkpoint.npy")
               if args.checkpoint_dir else None)
  t = trainer_lib.Trainer(
      exp.build_model(), exp.optimizer, total_steps=args.total_steps or num_steps,
      task=exp.task, checkpoint_path=ckpt_path,
      checkpoint_every=args.checkpoint_every, loss_builder=exp.loss_builder,
      device=device, mesh=mesh)
  eval_fn = None
  eval_every = args.eval_every or exp.evaluate_every
  if args.eval_dir:
    from tapnet_tpu_torch.tapvid import datasets as tapvid_datasets
    from tapnet_tpu_torch.tapvid import evaluate as tapvid_evaluate

    eval_fn = tapvid_evaluate.make_eval_fn(
        t.model,
        lambda: tapvid_datasets.create_kubric_dataset(
            args.eval_dir, query_mode="strided",
            train_size=exp.data.train_size),
        query_mode="strided",
        query_chunk_size=exp.task.train_chunk_size,
        max_videos=args.eval_max_videos,
    )
  state = t.restore_or_init()
  state = t.fit(state, data, num_steps=num_steps, log_every=args.log_every,
                eval_fn=eval_fn, evaluate_every=eval_every if eval_fn else 0)
  if ckpt_path:
    t.save(state)
  if t.is_chief:
    print(f"finished at step {state.step}")
  return state


def make_mesh(args):
  """The mesh of a multi-rank run (torchrun's process group, joined here,
  or one the caller joined), else None."""
  import torch.distributed as dist

  from tapnet_tpu_torch.parallel import launch
  from tapnet_tpu_torch.parallel import mesh as mesh_lib

  launch.init_from_env(device=args.device)
  if not dist.is_initialized():
    if args.model_parallel != 1:
      raise ValueError(
          f"--model_parallel {args.model_parallel} needs a multiple of "
          f"{args.model_parallel} ranks: launch with torchrun "
          f"--nproc_per_node N -m tapnet_tpu_torch.training.run ... "
          f"--model_parallel {args.model_parallel}")
    return None
  return mesh_lib.make_mesh(args.model_parallel)


def smoke(exp):
  """The JAX CLI's `--smoke` shrink of a TAPIR-family experiment; of
  TAP-Net's, the same data and chunks."""
  import dataclasses

  from tapnet_tpu_torch.training import trainer as trainer_lib

  if exp.model_kind not in ("tapir", "tapnet"):
    raise ValueError(
        "--smoke currently supports tapir-family and tapnet experiments")
  model_config = exp.model_config
  if exp.model_kind == "tapir":
    model_config = dataclasses.replace(
        model_config, num_mixer_blocks=2, num_pips_iter=2,
        initial_resolution=(32, 32), blocks_per_group=(1, 1, 1, 1))
  return dataclasses.replace(
      exp,
      model_config=model_config,
      data=dataclasses.replace(exp.data, train_size=(32, 32), num_frames=3,
                               num_queries=8, batch_size=2),
      task=trainer_lib.TaskConfig(train_chunk_size=4),
      optimizer=dataclasses.replace(exp.optimizer, warmup_steps=2),
  )


if __name__ == "__main__":
  main()

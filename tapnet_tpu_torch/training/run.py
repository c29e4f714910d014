"""Training CLI of the port (the counterpart of tapnet_tpu/training/run.py):

  python -m tapnet_tpu_torch.training.run --experiment tapnext|tapnextpp \
      --synthetic --num_steps N [--checkpoint_dir D] [--total_steps S] \
      [--batch_size B] [--num_frames T] [--num_queries Q] [--seed 0] \
      [--log_every 50] [--device cpu]

Trains on the synthetic sprite generator, batches made on the device. It
runs on the CUDA card and raises without one unless given `--device cpu`.
The Kubric reader (--data_dir), in-train evaluation (--eval_dir) and
multi-GPU (--model_parallel > 1) are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
  parser = argparse.ArgumentParser(description="tapnet_tpu_torch training")
  parser.add_argument("--experiment", default="tapnext",
                      help="registry name: tapnext / tapnextpp")
  parser.add_argument("--data_dir", default=None,
                      help="Kubric-format npz examples (not ported yet)")
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
  parser.add_argument("--model_parallel", type=int, default=1)
  parser.add_argument("--eval_dir", default=None,
                      help="in-train held-out eval (not ported yet)")
  parser.add_argument("--num_frames", type=int, default=None)
  parser.add_argument("--num_queries", type=int, default=None)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--device", default=None,
                      help="torch device; default the CUDA card")
  args = parser.parse_args(argv)

  if args.data_dir or not args.synthetic:
    raise NotImplementedError(
        "the Kubric training reader is not ported yet: pass --synthetic")
  if args.eval_dir:
    raise NotImplementedError("in-train evaluation is not ported yet")

  from tapnet_tpu_torch import configs
  from tapnet_tpu_torch.data import synthetic
  from tapnet_tpu_torch.inference import resolve_device
  from tapnet_tpu_torch.training import trainer as trainer_lib

  if args.model_parallel != 1:
    raise NotImplementedError(trainer_lib._MESH_NOT_PORTED)  # pylint: disable=protected-access
  device = resolve_device(args.device)
  exp = configs.get_experiment(args.experiment)
  batch_size = args.batch_size or exp.data.batch_size
  num_steps = args.num_steps or exp.total_steps
  num_frames = args.num_frames or exp.data.num_frames
  num_queries = args.num_queries or exp.data.num_queries
  data = synthetic.batch_iterator(
      seed=args.seed, device=device, batch_size=batch_size,
      num_frames=num_frames, height=exp.data.train_size[0],
      width=exp.data.train_size[1], num_queries=num_queries)
  ckpt_path = (os.path.join(args.checkpoint_dir, "checkpoint.npy")
               if args.checkpoint_dir else None)
  t = trainer_lib.Trainer(
      exp.build_model(), exp.optimizer, total_steps=args.total_steps or num_steps,
      task=exp.task, checkpoint_path=ckpt_path,
      checkpoint_every=args.checkpoint_every, loss_builder=exp.loss_builder,
      device=device)
  state = t.restore_or_init()
  state = t.fit(state, data, num_steps=num_steps, log_every=args.log_every)
  if ckpt_path:
    t.save(state)
  print(f"finished at step {state.step}")
  return state


if __name__ == "__main__":
  main()

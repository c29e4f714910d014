"""Readings from which a cell's limits are set, and the control's check:

  python3 tapbench/calibrate.py --workload <name> --seeds 1,2,3 \
      --seconds <s> [--control]

runs the cell once per seed in this process, each a whole run of the
harness at the cell's own sizes and load (a short window), with the
program, or with `--control` the family's control in its place (TAPIR: the
program's bfloat16 path; TAPNext: the reference with float8 ViT products),
and prints one JSON line a seed: its numbers compared with the plain
reference and whether the cell's limits pass it. A control has to fail.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

# pylint: disable=wrong-import-position
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(HERE))
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, "_cache",
                                                  "torch_extensions")

import torch  # noqa: E402

import harness  # noqa: E402


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--control", action="store_true")
  args = ap.parse_args(argv)
  if not torch.cuda.is_available():
    print("calibrate: no CUDA card", file=sys.stderr)
    return 3
  for seed in (int(s) for s in args.seeds.split(",")):
    start = time.perf_counter()
    r = harness.run(args.workload, seed, args.seconds, False, "cuda:0", start,
                    control=args.control)
    print(json.dumps({"workload": args.workload, "seed": seed,
                      "control": args.control, "correct": r["correct"],
                      "attempted": r["attempted"], "stats": r["stats"],
                      "metrics": r["metrics"], "phases": r["phases"],
                      "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                      "run_s": time.perf_counter() - start}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())

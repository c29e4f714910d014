"""Runs one cell of the benchmark on the card(s) of this machine:

  python3 tapbench/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout. It prints, as the last line of standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device` (and `breakdown` when traced), and last `checks`, each number
compared with the plain reference beside its limit, which also end standard
error. Without a CUDA card, or with fewer than the cell asks for, it exits
with code 3 and prints no result; with JAX or the JAX package in the
process, code 4.
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
REPO = os.path.dirname(HERE)
# Every build and kernel cache inside the checkout, at fixed paths.
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, "_cache",
                                                  "torch_extensions")
sys.path.insert(1, REPO)

import torch  # noqa: E402

import harness  # noqa: E402


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)

  chips = harness.load_cell(args.workload).workload["chips"]
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"tapbench: {args.workload} needs {chips} CUDA card(s), found "
          f"{found}", file=sys.stderr)
    return 3
  try:
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda:0", STARTED)
  except harness.Forbidden as e:
    print(f"tapbench: {e}", file=sys.stderr)
    return 4
  for name, c in result["checks"].items():
    print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())

"""Times the ExtraConvs kernels of the checkout it runs from, on the card.

X (`qconv.conv2d_q8`, conv_up's shape), K6 (`extra_convs_layer`,
quantized=True) and K6f (quantized=False) in bf16 and fp32, on seeded
inputs at one served grid ([frames, grid, grid, 256], hidden 1024), scaled
as chip_smoke.py scales them. Prints the card's name and power limit, then
one JSON line of ms per call (CUDA events, the mean of `--reps` calls after
two warm-up calls).

To compare two versions of `csrc/extra_convs.cu` on one card, run it from
each checkout in turn on the same machine, in the order A B B A:

    python3 tools/time_extra_convs.py --frames 250 --grid 60
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tapnet_tpu_torch.ops import fused_extra_convs, qconv  # noqa: E402


def time_ms(fn, reps):
  for _ in range(2):
    fn()
  torch.cuda.synchronize()
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--frames", type=int, default=250)
  parser.add_argument("--grid", type=int, default=60)
  parser.add_argument("--reps", type=int, default=5)
  parser.add_argument("--seed", type=int, default=0)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    sys.exit("time_extra_convs: no CUDA device")
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=False).stdout.strip()
  print(card, flush=True)
  gen = torch.Generator(device="cuda").manual_seed(args.seed)
  c, m = 256, 1024
  f = lambda *s: torch.randn(*s, device="cuda", generator=gen)
  x32 = f(args.frames, args.grid, args.grid, c)
  params = [f(c) * 0.2 + 1, f(c) * 0.1, f(3, 3, c, m) / (3 * c**0.5),
            f(m) * 0.1, f(3, 3, m, c) / (6 * m**0.5), f(c) * 0.1]
  g, bln, wu, bu, wo, bo = params
  qweights = fused_extra_convs.quantized_weights(wu, wo)
  wq = qconv.quantize_conv_weight(wu.permute(3, 2, 0, 1))
  times = {}
  for dtype in (torch.bfloat16, torch.float32):
    name = str(dtype).replace("torch.", "")
    x = x32.to(dtype)
    x_nchw = x.permute(0, 3, 1, 2)
    times[f"X conv_up {name}"] = time_ms(
        lambda: qconv.conv2d_q8(x_nchw, None, bu, qweights=wq), args.reps)
    times[f"K6 {name}"] = time_ms(
        lambda: fused_extra_convs.extra_convs_layer(
            x, g, bln, None, bu, None, bo, True, qweights=qweights), args.reps)
    times[f"K6f {name}"] = time_ms(
        lambda: fused_extra_convs.extra_convs_layer(x, *params, False),
        args.reps)
  print(json.dumps(dict(card=card, frames=args.frames, grid=args.grid,
                        ms=times)), flush=True)


if __name__ == "__main__":
  main()

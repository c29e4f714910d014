"""Times the ExtraConvs, mixer and corr-tents kernels of a checkout on the
card, with each one's phases, and optionally whole served videos.

X (`qconv.conv2d_q8`: conv_up and conv_out of one grid), K6
(`extra_convs_layer`, quantized=True) at each grid, K6f (quantized=False)
at each grid beside the model's unfused float layer (`layers.ExtraConvs`:
cuDNN convolutions and PyTorch elementwise passes, which the port's K6f
entry never calls; in float32 at PyTorch's defaults, cuDNN in TF32, and
with TF32 off, the precision K6f holds), K4 (`mixer_block`, quantized=True, at [128, 250, 512])
and K3 (the same block in full precision) in bf16 and fp32, on seeded
inputs scaled as chip_smoke.py scales them; K1 (the full-precision
corr-tents) at the three pyramid grids of a 480x480 video (250 frames, 128
queries) and of an online 256x256 step (1 frame, 64 queries); K2 and K2b
(the int8 corr-tents at the 480x480 grids) as the model calls them once per
chunk and step, the whole call as a caller sees it (a checkout that
quantizes the query in a launch of its own, or scales the output in
PyTorch, pays for that in the call): K2 on a grid quantized once per video,
K2b on a grid quantized once per video where the checkout has
`quantize_per_position` and inline otherwise, with the grid's quantization
(quantize_rows) timed on its own. It splits
one launch by kernel with torch.profiler: X into its quantization (frame
amax and quantize) and its product; K6 into LayerNorm and patch scale,
conv_up, conv_out; K6f into LayerNorm, conv_up, conv_out and (float32)
the weights' split; K4 into the
temporal half and the MLP; K3 into the temporal half, its two products and
(float32) the weights' split; K2 and K2b into the query's quantizer (none
where the kernel quantizes it), the kernel and the rest (PyTorch's scale
product). `means` holds the mean over the three levels of each K2 and K2b
route and of the grid's quantization.
For context it times cuBLAS's two bare products of K3's shape
(torch.matmul; bf16, and fp32 with TF32 off), which the port never calls.
Prints the card's name and power limit, then one JSON line: ms per call
(CUDA events, the mean of `--reps` calls after two warm-up calls) and the
splits. `--kernels` picks a subset (default: all of X, K6, K6f, K4, K3, K1,
K2, K2b).

`--walls serve,serve_fp32,int8_b,int8,headline` also serves 480x480 videos
of 250 frames through `TapirPredictor` with the committed trained weights
(serve-480: bf16, full precision; -fp32: the same in the predictor's
default float32, PyTorch's TF32 settings at their defaults; -int8-b:
configuration b in bf16; -int8: a with 2 refinement steps; -headline: c
with 1024 queries), one warm-up video and WALL_VIDEOS timed ones through
`track_many`, and reports the wall per video (host clock, synchronised).

`--root` names the checkout whose `tapnet_tpu_torch` is timed (default: the
one this file is in), so one script times two versions. To compare them on
one card, run it for each in turn in one call, in the order A B B A:

    python3 tools/time_int8_kernels.py --root path/to/other/checkout
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def split_ms(fn, phases):
  """Device ms of one call of fn by phase (torch.profiler): phases maps a
  name to kernel-name fragments; a kernel counts in the first phase it
  matches, else `other`."""
  from torch.profiler import ProfilerActivity, profile  # pylint: disable=import-outside-toplevel

  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  out = {name: 0.0 for name in phases}
  out["other"] = 0.0
  for e in prof.key_averages():
    if not str(e.device_type).endswith("CUDA"):
      continue
    us = getattr(e, "self_device_time_total", None)
    if us is None:
      us = e.self_cuda_time_total
    name = next((n for n, keys in phases.items()
                 if any(k in e.key for k in keys)), "other")
    out[name] += us / 1e3
  return out


# Kernel-name fragments of each phase of K6 and K4 (chip_smoke.py's splits
# too); the names of the designs before the shared int8 tile loop come
# second, so that the tool splits an older checkout alike.
K6_PHASES = {
    "ln_and_patch_scale": ("ln_bias_rows", "patch_scale"),
    "conv_up": ("k6_conv_up", "conv3x3_q8<float, 1>", "conv3x3_q8<__nv_bfloat16, 1>",
                "quantize_rows"),
    "conv_out": ("k6_conv_out", "conv3x3_q8<float, 2>", "conv3x3_q8<__nv_bfloat16, 2>"),
}
K4_PHASES = {
    "temporal": ("mixer_temporal",),
    "mlp": ("mixer_mlp_q8", "mixer_gemm_q8", "mixer_quantize_rows", "Memset"),
}
# X and K3 (before PR 8: conv3x3_q8<T> and mixer_gemm_bf16<EPI> on older
# loops). K3's GEMM 1 is epilogue 0 (GELU), GEMM 2 epilogue 1 (residual).
# K6f: the names of the earlier loops (bf16 conv3x3_bf16<MODE>; the float32
# SIMT loop's conv3x3_f32<MODE> after ln_bias_rows) come second; float32
# splits its weights first.
K6F_PHASES = {
    "ln": ("ln_bias_slab", "ln_bias_rows"),
    "conv_up": ("UpSlabEpilogue", "conv3x3_bf16<3>", "conv3x3_f32<3>"),
    "conv_out": ("OutSlabEpilogue", "conv3x3_bf16<4>", "conv3x3_f32<4>"),
    "weight_split": ("split_tf32",),
}
# K2 and K2b: the query's quantize_rows launch, where a checkout has one,
# and the kernel.
CORR_Q8_PHASES = {
    "quantize": ("corr_quantize_rows",),
    "kernel": ("corr_tents_q8_kernel",),
}
X_PHASES = {
    "quantize": ("frame_amax", "quantize_frames", "Memset"),
    "product": ("conv3x3_q8",),
}
K3_PHASES = {
    "temporal": ("mixer_temporal",),
    "gemm_up": ("mixer_gemm_tma<0", "mixer_gemm_bf16<0", "mixer_gemm_f32<0"),
    "gemm_down": ("mixer_gemm_tma<1", "mixer_gemm_bf16<1", "mixer_gemm_f32<1"),
    "weight_split": ("split_tf32",),
}
KERNELS = ("X", "K6", "K6f", "K4", "K3", "K1", "K2", "K2b")
# The corr-tents grids of a 480x480 video (H, W, C), 250 frames, a chunk of
# 128 queries; and of an online 256x256 step, 1 frame, 64 queries.
CORR_LEVELS = [(120, 120, 128), (60, 60, 256), (30, 30, 256)]
CORR_QUERIES = 128
ONLINE_CORR_LEVELS = [(64, 64, 128), (32, 32, 256), (16, 16, 256)]
ONLINE_QUERIES = 64
# Served configurations (`--walls`): tools/golden_clip.py's int8
# configuration (None: full precision), further overrides of
# bootstapir_config(), queries per video and whether the predictor runs in
# bf16; timed videos after the warm-up.
WALLS = {
    "serve": (None, {}, 256, True),
    "serve_fp32": (None, {}, 256, False),
    "int8_b": ("b", {}, 256, True),
    "int8": ("a", dict(num_pips_iter=2), 256, True),
    "headline": ("c", {}, 1024, True),
}
WALL_VIDEOS = 2
CHECKPOINT = os.path.join(ROOT, "runs/bootstapir_synth/trained_params_f16.npy")


def corr_inputs(h, w, c, frames, gen, dtype, queries=CORR_QUERIES):
  """Unit-norm grids, queries near grid features, centres over the frame."""
  grid = torch.nn.functional.normalize(
      torch.randn(frames, h, w, c, device="cuda", generator=gen), dim=-1)
  cy = torch.rand(frames, queries, device="cuda", generator=gen) * h - 0.5
  cx = torch.rand(frames, queries, device="cuda", generator=gen) * w - 0.5
  query = grid[torch.arange(frames, device="cuda")[:, None],
               cy.round().clamp(0, h - 1).long(), cx.round().clamp(0, w - 1).long()]
  return grid.to(dtype), query.to(dtype).contiguous(), cy, cx


def serve_walls(names, frames, videos, seed):
  """Wall seconds per video of each served configuration in `names`."""
  from tapnet_tpu_torch.checkpoints.tapir_checkpoint import load_tapir_checkpoint  # pylint: disable=import-outside-toplevel
  from tapnet_tpu_torch.inference import TapirPredictor  # pylint: disable=import-outside-toplevel
  from tapnet_tpu_torch.models.tapir import bootstapir_config  # pylint: disable=import-outside-toplevel
  sys.path.append(ROOT)
  from tools.golden_clip import INT8_CONFIGS  # pylint: disable=import-outside-toplevel

  params = load_tapir_checkpoint(CHECKPOINT)
  gen = torch.Generator(device="cuda").manual_seed(seed)
  res = 480
  base = torch.nn.functional.interpolate(
      torch.rand(1, 3, 60, 60, device="cuda", generator=gen), size=(res, res),
      mode="bilinear")[0]
  walls = {}
  # PyTorch's defaults: float32 matmuls in full float32, cuDNN in TF32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = True
  for name in names:
    config, extra, queries, bfloat16 = WALLS[name]
    overrides = dict(INT8_CONFIGS[config] if config else {}, **extra)
    predictor = TapirPredictor(
        params, bootstapir_config(**overrides), bfloat16=bfloat16,
        query_chunk_size=128, refinement_resolutions=[(res, res)])
    clips = []
    for k in range(videos + 1):
      video = torch.stack([torch.roll(base, (k + 1) * t, dims=2)
                           for t in range(frames)]).permute(0, 2, 3, 1)[None]
      qp = np.stack([np.random.RandomState(seed + k).randint(0, frames, queries),
                     np.random.RandomState(seed + k + 1).rand(queries) * (res - 16) + 8,
                     np.random.RandomState(seed + k + 2).rand(queries) * (res - 16) + 8],
                    -1)[None].astype(np.float32)
      clips.append((video * 2 - 1, qp))
    predictor(*clips[0])
    torch.cuda.synchronize()
    start = time.perf_counter()
    outs = list(predictor.track_many(clips[1:]))
    torch.cuda.synchronize()
    walls[name] = (time.perf_counter() - start) / videos
    assert all(np.isfinite(o["tracks"]).all() for o in outs), name
    del predictor, clips, outs
    torch.cuda.empty_cache()
  return walls


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--root", default=ROOT)
  parser.add_argument("--frames", type=int, default=250)
  parser.add_argument("--grids", default="60,32")
  parser.add_argument("--reps", type=int, default=5)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--kernels", default=",".join(KERNELS))
  parser.add_argument("--walls", default="")
  args = parser.parse_args()
  chosen = set(args.kernels.split(","))
  sys.path.insert(0, os.path.abspath(args.root))
  from tapnet_tpu_torch.models import layers  # pylint: disable=import-outside-toplevel
  from tapnet_tpu_torch.ops import (  # pylint: disable=import-outside-toplevel
      corr_tents, fused_extra_convs, fused_mixer_block, mixer_math, qconv)

  if not torch.cuda.is_available():
    sys.exit("time_int8_kernels: no CUDA device")
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=False).stdout.strip()
  print(card, flush=True)
  gen = torch.Generator(device="cuda").manual_seed(args.seed)
  f = lambda *s: torch.randn(*s, device="cuda", generator=gen)
  c, m = 256, 1024
  params = [f(c) * 0.2 + 1, f(c) * 0.1, f(3, 3, c, m) / (3 * c**0.5),
            f(m) * 0.1, f(3, 3, m, c) / (6 * m**0.5), f(c) * 0.1]
  g, bln, wu, bu, wo, bo = params
  qweights = fused_extra_convs.quantized_weights(wu, wo)
  wq_up = qconv.quantize_conv_weight(wu.permute(3, 2, 0, 1))
  wq_out = qconv.quantize_conv_weight(wo.permute(3, 2, 0, 1))
  mc = 512
  mixer = [f(128, args.frames, mc), f(mc) * 0.2 + 1, f(3, 1, 4 * mc) * 0.3,
           f(4 * mc) * 0.1, f(3, 1, 4 * mc) * 0.3, f(4 * mc) * 0.1,
           f(mc) * 0.2 + 1, f(mc, 4 * mc) / mc**0.5, f(4 * mc) * 0.1,
           f(4 * mc, mc) / (4 * mc)**0.5, f(mc) * 0.1]
  mixer_q = []
  for w in (mixer[7], mixer[9]):
    q, scale = mixer_math.quantize_weight_cols(w)
    mixer_q += [q.t().contiguous().t(), scale]
  times, splits = {}, {}
  for dtype in (torch.bfloat16, torch.float32):
    name = str(dtype).replace("torch.", "")
    for grid in (int(v) for v in args.grids.split(",")):
      x = f(args.frames, grid, grid, c).to(dtype)
      x_nchw = x.permute(0, 3, 1, 2)
      if "X" in chosen:
        hidden_nchw = mixer_math.gelu(f(args.frames, grid, grid, m)).to(dtype).permute(0, 3, 1, 2)
        for conv, xin, bias, wq in (("conv_up", x_nchw, bu, wq_up),
                                    ("conv_out", hidden_nchw, bo, wq_out)):
          run = lambda: qconv.conv2d_q8(xin, None, bias, qweights=wq)  # pylint: disable=cell-var-from-loop
          times[f"X {conv} {grid} {name}"] = time_ms(run, args.reps)
          splits[f"X {conv} {grid} {name}"] = split_ms(run, X_PHASES)
        del hidden_nchw
      if "K6" in chosen:
        k6 = lambda: fused_extra_convs.extra_convs_layer(
            x, g, bln, None, bu, None, bo, True, qweights=qweights)
        times[f"K6 {grid} {name}"] = time_ms(k6, args.reps)
        splits[f"K6 {grid} {name}"] = split_ms(k6, K6_PHASES)
      if "K6f" in chosen:
        k6f = lambda: fused_extra_convs.extra_convs_layer(x, *params, False)
        times[f"K6f {grid} {name}"] = time_ms(k6f, args.reps)
        splits[f"K6f {grid} {name}"] = split_ms(k6f, K6F_PHASES)
        unfused = layers.ExtraConvs(channels=c, num_layers=1,
                                    channel_multiplier=m // c)
        unfused.load_state_dict({
            "ln_0.scale": g, "ln_0.bias": bln,
            "conv_up_0.weight": wu.permute(3, 2, 0, 1), "conv_up_0.bias": bu,
            "conv_out_0.weight": wo.permute(3, 2, 0, 1), "conv_out_0.bias": bo})
        unfused = unfused.to(device="cuda", dtype=dtype).eval()
        with torch.inference_mode():
          times[f"unfused layer {grid} {name}"] = time_ms(
              lambda: unfused(x_nchw), args.reps)
          if dtype == torch.float32:  # cuDNN in full float32, as K6f's 1e-4
            torch.backends.cudnn.allow_tf32 = False
            times[f"unfused layer {grid} {name} tf32 off"] = time_ms(
                lambda: unfused(x_nchw), args.reps)
            torch.backends.cudnn.allow_tf32 = True
        del unfused
      del x, x_nchw
      torch.cuda.empty_cache()
    if "K1" in chosen:
      for frames, queries, levels, what in (
          (args.frames, CORR_QUERIES, CORR_LEVELS, ""),
          (1, ONLINE_QUERIES, ONLINE_CORR_LEVELS, "online ")):
        for h, w, cc in levels:
          grid, query, cy, cx = corr_inputs(h, w, cc, frames, gen, dtype,
                                            queries)
          k1 = lambda: corr_tents.corr_tent_patches(grid, query, cy, cx, 7)  # pylint: disable=cell-var-from-loop
          times[f"K1 {what}{h}x{w}x{cc} {name}"] = time_ms(k1, 4 * args.reps)
          del grid, query, cy, cx
        torch.cuda.empty_cache()
    if {"K2", "K2b"} & chosen:
      for h, w, cc in CORR_LEVELS:
        grid, query, cy, cx = corr_inputs(h, w, cc, args.frames, gen, dtype)
        level = f"{h}x{w}x{cc} {name}"
        if "K2" in chosen:
          gq, gs = corr_tents.quantize_per_frame(grid)
          k2 = lambda: corr_tents.corr_tent_patches_prequantized(
              gq, gs, query, cy, cx, 7)
          times[f"K2 {level}"] = time_ms(k2, 4 * args.reps)
          splits[f"K2 {level}"] = split_ms(k2, CORR_Q8_PHASES)
        if "K2b" in chosen:
          inline = lambda: corr_tents.corr_tent_patches(
              grid, query, cy, cx, 7, True)
          times[f"K2b inline {level}"] = time_ms(inline, 4 * args.reps)
          k2b = inline
          if hasattr(corr_tents, "quantize_per_position"):
            quantize = lambda: corr_tents.quantize_per_position(grid)
            times[f"K2b grid quantization {level}"] = time_ms(
                quantize, 4 * args.reps)
            gq, gs = quantize()
            k2b = lambda: corr_tents.corr_tent_patches_prequantized_per_position(
                gq, gs, query, cy, cx, 7)
          times[f"K2b {level}"] = time_ms(k2b, 4 * args.reps)
          splits[f"K2b {level}"] = split_ms(k2b, CORR_Q8_PHASES)
        del grid, query, cy, cx
        torch.cuda.empty_cache()
    margs = [a.to(dtype) for a in mixer]
    if "K4" in chosen:
      k4 = lambda: fused_mixer_block.mixer_block(
          *margs, False, None, quantized=True, qweights=tuple(mixer_q))
      times[f"K4 {name}"] = time_ms(k4, 4 * args.reps)
      splits[f"K4 {name}"] = split_ms(k4, K4_PHASES)
      torch.cuda.reset_peak_memory_stats()
      base = torch.cuda.memory_allocated()
      k4()
      torch.cuda.synchronize()
      times[f"K4 {name} peak_bytes_over_inputs"] = torch.cuda.max_memory_allocated() - base
    if "K3" in chosen:
      k3 = lambda: fused_mixer_block.mixer_block(*margs, False, None)
      times[f"K3 {name}"] = time_ms(k3, 4 * args.reps)
      splits[f"K3 {name}"] = split_ms(k3, K3_PHASES)
      torch.backends.cuda.matmul.allow_tf32 = False
      rows = margs[0].reshape(-1, mc)
      hidden = torch.empty(rows.shape[0], 4 * mc, dtype=dtype, device="cuda")
      times[f"cuBLAS K3 products {name}"] = (
          time_ms(lambda: torch.matmul(rows, margs[7]), 4 * args.reps)
          + time_ms(lambda: torch.matmul(hidden, margs[9]), 4 * args.reps))
      del rows, hidden
  walls = (serve_walls(args.walls.split(","), args.frames, WALL_VIDEOS,
                       args.seed) if args.walls else {})
  means = {}
  for what in ("K2", "K2b", "K2b grid quantization"):
    for name in ("bfloat16", "float32"):
      level_ms = [times.get(f"{what} {h}x{w}x{cc} {name}")
                  for h, w, cc in CORR_LEVELS]
      if None not in level_ms:
        means[f"{what} {name}"] = sum(level_ms) / len(level_ms)
  print(json.dumps(dict(card=card, root=os.path.abspath(args.root),
                        frames=args.frames, ms=times, split_ms=splits,
                        means=means, wall_s_per_video=walls)),
        flush=True)


if __name__ == "__main__":
  main()

"""Drives the PyTorch port of BootsTAPIR on one CUDA card and checks it.

  python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. Card and build: prints the card's name and power limit (nvidia-smi) and
     builds every kernel of tapnet_tpu_torch/csrc, one nvcc per source.
  2. Kernels: each CUDA kernel against its plain PyTorch version on the card,
     at the shapes the 480x480 main path gives it, in fp32 and bf16, timed
     with CUDA events beside the plain version and a bound from bytes and
     operations.
  3. Main path: the committed trained BootsTAPIR through
     TapirPredictor: the golden clip in fp32 (TF32 off) and bf16 against the
     JAX golden outputs, then track_many over several 480x480 videos in bf16
     (250 frames, 256 queries, chunk 128: the shapes phase 2 checks) with
     the kernels' launch counters reset before and read after.
  4. The last line: {"ok": true, "device": {...}}.

Every phase prints its record as one JSON line. Exits non-zero, and prints
no result, without a CUDA card or without the repository beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from tapnet_tpu_torch.checkpoints.tapir_checkpoint import load_tapir_checkpoint  # noqa: E402
from tapnet_tpu_torch.inference import TapirPredictor  # noqa: E402
from tapnet_tpu_torch.models.tapir import bootstapir_config  # noqa: E402
from tapnet_tpu_torch.ops import _build, corr_tents, fused_mixer_block  # noqa: E402
from tapnet_tpu_torch.utils.sampling import preprocess_frames  # noqa: E402

CHECKPOINT = os.path.join(REPO, "runs/bootstapir_synth/trained_params_f16.npy")
GOLDEN = os.path.join(REPO, "tests/data/bootstapir_golden.npz")
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and flop/s by
# operand type (bf16 on the tensor cores, fp32 outside them).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Main-path shapes of the served videos at 480x480 (refinement at 480 only,
# chunk 128, 250 frames): corr-tents grids per pyramid level (H, W, C), with
# BT = 250 frames and N = 128 queries, and the mixer block's x [B*N, T, C].
FRAMES, QUERIES, CHUNK, RES = 250, 256, 128, 480
CORR_LEVELS = [(120, 120, 128), (60, 60, 256), (30, 30, 256)]
MIXER_SHAPE = (CHUNK, FRAMES, 512)

# Kernel vs plain on the card. fp32, as (rtol, atol): summation order only.
# bf16 corr-tents, atol in units of max|grid row| * max|query row|, which
# bounds |corr|: both sides round the same correlation to bf16 and may land
# one step (<= 2^-7 |corr|) apart; the plain version also rounds the y-tent
# stage and the x-tents to bf16 (<= 2^-8 |corr| each) where the kernel keeps
# them fp32. Sum: 2^-6. bf16 mixer: elementwise, two bf16 steps of each
# value the two sides round separately (fused_mixer_block.bf16_error_limit).
CORR_FP32_TOL = (0.0, 1e-4)
CORR_BF16_STEPS = 2.0**-6
MIXER_FP32_TOL = (1e-4, 1e-4)
# Port on the card vs the JAX golden outputs (CPU, fp32). fp32 with TF32
# off: summation order in cuDNN/cuBLAS and the kernels (0.00066 px on the
# CPU). bf16: a different dtype than the golden run; held on the median and
# 95th percentile of the track error and on the visibility flags.
GOLDEN_FP32_TOL = dict(tracks=0.05, logits=5e-3)
GOLDEN_BF16_TOL = dict(median_px=0.5, p95_px=2.0, visible_agree=0.95)


def require(cond, msg):
  if not cond:
    raise RuntimeError(msg)


def card_line() -> str:
  res = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60,
  )
  return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps=10, warmup=2) -> float:
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ kernels


def corr_inputs(h, w, c, dtype, gen):
  """Unit-norm, spatially smooth feature grids (neighbouring positions
  correlate, as the backbone's do), track centres spread over the frame and
  a few off its edges, and per query the feature of a grid position within
  1.5 cells of its centre plus noise: a correlation peak of about 0.95 in
  the window, as a tracked point gives."""
  dev = "cuda"
  bt, n = FRAMES, CHUNK
  grid = torch.randn(bt, c, h, w, device=dev, generator=gen)
  grid = F.avg_pool2d(grid, 3, stride=1, padding=1, count_include_pad=False)
  grid = F.normalize(grid, dim=1).permute(0, 2, 3, 1).contiguous()
  cy = torch.rand(bt, n, device=dev, generator=gen) * (h + 4) - 2.5
  cx = torch.rand(bt, n, device=dev, generator=gen) * (w + 4) - 2.5
  jitter = lambda: torch.rand(bt, n, device=dev, generator=gen) * 3 - 1.5
  sy = (cy + jitter()).round().clamp(0, h - 1).long()
  sx = (cx + jitter()).round().clamp(0, w - 1).long()
  query = grid[torch.arange(bt, device=dev)[:, None], sy, sx]
  noise = torch.randn(bt, n, c, device=dev, generator=gen) * (0.3 / c**0.5)
  query = F.normalize(query + noise, dim=-1)
  return grid.to(dtype), query.to(dtype), cy, cx


def corr_tol(grid, query):
  """(rtol, atol) of the corr-tents check for these inputs."""
  if grid.dtype == torch.float32:
    return CORR_FP32_TOL
  scale = float(grid.float().norm(dim=-1).max() * query.float().norm(dim=-1).max())
  return (0.0, CORR_BF16_STEPS * scale)


def corr_bound(grid, query, cy, cx, p=7):
  """Least bytes and flops of this run's corr-tents call: the grid
  positions the (p+1)^2 windows touch (each read once), the queries,
  centres and outputs; 2*C flops per window position per query."""
  bt, h, w, c = grid.shape
  win = torch.arange(p + 1, device=cy.device)
  ys = torch.floor(cy).long()[..., None] - (p - 1) // 2 + win  # [BT, N, p+1]
  xs = torch.floor(cx).long()[..., None] - (p - 1) // 2 + win
  yy = ys[..., :, None].expand(-1, -1, -1, p + 1)
  xx = xs[..., None, :].expand(-1, -1, p + 1, -1)
  ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
  bb = torch.arange(bt, device=cy.device)[:, None, None, None].expand_as(yy)
  touched = torch.zeros(bt, h, w, dtype=torch.bool, device=cy.device)
  touched[bb[ok], yy[ok], xx[ok]] = True
  elt = grid.element_size()
  n = query.shape[1]
  nbytes = (int(touched.sum()) * c * elt + query.numel() * elt
            + (cy.numel() + cx.numel()) * 4 + bt * p * p * n * 4)
  flops = 2.0 * int(ok.sum()) * c
  return nbytes, flops


def mixer_inputs(dtype, gen):
  b, t, c = MIXER_SHAPE
  hid = 4 * c
  f = lambda *s: torch.randn(*s, device="cuda", generator=gen)
  args = [
      f(b, t, c), f(c) * 0.2 + 1, f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1,
      f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1, f(c) * 0.2 + 1,
      f(c, hid) / c**0.5, f(hid) * 0.1, f(hid, c) / hid**0.5, f(c) * 0.1,
  ]
  return [a.to(dtype) for a in args]


def mixer_bound(args):
  x, w1, w2 = args[0], args[7], args[9]
  rows = x.shape[0] * x.shape[1]
  c, hid = w1.shape
  elt = x.element_size()
  params = sum(a.numel() for a in args[1:])
  nbytes = 2 * x.numel() * elt + params * elt
  flops = 2.0 * rows * c * hid * 2
  return nbytes, flops


def bound_ms(nbytes, flops, dtype):
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[dtype] * 1e3
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels():
  """Each kernel against its plain version on the same inputs, timed. Returns
  one record per check, and per kernel and dtype a `path` record: what one
  launch on the served path costs (K1: the mean over the three pyramid
  levels, which each refinement step calls once each)."""
  gen = torch.Generator(device="cuda").manual_seed(SEED)
  checks = []
  for dtype in (torch.bfloat16, torch.float32):
    name_dt = str(dtype).replace("torch.", "")
    totals = dict(ms=0.0, plain_ms=0.0, err=0.0, nbytes=0, flops=0.0)
    for h, w, c in CORR_LEVELS:
      args = corr_inputs(h, w, c, dtype, gen)
      out = corr_tents.corr_tent_patches(*args, 7)
      torch.cuda.synchronize()
      ref = corr_tents.corr_tent_patches_reference(*args, 7)
      torch.cuda.synchronize()
      err = float((out - ref).abs().max())
      tol = corr_tol(args[0], args[1])
      require(torch.isfinite(out).all() and torch.allclose(out, ref, *tol),
              f"corr_tents {name_dt} {h}x{w}x{c}: max_abs_err {err}, tol {tol}")
      nbytes, flops = corr_bound(*args)
      ms = time_ms(lambda: corr_tents.corr_tent_patches(*args, 7))
      plain = time_ms(lambda: corr_tents.corr_tent_patches_reference(*args, 7), reps=3)
      b_ms, b_by = bound_ms(nbytes, flops, dtype)
      checks.append(dict(kernel="corr_tents", dtype=name_dt,
                         shape=[FRAMES, h, w, c, CHUNK], max_abs_err=err,
                         max_err_over_limit=err / tol[1],
                         ref_max_abs=float(ref.abs().max()), tol=tol, ms=ms,
                         plain_ms=plain, bound_ms=b_ms, bound_by=b_by))
      totals["ms"] += ms
      totals["plain_ms"] += plain
      totals["err"] = max(totals["err"], err)
      totals["nbytes"] += nbytes
      totals["flops"] += flops
      del args, out, ref
    levels = len(CORR_LEVELS)
    b_ms, b_by = bound_ms(totals["nbytes"], totals["flops"], dtype)
    checks.append(dict(
        kernel="corr_tents", dtype=name_dt, path=True,
        shape=f"mean of one launch at each of the {levels} pyramid levels",
        max_abs_err=totals["err"],
        max_err_over_limit=max(c["max_err_over_limit"] for c in checks[-levels:]),
        tol=max((c["tol"] for c in checks[-levels:]), key=lambda t: t[1]),
        ms=totals["ms"] / levels, plain_ms=totals["plain_ms"] / levels,
        bound_ms=b_ms / levels, bound_by=b_by,
    ))

    args = mixer_inputs(dtype, gen)
    out = fused_mixer_block.mixer_block(*args, False)
    torch.cuda.synchronize()
    ref = fused_mixer_block.mixer_block_reference(*args, False)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    require(bool(torch.isfinite(out.float()).all()), f"mixer_block {name_dt}: non-finite")
    if dtype == torch.float32:
      tol = MIXER_FP32_TOL
      over = float((diff / (tol[1] + tol[0] * ref.abs())).max())
      require(torch.allclose(out, ref, *tol),
              f"mixer_block float32: max_abs_err {err}, tol {tol}")
    else:
      tol = "2 bf16 steps of |h|, |x1|, |out| and rms(y), per element"
      limit = fused_mixer_block.bf16_error_limit(*args, False)
      require(bool((diff <= limit).all()),
              f"mixer_block bfloat16: max_abs_err {err} over its limit")
      over = float((diff / limit.clamp_min(1e-30)).max())
      del limit
    nbytes, flops = mixer_bound(args)
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    checks.append(dict(
        kernel="mixer_block", dtype=name_dt, path=True, shape=list(MIXER_SHAPE),
        max_abs_err=err, max_err_over_limit=over, tol=tol,
        ms=time_ms(lambda: fused_mixer_block.mixer_block(*args, False)),
        plain_ms=time_ms(
            lambda: fused_mixer_block.mixer_block_reference(*args, False),
            reps=3),
        bound_ms=b_ms, bound_by=b_by,
    ))
    del args, out, ref, diff
    torch.cuda.empty_cache()
  return checks


KERNEL_META = {
    "corr_tents": dict(
        source="tapnet_tpu_torch/csrc/corr_tents.cu",
        replaces="tapnet_tpu/ops/corr_tents.py:182",
        tpu_kernel="K1 corr_tents._kernel (via _pallas_forward :243)",
    ),
    "mixer_block": dict(
        source="tapnet_tpu_torch/csrc/fused_mixer_block.cu",
        replaces="tapnet_tpu/ops/fused_mixer_block.py:256",
        tpu_kernel="K3 fused_mixer_block._kernel (via _pallas_forward :318)",
    ),
}


# ---------------------------------------------------------------- main path


def golden_check(params):
  golden = np.load(GOLDEN)
  frames = preprocess_frames(torch.from_numpy(golden["video"]))
  result = {}
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  for bf16 in (False, True):
    predictor = TapirPredictor(params, bootstapir_config(), bfloat16=bf16)
    out = predictor(frames, golden["query_points"])
    err = np.linalg.norm(out["tracks"] - golden["tracks"], axis=-1)
    logit_err = max(
        float(np.abs(out[k] - golden[k]).max())
        for k in ("occlusion", "expected_dist")
    )
    agree = float(np.mean(
        predictor.visibles(out) == predictor.visibles(dict(golden))
    ))
    key = "bf16" if bf16 else "fp32"
    result[key] = dict(
        track_max_px=float(np.abs(out["tracks"] - golden["tracks"]).max()),
        track_median_px=float(np.median(err)),
        track_p95_px=float(np.percentile(err, 95)),
        logit_max_abs=logit_err, visible_agree=agree,
    )
    r = result[key]
    if bf16:
      tol = GOLDEN_BF16_TOL
      require(r["track_median_px"] <= tol["median_px"]
              and r["track_p95_px"] <= tol["p95_px"]
              and agree >= tol["visible_agree"],
              f"bf16 golden check failed: {r} vs {tol}")
    else:
      tol = GOLDEN_FP32_TOL
      require(r["track_max_px"] <= tol["tracks"]
              and logit_err <= tol["logits"],
              f"fp32 golden check failed: {r} vs {tol}")
    del predictor
  torch.backends.cudnn.allow_tf32 = True
  return result


def make_videos(count):
  """Textured 480x480 clips on the device: the golden clip's frames,
  upsampled and scrolled a few pixels per frame, one direction per video."""
  golden = np.load(GOLDEN)
  base = torch.from_numpy(golden["video"][0]).cuda().permute(0, 3, 1, 2).float()
  base = torch.nn.functional.interpolate(base, size=(RES, RES), mode="bilinear")
  gen = torch.Generator(device="cpu").manual_seed(SEED)
  videos = []
  for k in range(count):
    vy, vx = (torch.randint(-3, 4, (2,), generator=gen)).tolist()
    frames = torch.stack([
        torch.roll(base[t % base.shape[0]], (vy * t, vx * t), dims=(1, 2))
        for t in range(FRAMES)
    ])
    video = frames.permute(0, 2, 3, 1)[None] / 255.0 * 2.0 - 1.0
    qp = torch.stack([
        torch.randint(0, FRAMES, (QUERIES,), generator=gen).float(),
        torch.rand(QUERIES, generator=gen) * (RES - 16) + 8,
        torch.rand(QUERIES, generator=gen) * (RES - 16) + 8,
    ], -1)[None]
    videos.append((video, qp.numpy()))
  return videos


# Kernel-name fragments per layer, for the profile's breakdown.
LAYERS = (
    ("K1 corr_tents", ("corr_tents_kernel",)),
    ("K3 mixer_block", ("mixer_temporal", "mixer_gemm")),
    ("convolutions (cuDNN, with its layout transforms)",
     ("conv", "fprop", "nchwtonhwc", "nhwctonchw")),
    ("matmuls (cuBLAS)", ("gemm", "cutlass", "cublas")),
)


def profile_video(predictor, video, qp, unprofiled_wall_s, top=10):
  """Kernel time of one request by layer and by name (torch.profiler's
  device timestamps), and the device's busy share of the unprofiled wall
  time of a request (the profiler slows the host, not the kernels)."""
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    predictor(video, qp)
  kernels = []
  for e in prof.key_averages():
    if not str(e.device_type).endswith("CUDA"):
      continue
    dev_us = getattr(e, "self_device_time_total", None)
    if dev_us is None:
      dev_us = e.self_cuda_time_total
    kernels.append((dev_us / 1e3, e.count, e.key))
  kernels.sort(reverse=True)
  device_ms = sum(k[0] for k in kernels)
  by_layer = {name: 0.0 for name, _ in LAYERS}
  by_layer["other (elementwise, reductions, copies)"] = 0.0
  for ms, _, name in kernels:
    layer = next((lay for lay, keys in LAYERS
                  if any(k in name.lower() for k in keys)),
                 "other (elementwise, reductions, copies)")
    by_layer[layer] += ms
  return dict(
      device_ms=device_ms,
      device_busy_share=device_ms / (unprofiled_wall_s * 1e3),
      by_layer_ms=by_layer,
      top=[dict(name=name[:100], ms=ms, calls=calls)
           for ms, calls, name in kernels[:top]],
  )


def serve(params, count=3):
  predictor = TapirPredictor(
      params, bootstapir_config(), bfloat16=True, query_chunk_size=CHUNK,
      refinement_resolutions=[(RES, RES)],
  )
  videos = make_videos(count + 1)
  # Warm-up request: cuDNN algorithm choice and allocator growth.
  predictor(*videos[0])
  torch.cuda.synchronize()
  corr_tents.LAUNCHES = 0
  fused_mixer_block.LAUNCHES = 0
  start = time.perf_counter()
  outs = list(predictor.track_many(videos[1:]))
  wall = time.perf_counter() - start
  launches = dict(corr_tents=corr_tents.LAUNCHES,
                  mixer_block=fused_mixer_block.LAUNCHES)
  require(len(outs) == count, f"track_many yielded {len(outs)} of {count}")
  require(all(v % count == 0 for v in launches.values()),
          f"launches differ between equal requests: {launches}")
  for out in outs:
    require(out["tracks"].shape == (1, QUERIES, FRAMES, 2),
            f"tracks shape {out['tracks'].shape}")
    for key in ("tracks", "occlusion", "expected_dist"):
      require(np.isfinite(out[key]).all(), f"non-finite {key}")
    require(np.abs(out["tracks"]).max() < 4 * RES, "tracks far off the frame")
  require(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
  return dict(videos=count, frames=FRAMES, queries=QUERIES, chunk=CHUNK,
              resolution=RES, wall_s_total=wall, wall_s_per_video=wall / count,
              launches_per_video={k: v // count for k, v in launches.items()},
              visible_frac=[float(predictor.visibles(o).mean()) for o in outs],
              profile=profile_video(predictor, *videos[1], wall / count))


def main():
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)
  card = card_line()
  print(card, flush=True)
  t0 = time.perf_counter()
  built = _build.build_all()
  build_s = time.perf_counter() - t0
  print(f"built {built} in {build_s:.1f} s", flush=True)

  checks = check_kernels()
  print(json.dumps({"kernel_checks": checks}), flush=True)

  params = load_tapir_checkpoint(CHECKPOINT)
  golden = golden_check(params)
  print(json.dumps({"golden": golden}), flush=True)
  served = serve(params)
  print(json.dumps({"serve": served, "card": card}), flush=True)

  # One row per kernel: bf16 (the served precision), per launch at the
  # served shapes, with the served path's launches per video. launches * ms
  # should come near the profile's time for the kernel in one request.
  layer_of = {"corr_tents": "K1 corr_tents", "mixer_block": "K3 mixer_block"}
  kernels = []
  for name in ("corr_tents", "mixer_block"):
    row = next(c for c in checks if c["kernel"] == name
               and c["dtype"] == "bfloat16" and c.get("path"))
    kernels.append(dict(
        name=name, route="cuda", **KERNEL_META[name],
        launches=served["launches_per_video"][name],
        max_abs_err=row["max_abs_err"],
        max_err_over_limit=row["max_err_over_limit"], tol=row["tol"],
        ms=row["ms"], kernel_ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
        shape=row["shape"], dtype="bfloat16",
        profile_ms_per_video=served["profile"]["by_layer_ms"][layer_of[name]],
    ))
  print(card)
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  main()

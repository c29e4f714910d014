"""Device-trace analysis: self-time attribution of profiler traces (port of
tapnet_tpu/utils/trace_analysis.py).

  with profiling.trace("/tmp/trace"):   # utils/profiling.py
      predictor(video, query_points)
  python -m tapnet_tpu_torch.utils.trace_analysis /tmp/trace

or programmatically `component_budget(trace_path, classifier)`. Two views:

  * self_times: exclusive per-name totals over the device tracks, parents
    minus their children (containment by start and end per (pid, tid)
    track), so the numbers add up to device busy time instead of counting
    nesting twice.
  * component_budget: events grouped by model component through a
    classifier (`default_classifier` knows the port's kernels and TAPIR's
    scopes).

Device tracks are the processes a trace labels "GPU <n>" (PyTorch's
profiler names each process "python3" and gives it `process_labels` "CPU"
or "GPU <n>", as `chip_smoke.py`'s profile-480 reads off the card) or, as
in the JAX package, names with "TPU" or "/device". Kineto marks each
`torch.profiler.record_function` range on the device track as a
`gpu_user_annotation` event spanning its kernels; `models.tapir` runs each
of its methods in one such range, and a kernel's enclosing ranges, outermost
first and joined by "/", become its `args["scope"]`, the counterpart of the
JAX traces' `tf_op`. The annotations themselves are containers, never a
component. A JAX trace goes through both packages alike.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

_CONTAINER_PREFIXES = ("jit_", "while")
ANNOTATION = "gpu_user_annotation"
# Kernel-name patterns of the port's own kernels, by component (the JAX
# package's names for them): the corr-tents kernels and the per-position
# grid quantizer (K1, K2, K2b, Q), the mixer block (K3, K4, and the float32
# weights' split), the per-pixel and float ExtraConvs layers (K6, K6f), the
# per-frame int8 convolution (X) and the linear scan (K5, K5b).
KERNELS = (
    ("corr_kernel", re.compile(r"\bcorr_(tents|quantize)")),
    ("mixer_kernel", re.compile(r"\bmixer_|\bsplit_tf32\b")),
    ("extra_convs_kernel", re.compile(
        r"\bk6_|\bln_bias_(rows|slab)\b|\bpatch_scale\b"
        r"|\bconv3x3_(bf16|tf32x3)")),
    ("extra_convs_int8", re.compile(
        r"\bconv3x3_q8|\bframe_amax\b|\bquantize_frames\b")),
    ("rglru_scan_kernel", re.compile(r"\blinear_scan")),
)


def _load_events(trace_path: str) -> List[dict]:
  """Loads traceEvents from a trace dir (the newest *.trace.json.gz in it
  or below) or a .trace.json.gz file."""
  path = trace_path
  if os.path.isdir(path):
    matches = sorted(
        glob.glob(
            os.path.join(path, "**", "*.trace.json.gz"), recursive=True
        )
    )
    if not matches:
      raise FileNotFoundError(f"no *.trace.json.gz under {trace_path}")
    path = matches[-1]
  with gzip.open(path, "rt") as f:
    return json.load(f)["traceEvents"]


def is_device_track(name: str) -> bool:
  """Whether a trace process of this name (`track_names`) runs on a
  device."""
  return (re.fullmatch(r"GPU \d+", name) is not None
          or (("TPU" in name or "/device" in name.lower())
              and "#Chip" not in name))


def track_names(events) -> Dict[object, str]:
  """{pid: name} of the trace's processes: a process's `process_labels`
  where it has one (PyTorch's profiler names every process after the
  program, "python3", and labels them "CPU" and "GPU <n>"), else its
  `process_name` (JAX's traces)."""
  names, labels = {}, {}
  for e in events:
    if e.get("ph") == "M" and e.get("name") == "process_name":
      names[e["pid"]] = e["args"].get("name", "")
    elif e.get("ph") == "M" and e.get("name") == "process_labels":
      labels[e["pid"]] = e["args"].get("labels", "")
  names.update(labels)
  return names


def _device_pids(events) -> set:
  return {pid for pid, name in track_names(events).items()
          if is_device_track(name)}


def _device_events(events) -> List[dict]:
  """The complete ("X") events of the device tracks, each kernel with the
  `scope` of its enclosing annotations."""
  pids = _device_pids(events)
  evs = [e for e in events if e.get("ph") == "X" and e.get("pid") in pids]
  by_pid = collections.defaultdict(list)
  for e in evs:
    if e.get("cat") == ANNOTATION:
      by_pid[e["pid"]].append(e)
  out = []
  for e in evs:
    notes = by_pid.get(e["pid"])
    if notes and e.get("cat") != ANNOTATION:
      ts, end = e["ts"], e["ts"] + e.get("dur", 0)
      around = [a for a in notes
                if a["ts"] <= ts and end <= a["ts"] + a.get("dur", 0)]
      if around:
        around.sort(key=lambda a: (a["ts"], -a.get("dur", 0)))
        e = dict(e, args=dict(e.get("args", {}), scope="/".join(
            a["name"] for a in around)))
    out.append(e)
  return out


def self_times(trace_path: str) -> Dict[str, Tuple[float, int]]:
  """{op base name: (exclusive seconds, count)} over device tracks (the
  annotations, which span idle time between their kernels, left out)."""
  by_track = collections.defaultdict(list)
  for e in _device_events(_load_events(trace_path)):
    if e.get("cat") != ANNOTATION:
      by_track[(e["pid"], e.get("tid"))].append(e)

  out: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
  for evs in by_track.values():
    evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
    stack: List[Tuple[float, float, str]] = []
    for e in evs:
      ts, dur = e["ts"], e.get("dur", 0)
      while stack and ts >= stack[-1][0] + stack[-1][1]:
        stack.pop()
      name = re.sub(r"\.[0-9]+$", "", e.get("name", ""))
      name = re.sub(r"_[0-9]+$", "", name)
      if stack:
        out[stack[-1][2]][0] -= dur / 1e6
      out[name][0] += dur / 1e6
      out[name][1] += 1
      stack.append((ts, dur, name))
  return {k: (v[0], v[1]) for k, v in out.items() if v[0] > 0}


def default_classifier(e: dict) -> Optional[str]:
  """Maps a device trace event to a component (None = container): the JAX
  package's rules on `source` / `tf_op`, the port's kernels by name, and
  TAPIR's scopes (`tf_op`, or the annotations' `scope`)."""
  name = e.get("name", "")
  if name.startswith(_CONTAINER_PREFIXES) or e.get("cat") == ANNOTATION:
    return None
  args = e.get("args", {})
  src = args.get("source", "")
  top = args.get("tf_op", "") or args.get("scope", "")
  if "fused_mixer_block" in src:
    return "mixer_kernel"
  if "corr_tents" in src:
    return "corr_kernel"
  if "fused_extra_convs" in src:
    return "extra_convs_kernel"
  if "qconv" in src:
    return "extra_convs_int8"
  if "scan.py" in src:
    return "rglru_scan_kernel"
  for component, pattern in KERNELS:
    if pattern.search(name):
      return component
  if "cost_volume_head" in top:
    return "stage1_heads"
  if "_backbone_features" in top or "resnet" in src.lower():
    return "backbone"
  if "get_feature_grids" in top:
    return "featuregrid_misc"
  if "_refine_pips" in top or "_corr_patches" in top:
    return "refine_misc"
  if "get_query_features" in top:
    return "query_features"
  if "estimate_trajectories" in top:
    return "traj_misc"
  if "ssm_block" in top or "rglru" in src:
    return "ssm"
  return "other"


def component_budget(
    trace_path: str,
    classifier: Callable[[dict], Optional[str]] = default_classifier,
) -> Dict[str, Tuple[float, int]]:
  """{component: (inclusive seconds, count)} over device tracks.

  Inclusive per classified event (containers return None and are skipped),
  so with a classifier whose classes don't nest, totals match busy time.
  """
  out: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
  for e in _device_events(_load_events(trace_path)):
    c = classifier(e)
    if c is None:
      continue
    out[c][0] += e.get("dur", 0) / 1e6
    out[c][1] += 1
  return {k: (v[0], v[1]) for k, v in out.items()}


def format_table(table: Dict[str, Tuple[float, int]], top: int = 25) -> str:
  """The CLI's table: total, then one line per entry, largest first."""
  total = sum(t for t, _ in table.values())
  lines = [f"total classified device time: {total:.3f}s"]
  for name, (t, n) in sorted(table.items(), key=lambda kv: -kv[1][0])[:top]:
    lines.append(
        f"{t:8.3f}s {100 * t / max(total, 1e-12):5.1f}% x{n:<7} {name}")
  return "\n".join(lines)


def main(argv=None) -> None:
  import argparse

  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("trace", help="trace dir or .trace.json.gz")
  parser.add_argument("--raw", action="store_true",
                      help="per-op self times instead of components")
  parser.add_argument("--top", type=int, default=25)
  args = parser.parse_args(argv)

  table = (
      self_times(args.trace) if args.raw else component_budget(args.trace)
  )
  print(format_table(table, args.top))


if __name__ == "__main__":
  main()

"""The device trace of a `--trace 1` window: `torch.profiler` over the
window, read into device intervals, the window's own range and the program's
`record_function` scopes.

Busy time is the union of the device's operation intervals (kernels, copies,
sets) inside the window, so overlapping kernels count once. The program's
`record_function` ranges show on the device track as `gpu_user_annotation`
events spanning their kernels; they are never counted as busy. A kernel
belongs to a scope when its interval lies inside one of that scope's
ranges, whatever its name (the benchmark's own copy of the classification
of `tapnet_tpu_torch/utils/trace_analysis.py`).
"""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

WINDOW_SCOPE = "tapbench.window"
_BUSY = ("kernel", "gpu_memcpy", "gpu_memset")
_ANNOTATION = "gpu_user_annotation"


class Event:
  __slots__ = ("cat", "name", "start", "end")

  def __init__(self, cat: str, name: str, start: float, end: float):
    self.cat, self.name, self.start, self.end = cat, name, start, end


def _category(e) -> str:
  """A kineto event's category, as the chrome trace names it: from its
  device, whether it is a `record_function` range, and its name."""
  on_device = str(e.device_type()).upper().endswith("CUDA")
  if e.is_user_annotation():
    return _ANNOTATION if on_device else "user_annotation"
  if not on_device:
    return "cpu_op"
  name = e.name()
  if name.startswith("Memcpy"):
    return "gpu_memcpy"
  return "gpu_memset" if name.startswith("Memset") else "kernel"


def _from_kineto(prof) -> Optional[List[Event]]:
  """The events of the kineto results, or None where this PyTorch's events
  lack what `_category` reads."""
  results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
  if results is None:
    return None
  out = []
  for e in results.events():
    if not (hasattr(e, "device_type") and hasattr(e, "is_user_annotation")):
      return None
    start = e.start_ns() / 1e9
    out.append(Event(_category(e), e.name(), start,
                     start + e.duration_ns() / 1e9))
  return out


class Trace:
  """Device intervals of one traced window."""

  def __init__(self, events: Sequence[Event]):
    windows = [e for e in events if e.name == WINDOW_SCOPE
               and e.cat in ("user_annotation", "cpu_op")]
    if not windows:
      raise RuntimeError("the trace holds no window range")
    w = max(windows, key=lambda e: e.end - e.start)
    self.start, self.end = w.start, w.end
    inside = lambda e: e.end > self.start and e.start < self.end
    self.device = sorted((e for e in events if e.cat in _BUSY and inside(e)),
                         key=lambda e: e.start)
    self.annotations = collections.defaultdict(list)
    for e in events:
      if e.cat == _ANNOTATION and inside(e):
        self.annotations[e.name].append((e.start, e.end))
    self.host = sorted((e for e in events if e.cat in ("cpu_op", "cuda_runtime")
                        and inside(e)), key=lambda e: e.start)

  @property
  def window_s(self) -> float:
    return self.end - self.start

  def _clip(self, e: Event) -> Tuple[float, float]:
    return max(e.start, self.start), min(e.end, self.end)

  def busy_intervals(self) -> List[Tuple[float, float]]:
    """The union of the device's operation intervals in the window."""
    merged: List[List[float]] = []
    for e in self.device:
      s, t = self._clip(e)
      if t <= s:
        continue
      if merged and s <= merged[-1][1]:
        merged[-1][1] = max(merged[-1][1], t)
      else:
        merged.append([s, t])
    return [(s, t) for s, t in merged]

  def busy_s(self) -> float:
    return sum(t - s for s, t in self.busy_intervals())

  def kernel_s(self, pattern: str) -> float:
    """Device seconds of the kernels whose names match `pattern`."""
    rx = re.compile(pattern)
    return sum(e.end - e.start for e in self.device
               if e.cat == "kernel" and rx.search(e.name))

  def scope_s(self, scope: str) -> float:
    """Device seconds of the operations inside a range of `scope`."""
    ranges = sorted(self.annotations.get(scope, ()))
    if not ranges:
      return 0.0
    starts = [s for s, _ in ranges]
    total = 0.0
    for e in self.device:
      i = bisect.bisect_right(starts, e.start) - 1
      if i >= 0 and e.end <= ranges[i][1]:
        total += e.end - e.start
    return total

  def top_ops(self, count: int = 10) -> List[List]:
    """[[name, seconds], ...]: the device operations that took most time."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in self.device:
      by_name[e.name] += e.end - e.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
    return [[name[:120], s] for name, s in top]

  def idle_gaps(self, count: int = 10) -> List[List]:
    """[[what the host was doing, seconds], ...]: the longest gaps between
    the device's operations, each named by the host call under way at its
    middle."""
    gaps = []
    last = self.start
    for s, t in self.busy_intervals() + [(self.end, self.end)]:
      if s > last:
        gaps.append((s - last, last, s))
      last = max(last, t)
    gaps.sort(reverse=True)
    starts = [e.start for e in self.host]
    out = []
    for length, s, t in gaps[:count]:
      mid = (s + t) / 2
      i = bisect.bisect_right(starts, mid) - 1
      name = "host"
      for j in range(i, max(i - 200, -1), -1):
        if self.host[j].end >= mid:  # the innermost call under way
          name = self.host[j].name
          break
      out.append([name[:120], length])
    return out


class Profiler:
  """`torch.profiler` over the window, CPU and CUDA activity."""

  def __init__(self):
    from torch.profiler import ProfilerActivity, profile  # pylint: disable=import-outside-toplevel
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
      activities.append(ProfilerActivity.CUDA)
    self._prof = profile(activities=activities)

  def __enter__(self):
    self._prof.__enter__()
    return self

  def __exit__(self, *exc):
    self._prof.__exit__(*exc)
    return False

  def trace(self) -> Trace:
    events = _from_kineto(self._prof)
    if events is None:
      raise RuntimeError("this PyTorch's profiler events carry no device type "
                         "or annotation flag")
    return Trace(events)

"""Profiling and timing utilities (port of tapnet_tpu/utils/profiling.py).

  * `trace(log_dir)`: a `torch.profiler` trace (CPU and, where there is a
    card, CUDA activity) of the enclosed block, written on exit as
    `<worker>.<time>.pt.trace.json.gz` under `log_dir`
    (`tensorboard_trace_handler`), which `utils.trace_analysis` reads, as
    do TensorBoard's profiler plugin and Perfetto.
  * `StageTimer`: named per-stage wall timers that wait for the device.
  * `benchmark(fn, *args)` / `benchmark_stats`: seconds per call of
    `fn(*args)`: on a CUDA card between CUDA events around
    `iters_per_measure` calls, on the CPU by `time.perf_counter`, after
    `warmup` calls. Eager PyTorch neither hoists a call's work out of a
    loop nor drops work whose result is unused, so the calls are timed as
    they are: the JAX version's input perturbation and output reduction,
    which keep XLA from doing either inside its compiled loop, have no
    counterpart here.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List

import torch


@contextlib.contextmanager
def trace(log_dir: str):
  """Captures a torch.profiler trace of the enclosed block into `log_dir`
  (a gzipped Chrome trace, `*.pt.trace.json.gz`); CUDA activity is traced
  where a card is present."""
  from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
    torch.cuda.synchronize()
  with profile(activities=activities,
               on_trace_ready=tensorboard_trace_handler(log_dir,
                                                        use_gzip=True)):
    yield
    if torch.cuda.is_available():
      torch.cuda.synchronize()


def _cuda_devices(value: Any) -> List[torch.device]:
  """The CUDA devices of the tensors in `value` (a tensor, or lists,
  tuples and dicts of them), in the order first met."""
  devices: List[torch.device] = []
  if isinstance(value, torch.Tensor):
    if value.is_cuda:
      devices.append(value.device)
  elif isinstance(value, (dict, list, tuple)):
    for v in (value.values() if isinstance(value, dict) else value):
      devices += [d for d in _cuda_devices(v) if d not in devices]
  return devices


class StageTimer:
  """Accumulates wall time per named stage (device-synced)."""

  def __init__(self):
    self.totals: Dict[str, float] = {}
    self.counts: Dict[str, int] = {}

  @contextlib.contextmanager
  def stage(self, name: str, sync_value=None):
    """Times the enclosed block; with `sync_value`, until the devices that
    hold its tensors have finished."""
    t0 = time.perf_counter()
    try:
      yield
    finally:
      for device in _cuda_devices(sync_value):
        torch.cuda.synchronize(device)
      dt = time.perf_counter() - t0
      self.totals[name] = self.totals.get(name, 0.0) + dt
      self.counts[name] = self.counts.get(name, 0) + 1

  def summary(self) -> Dict[str, float]:
    return {
        name: self.totals[name] / max(self.counts[name], 1)
        for name in self.totals
    }

  def report(self) -> str:
    lines = []
    for name, mean in sorted(self.summary().items()):
      lines.append(
          f"{name}: {mean * 1000:.2f} ms/call x{self.counts[name]}"
      )
    return "\n".join(lines)


def _benchmark_times(
    fn: Callable,
    *args,
    iters_per_measure: int = 10,
    num_measures: int = 3,
    warmup: int = 1,
) -> List[float]:
  """Seconds per call of `fn(*args)`, one value per measure: `warmup`
  calls, then `num_measures` times `iters_per_measure` calls. With a CUDA
  tensor among `args`, each measure lies between two CUDA events on that
  device's current stream; else it is the host's `perf_counter` around the
  calls."""
  devices = _cuda_devices(args)
  for _ in range(warmup):
    fn(*args)
  times = []
  if not devices:
    for _ in range(num_measures):
      t0 = time.perf_counter()
      for _ in range(iters_per_measure):
        fn(*args)
      times.append((time.perf_counter() - t0) / iters_per_measure)
    return times
  with torch.cuda.device(devices[0]):
    torch.cuda.synchronize()
    for _ in range(num_measures):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(iters_per_measure):
        fn(*args)
      end.record()
      end.synchronize()
      times.append(start.elapsed_time(end) / 1e3 / iters_per_measure)
  return times


def benchmark(
    fn: Callable,
    *args,
    iters_per_measure: int = 10,
    num_measures: int = 3,
    warmup: int = 1,
) -> float:
  """Returns min seconds per call of `fn(*args)`. See `_benchmark_times`."""
  return min(
      _benchmark_times(
          fn,
          *args,
          iters_per_measure=iters_per_measure,
          num_measures=num_measures,
          warmup=warmup,
      )
  )


def benchmark_stats(
    fn: Callable,
    *args,
    iters_per_measure: int = 10,
    num_measures: int = 3,
    warmup: int = 1,
) -> Dict[str, Any]:
  """Like `benchmark` but returns {"min", "median", "reps": [...]} seconds
  per call, so that drift between runs can be told from noise."""
  times = _benchmark_times(
      fn,
      *args,
      iters_per_measure=iters_per_measure,
      num_measures=num_measures,
      warmup=warmup,
  )
  ordered = sorted(times)
  return {
      "min": ordered[0],
      "median": ordered[len(ordered) // 2],
      "reps": [round(t, 6) for t in times],
  }

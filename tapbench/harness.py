"""One run of one cell: find its files by name, set up the system under
test, warm it up, measure the window (traced or not), read the metrics,
free the program, judge its answers against the plain reference, and make
the result line.

Everything particular to a configuration, a traffic mix or a metric is in a
file of its own, found by the names in BENCHMARK.json:

  cells/<workload>.json     traffic parameters, the loop, the program's
                            options, the reference's sample and the limits
  configs/<config>.json     the configuration's sizes, source and family
  families/<family>.py      builds the system, counts FLOPs and bounds,
                            runs the reference
  loops/<loop>.py           warm-up and the measured window
  metrics/<metric>.py       one reader per metric, `read(ctx)`

The run imports neither JAX nor the JAX package: `forbidden_modules` looks
for them by whole top-level name after the warm-up and again before the
result is printed.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

import judge
import device_trace as trace_lib
from traffic import Traffic
from window import Window

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tapnet_tpu")


class Forbidden(RuntimeError):
  pass


def forbidden_modules() -> List[str]:
  """Top-level names of loaded modules that a run may not hold, compared
  whole (`tapnet_tpu_torch` is not `tapnet_tpu`)."""
  return sorted({name.split(".")[0] for name in list(sys.modules)}
                & set(FORBIDDEN))


def check_modules(when: str) -> None:
  bad = forbidden_modules()
  if bad:
    raise Forbidden(f"{when}: the process holds {', '.join(bad)}")


def load_json(*parts: str) -> Dict:
  with open(os.path.join(*parts)) as f:
    return json.load(f)


def load_module(kind: str, name: str):
  """`<kind>/<name>.py` under the benchmark's folder, by path (a name may
  hold dots)."""
  path = os.path.join(HERE, kind, name + ".py")
  if not os.path.isfile(path):
    raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
  spec = importlib.util.spec_from_file_location(f"tapbench_{kind}_{name}", path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _merge(base: Dict, over: Optional[Dict]) -> Dict:
  out = dict(base)
  for k, v in (over or {}).items():
    out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
        out.get(k), dict) else v
  return out


@dataclasses.dataclass
class Cell:
  name: str
  workload: Dict
  cell: Dict
  config: Dict
  end_to_end: List[Dict]
  per_layer: List[Dict]


def load_cell(name: str, cell_override: Optional[Dict] = None,
              model_override: Optional[Dict] = None) -> Cell:
  """The workload `name` of BENCHMARK.json with its cell and configuration
  files; the overrides (CPU rehearsals only) replace fields of the cell and
  of the configuration's model."""
  spec = load_json(REPO, "BENCHMARK.json")
  found = [w for w in spec["workloads"] if w["name"] == name]
  if not found:
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")
  wl = found[0]
  cell = _merge(load_json(HERE, "cells", f"{name}.json"), cell_override)
  if (cell["config"], cell["traffic_name"]) != (wl["config"], wl["traffic"]):
    raise ValueError(f"{name}: the cell file names {cell['config']}/"
                     f"{cell['traffic_name']}, BENCHMARK.json "
                     f"{wl['config']}/{wl['traffic']}")
  config = load_json(HERE, "configs", f"{wl['config']}.json")
  if model_override:
    config = dict(config, model=dict(config["model"], **model_override))
  applies = lambda m: name in m.get("workloads", [name])
  return Cell(name, wl, cell, config,
              [m for m in spec["end_to_end"] if applies(m)],
              [m for m in spec["per_layer"] if applies(m)])


@dataclasses.dataclass
class Reading:
  """What a metric reader reads."""
  setup_s: float
  window: Window
  trace: Optional[trace_lib.Trace]
  flops: float
  bounds: Optional[Dict[str, float]]
  window_peak_bytes: int


def _sync(device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def run(name: str, seed: int, seconds: float, traced: bool, device,
        started: float, control: bool = False,
        cell_override: Optional[Dict] = None,
        model_override: Optional[Dict] = None) -> Dict[str, Any]:
  """One run; returns the result line's fields. `started` is the host
  clock at process start (set-up is measured from it); `control` puts the
  family's control in the program's place."""
  device = torch.device(device)
  c = load_cell(name, cell_override, model_override)
  family = load_module("families", c.config["family"])
  loop = load_module("loops", c.cell["loop"])
  cuda = device.type == "cuda"

  system = family.System(c.config, c.cell, seed, device, control)
  traffic = Traffic(c.cell["traffic"], seed, device)
  first = loop.warm_up(system, traffic)
  _sync(device)
  check_modules("after the warm-up")
  setup_s = time.perf_counter() - started
  setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
  if cuda:
    torch.cuda.reset_peak_memory_stats(device)

  tr = None
  if traced:
    with trace_lib.Profiler() as prof:
      with torch.profiler.record_function(trace_lib.WINDOW_SCOPE):
        win = loop.run(system, traffic, seconds, first)
        _sync(device)
    tr = prof.trace()
  else:
    win = loop.run(system, traffic, seconds, first)
  window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

  ctx = Reading(
      setup_s=setup_s, window=win, trace=tr,
      flops=system.request_flops(traffic.params) * win.completed,
      bounds=(system.bounds(win.outputs[-win.completed:], traffic.params)
              if traced else None),
      window_peak_bytes=window_peak)
  metrics = {}
  for m in (c.per_layer if traced else c.end_to_end):
    value = load_module("metrics", m["name"]).read(ctx)
    if value is not None:
      metrics[m["name"]] = {"value": value, "unit": m["unit"]}

  system.release()
  gc.collect()
  if cuda:
    torch.cuda.empty_cache()
  judged = time.perf_counter()
  stats = system.compare(win, traffic, seed)
  judged = time.perf_counter() - judged
  correct, shown = judge.verdict(stats, c.cell["limits"])
  check_modules("after the window")

  dev = {"platform": "gpu" if cuda else device.type,
         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
         "count": c.workload["chips"],
         "memory_peak_bytes": max(setup_peak, window_peak)}
  result: Dict[str, Any] = {
      "correct": correct, "attempted": win.completed, "failed": 0,
      "metrics": metrics, "device": dev}
  if tr is not None:
    dev["busy_s"] = tr.busy_s()
    dev["window_s"] = tr.window_s
    result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
  result["phases"] = {"setup_s": setup_s, "window_s": win.seconds,
                      "reference_s": judged}
  result["stats"] = stats
  result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in shown.items()}
  return result

"""PyTorch port, profiling (utils/profiling.py) and trace analysis
(utils/trace_analysis.py) against the JAX package's: one synthetic trace
through both analyses, a trace shaped as PyTorch's profiler writes it on a
card (GPU track, annotation ranges, the port's kernel names), a real CPU
trace from `profiling.trace`, and the timers' shapes and text.
"""

import gzip
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.utils import profiling as jax_profiling  # noqa: E402
from tapnet_tpu.utils import trace_analysis as jax_trace_analysis  # noqa: E402
from tapnet_tpu_torch.utils import profiling, trace_analysis  # noqa: E402


def _write(path, meta, events):
  with gzip.open(path, "wt") as f:
    json.dump({"traceEvents": meta + events}, f)
  return str(path)


def _ev(name, ts, dur, pid=1, tid=0, cat=None, **args):
  e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid,
       "args": args}
  if cat:
    e["cat"] = cat
  return e


def _process(pid, name):
  return {"ph": "M", "name": "process_name", "pid": pid,
          "args": {"name": name}}


def _labels(pid, labels):
  return {"ph": "M", "name": "process_labels", "pid": pid,
          "args": {"labels": labels}}


# The metadata PyTorch's profiler writes on the card (read there by
# chip_smoke.py's profile-480, torch 2.11): every process named after the
# program, the host labelled "CPU", a "GPU <n>" process for each device
# number whether or not it ran anything.
KINETO_META = ([_process(4242, "python3"), _labels(4242, "CPU")]
               + [m for gpu in range(8)
                  for m in (_process(gpu, "python3"), _labels(gpu, f"GPU {gpu}"))])


def test_jax_trace_gives_equal_tables(tmp_path):
  """A JAX-shaped trace (device and host tracks, nesting, sources and
  scopes, numbered names) gives equal self times and budgets in both
  packages."""
  path = _write(tmp_path / "vm.trace.json.gz",
                [_process(1, "/device:TPU:0"), _process(2, "/device:TPU:1"),
                 _process(9, "python host"), _process(7, "TPU:0 #Chip")], [
      _ev("jit_forward(1)", 0, 1000),
      _ev("while.3", 10, 700),
      _ev("branch_0_fun.2", 20, 100,
          source="/x/tapnet_tpu/ops/fused_mixer_block.py"),
      _ev("branch_0_fun.3", 200, 50, source="/x/tapnet_tpu/ops/corr_tents.py"),
      _ev("fusion.12", 300, 40, source="/x/tapnet_tpu/ops/qconv.py"),
      _ev("convolution.1", 400, 30,
          tf_op="jit(forward)/TAPIR/TAPIR._backbone_features/conv:"),
      _ev("fusion.4", 450, 20,
          tf_op="jit(forward)/TAPIR/cost_volume_head/pos_conv:"),
      _ev("fusion_7", 480, 10, tf_op="jit(forward)/TAPIR/_refine_pips/add"),
      _ev("fusion.5", 800, 10),
      _ev("copy.1", 0, 60, pid=2, source="/x/tapnet_tpu/ops/scan.py"),
      _ev("hostwork", 0, 5000, pid=9),
      _ev("chipwork", 0, 5000, pid=7),
  ])
  assert trace_analysis.self_times(path) == jax_trace_analysis.self_times(path)
  ours = trace_analysis.component_budget(path)
  assert ours == jax_trace_analysis.component_budget(path)
  assert set(ours) == {"mixer_kernel", "corr_kernel", "extra_convs_int8",
                       "backbone", "stage1_heads", "refine_misc", "other",
                       "rglru_scan_kernel"}


def test_kineto_trace_classes(tmp_path):
  """A trace as PyTorch's profiler writes it on a card: the port's kernels
  by name, other kernels by the annotation ranges around them (outermost
  first), the annotations never counted, the host track left out."""
  gpu, host = 0, 4242
  ann = "gpu_user_annotation"
  path = _write(tmp_path / "host.123.pt.trace.json.gz", KINETO_META, [
      _ev("get_feature_grids", 0, 400, gpu, 7, ann),
      _ev("_backbone_features", 0, 300, gpu, 7, ann),
      _ev("void cudnn::fprop_kernel<float>(...)", 10, 100, gpu, 7, "kernel"),
      _ev("void (anonymous namespace)::conv3x3_bf16_tma(CUtensorMap_st)",
          120, 50, gpu, 7, "kernel"),
      _ev("void at::native::vectorized_elementwise_kernel<4>(...)", 320, 20,
          gpu, 7, "kernel"),
      _ev("estimate_trajectories", 500, 600, gpu, 7, ann),
      _ev("cost_volume_head", 500, 100, gpu, 7, ann),
      _ev("void cutlass::Kernel<sm90_gemm>(...)", 510, 40, gpu, 7, "kernel"),
      _ev("_refine_pips", 700, 300, gpu, 7, ann),
      _ev("_corr_patches", 700, 100, gpu, 7, ann),
      _ev("void (anonymous namespace)::corr_tents_kernel<__nv_bfloat16>"
          "(float const*)", 710, 30, gpu, 7, "kernel"),
      _ev("void (anonymous namespace)::mixer_gemm_tma<0, float>(...)", 810,
          60, gpu, 7, "kernel"),
      _ev("void (anonymous namespace)::mixer_temporal<float>(...)", 880, 10,
          gpu, 7, "kernel"),
      _ev("void at::native::reduce_kernel<512>(...)", 900, 5, gpu, 7,
          "kernel"),
      _ev("Memcpy DtoH (Device -> Pageable)", 1200, 8, gpu, 7, "gpu_memcpy"),
      _ev("void (anonymous namespace)::k6_conv_up(UpParams)", 1300, 9, gpu,
          8, "kernel"),
      _ev("void (anonymous namespace)::conv3x3_q8_tma(CUtensorMap_st)", 1310,
          3, gpu, 8, "kernel"),
      _ev("void (anonymous namespace)::linear_scan_kernel<float>(...)", 1320,
          4, gpu, 8, "kernel"),
      _ev("cudaLaunchKernel", 700, 5, host, 1, "cuda_runtime"),
      _ev("_refine_pips", 700, 5, host, 1, "user_annotation"),
      _ev("Activity Buffer Request", 0, 50, -1, 0, "overhead"),
      _ev("PyTorch Profiler (0)", 0, 5000, "Spans", "PyTorch Profiler",
          "Trace"),
  ])
  table = trace_analysis.component_budget(path)
  expected = {
      "backbone": (100, 1), "extra_convs_kernel": (59, 2),
      "featuregrid_misc": (20, 1), "stage1_heads": (40, 1),
      "corr_kernel": (30, 1), "mixer_kernel": (70, 2), "refine_misc": (5, 1),
      "other": (8, 1), "extra_convs_int8": (3, 1),
      "rglru_scan_kernel": (4, 1),
  }
  assert set(table) == set(expected)
  for key, (us, count) in expected.items():
    assert table[key][1] == count, key
    assert abs(table[key][0] - us / 1e6) < 1e-12, key
  times = trace_analysis.self_times(path)
  assert "get_feature_grids" not in times and "cudaLaunchKernel" not in times
  assert abs(sum(t for t, _ in times.values())
             - sum(t for t, _ in table.values())) < 1e-12
  # The JAX package reads no GPU track.
  assert not jax_trace_analysis.component_budget(path)


def test_device_tracks():
  names = trace_analysis.track_names(KINETO_META + [_process(9, "/device:TPU:0")])
  assert names[4242] == "CPU" and names[0] == "GPU 0" and names[7] == "GPU 7"
  assert names[9] == "/device:TPU:0"
  assert trace_analysis.is_device_track("GPU 0")
  assert trace_analysis.is_device_track("GPU 12")
  assert trace_analysis.is_device_track("/device:TPU:0")
  assert not trace_analysis.is_device_track("python3")
  assert not trace_analysis.is_device_track("TPU:0 #Chip")
  assert not trace_analysis.is_device_track("GPU 0 stream 7")


def test_trace_writes_a_loadable_file(tmp_path, capsys):
  """`profiling.trace` on the CPU writes one *.pt.trace.json.gz that the
  analysis loads; its host events hold the record_function range."""
  log_dir = str(tmp_path / "trace")
  x = torch.randn(64, 64)
  with profiling.trace(log_dir):
    with torch.profiler.record_function("get_feature_grids"):
      (x @ x).sum()
  files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json.gz")]
  assert len(files) == 1, os.listdir(log_dir)
  events = trace_analysis._load_events(log_dir)  # pylint: disable=protected-access
  assert any(e.get("name") == "get_feature_grids" for e in events)
  # No card: no device track, an empty budget.
  assert trace_analysis.component_budget(log_dir) == {}
  trace_analysis.main([log_dir])
  assert "total classified device time: 0.000s" in capsys.readouterr().out


def test_benchmark_stats_shape():
  calls = []
  x = torch.randn(32, 32)
  stats = profiling.benchmark_stats(lambda a: calls.append(1) or a @ a, x,
                                    iters_per_measure=4, num_measures=3,
                                    warmup=2)
  ref = jax_profiling.benchmark_stats(lambda a: a @ a, jnp.ones((4, 4)),
                                      iters_per_measure=2, num_measures=3)
  assert set(stats) == set(ref) == {"min", "median", "reps"}
  assert len(stats["reps"]) == len(ref["reps"]) == 3
  assert len(calls) == 2 + 4 * 3
  assert 0 < stats["min"] <= stats["median"]
  assert stats["reps"] == [round(t, 6) for t in stats["reps"]]
  assert profiling.benchmark(lambda a: a + 1, x, num_measures=2) > 0


def test_stage_timer_report_matches_jax():
  ours, theirs = profiling.StageTimer(), jax_profiling.StageTimer()
  for timer in (ours, theirs):
    timer.totals = {"refine": 0.75, "features": 0.0123, "heads": 2.0}
    timer.counts = {"refine": 3, "features": 1, "heads": 8}
  assert ours.summary() == theirs.summary()
  assert ours.report() == theirs.report()
  with ours.stage("sync", sync_value=[torch.ones(2), {"a": torch.zeros(1)}]):
    np.zeros(4)
  assert ours.counts["sync"] == 1 and ours.totals["sync"] >= 0

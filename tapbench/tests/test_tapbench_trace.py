"""The trace reading on made-up events: the idle union with overlapping
kernels, scopes, gaps, and the per-layer readers on it."""

import pytest

import device_trace as dt
import harness
from window import Window


def _events():
  E = dt.Event
  return [
      E("user_annotation", dt.WINDOW_SCOPE, 0.0, 10.0),
      # Two kernels that overlap (1-3 and 2-4) count 1-4 once.
      E("kernel", "void ns::corr_tents_kernel<float>(x)", 1.0, 3.0),
      E("kernel", "ampere_sgemm", 2.0, 4.0),
      E("gpu_memcpy", "Memcpy DtoH", 5.0, 5.5),
      E("kernel", "void ns::mixer_temporal<float>(y)", 6.0, 7.0),
      E("kernel", "void ns::mixer_gemm_tma<float>(y)", 7.0, 8.0),
      # A kernel that starts before the window counts only inside it.
      E("kernel", "early", -1.0, 0.5),
      E("gpu_user_annotation", "_backbone_features", 1.0, 4.0),
      E("gpu_user_annotation", "_refine_pips", 6.0, 8.0),
      E("cpu_op", "aten::copy_", 4.0, 5.2),
      E("cuda_runtime", "cudaStreamSynchronize", 8.0, 10.0),
  ]


def test_busy_is_the_union_inside_the_window():
  tr = dt.Trace(_events())
  assert tr.window_s == 10.0
  assert tr.busy_intervals() == [(0.0, 0.5), (1.0, 4.0), (5.0, 5.5), (6.0, 8.0)]
  assert tr.busy_s() == pytest.approx(6.0)


def test_kernel_and_scope_seconds():
  tr = dt.Trace(_events())
  assert tr.kernel_s(r"\bcorr_(tents|quantize)") == 2.0
  assert tr.kernel_s(r"\bmixer_|\bsplit_tf32\b") == 2.0
  assert tr.scope_s("_backbone_features") == 4.0  # corr 2 + sgemm 2
  assert tr.scope_s("_refine_pips") == 2.0
  assert tr.scope_s("absent") == 0.0


def test_idle_gaps_named_by_the_host():
  tr = dt.Trace(_events())
  gaps = tr.idle_gaps()
  assert gaps[0] == ["cudaStreamSynchronize", 2.0]
  assert ["aten::copy_", 1.0] in gaps
  assert tr.top_ops(2)[0][1] == 2.0


def test_trace_without_window_is_refused():
  with pytest.raises(RuntimeError):
    dt.Trace([dt.Event("kernel", "k", 0.0, 1.0)])


def _ctx(trace, completed=2, bounds=None):
  win = Window()
  win.start, win.end = 0.0, 10.0
  win.completed = completed
  win.frames = 100
  return harness.Reading(setup_s=3.0, window=win, trace=trace,
                         flops=989e12 * 0.5, bounds=bounds,
                         window_peak_bytes=2**31)


def test_readers_on_a_made_up_trace():
  tr = dt.Trace(_events())
  ctx = _ctx(tr, bounds={"corr_tents": 0.5, "mixer_block": 1.0})
  read = lambda name: harness.load_module("metrics", name).read(ctx)
  assert read("device_idle.offline") == pytest.approx(40.0)
  assert read("device_idle.online") == pytest.approx(40.0)
  assert read("corr_tents_roofline") == pytest.approx(25.0)
  assert read("mixer_block_roofline") == pytest.approx(50.0)
  assert read("scan_roofline") is None  # no bound, no reading (never 0)
  assert read("tapir.backbone_ms") == pytest.approx(2000.0)
  assert read("tapir.refinement_ms") == pytest.approx(1000.0)
  assert read("mfu") == pytest.approx(5.0)
  assert read("peak_mem_gib") == pytest.approx(2.0)
  assert read("frames_per_s") == pytest.approx(10.0)
  assert read("setup_s") == 3.0


def test_untraced_readers_return_nothing():
  ctx = _ctx(None)
  for name in ("device_idle.offline", "corr_tents_roofline",
               "tapir.backbone_ms", "frame_ms_p95"):
    assert harness.load_module("metrics", name).read(ctx) is None


class _Kineto:
  """A kineto event as this PyTorch's profiler gives it."""

  def __init__(self, name, device, annotation, start_ns, dur_ns):
    self._v = (name, device, annotation, start_ns, dur_ns)

  def name(self):
    return self._v[0]

  def device_type(self):
    return "DeviceType." + self._v[1]

  def is_user_annotation(self):
    return self._v[2]

  def start_ns(self):
    return self._v[3]

  def duration_ns(self):
    return self._v[4]


def test_kineto_events_are_classified_by_device_and_name():
  class _Results:
    def events(self):
      return [_Kineto(dt.WINDOW_SCOPE, "CPU", True, 0, 10_000),
              _Kineto("cudaLaunchKernel", "CPU", False, 100, 50),
              _Kineto("void k(x)", "CUDA", False, 1000, 2000),
              _Kineto("Memcpy DtoH (Device -> Pageable)", "CUDA", False, 4000, 500),
              _Kineto("_refine_pips", "CUDA", True, 900, 3000)]

  class _Prof:
    profiler = type("P", (), {"kineto_results": _Results()})()

  events = dt._from_kineto(_Prof())
  assert [e.cat for e in events] == ["user_annotation", "cpu_op", "kernel",
                                     "gpu_memcpy", "gpu_user_annotation"]
  tr = dt.Trace(events)
  assert tr.busy_s() == pytest.approx(2.5e-6)
  assert tr.scope_s("_refine_pips") == pytest.approx(2e-6)

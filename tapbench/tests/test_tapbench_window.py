"""The end-to-end rate and tail over a window that holds a stall: the rate
takes all the work over all the time, the tail all the steps."""

import time

import pytest

import harness
from window import Window


class _Stalling:
  """A stream system whose every 10th step stalls 50 ms."""

  def __init__(self):
    self.n = 0

  def init(self, frames, qp):
    return ("init",)

  def step(self, frame):
    self.n += 1
    time.sleep(0.05 if self.n % 10 == 0 else 0.001)
    return ("step", self.n)


class _Traffic:
  params = {"frames": 5}

  def streams(self):
    import torch  # pylint: disable=import-outside-toplevel
    return torch.zeros(3, 5, 2, 2, 3), torch.zeros(3, 1, 3)

  def request(self, i):
    return i, i


def test_online_window_counts_every_step_and_its_tail():
  loop = harness.load_module("loops", "online")
  system = _Stalling()
  first = loop.warm_up(system, _Traffic())
  win = loop.run(system, _Traffic(), 0.6, first)
  assert win.outputs[0] == ("init",)
  steps = win.completed
  assert len(win.latencies_s) == steps and win.frames == 3 * steps
  ctx = harness.Reading(setup_s=0.0, window=win, trace=None, flops=0.0,
                        bounds=None, window_peak_bytes=0)
  p95 = harness.load_module("metrics", "frame_ms_p95").read(ctx)
  assert p95 >= 50.0  # a tenth of the steps stall: the tail sees them
  rate = harness.load_module("metrics", "frames_per_s").read(ctx)
  assert rate == pytest.approx(3 * steps / win.seconds)
  assert rate < 3 / 0.005  # the stalls count in the rate's time


class _Offline:
  def serve(self, requests):
    for i, (v, q) in enumerate(requests):
      time.sleep(0.2 if i == 2 else 0.01)
      yield {"id": v}


def test_offline_window_closes_on_the_last_answer():
  loop = harness.load_module("loops", "offline")
  win = loop.run(_Offline(), _Traffic(), 0.3)
  assert win.request_ids == list(range(win.completed))
  assert [o["id"] for o in win.outputs] == win.request_ids
  assert win.seconds >= 0.3 and win.frames == 5 * win.completed


def test_p95_nearest_rank():
  win = Window()
  win.latencies_s = [i / 1000 for i in range(1, 101)]
  ctx = harness.Reading(setup_s=0.0, window=win, trace=None, flops=0.0,
                        bounds=None, window_peak_bytes=0)
  assert harness.load_module("metrics", "frame_ms_p95").read(ctx) == 95.0

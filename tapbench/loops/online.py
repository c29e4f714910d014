"""Online closed loop: a batch of streams, one frame of each a step, the
next step sent when the last step's tracks are on the host (a live loop
that takes the newest frame). `init` on each stream's first frame with its
queries runs at set-up; every step after it is in the window, and each
step's latency runs from the frame handed to `step` to its tracks on the
host. A stream loops over its frames."""

from __future__ import annotations

import time

from window import Window

WARM_STEPS = 3


def warm_up(system, traffic):
  """`init` and a few steps of the cell's own shapes, then `init` again for
  the window's streams; returns that `init`'s answer."""
  frames, qp = traffic.streams()
  system.init(frames[:, :1], qp)
  for t in range(1, WARM_STEPS + 1):
    system.step(frames[:, t % frames.shape[1]])
  return system.init(frames[:, :1], qp)


def run(system, traffic, seconds: float, first) -> Window:
  """The window's steps; its answers start with `first`, the answer of
  the streams' `init`."""
  frames, _ = traffic.streams()
  streams, loop_len = frames.shape[0], frames.shape[1]
  win = Window()
  win.outputs.append(first)
  win.open()
  t = 1
  while time.perf_counter() - win.start < seconds:
    begin = time.perf_counter()
    out = system.step(frames[:, t % loop_len])
    win.latencies_s.append(time.perf_counter() - begin)
    win.done(out, streams)
    t += 1
  win.close()
  return win

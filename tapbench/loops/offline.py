"""Offline closed loop: one request after another, each a whole video with
its query points, through the family's `serve` (for TAPIR `track_many`,
which dispatches one request ahead of the answer it hands back). A request
is sent while the window's time lasts; the window closes when the last
answer is on the host, and every frame of every request counts."""

from __future__ import annotations

import time

from window import Window


def warm_up(system, traffic) -> None:
  """One request of the cell's own shapes."""
  for _ in system.serve([traffic.request(0)]):
    pass


def run(system, traffic, seconds: float, first=None) -> Window:
  del first  # nothing runs before the window
  win = Window()
  frames = traffic.params["frames"]

  def requests():
    i = 0
    while time.perf_counter() - win.start < seconds:
      win.request_ids.append(i)
      yield traffic.request(i)
      i += 1

  win.open()
  for out in system.serve(requests()):
    win.done(out, frames)
  win.close()
  return win

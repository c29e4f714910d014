"""What a measured window leaves behind: its host-clock span, the answers
in the order they came back, the frames they tracked, and each online
step's latency."""

from __future__ import annotations

import time
from typing import Any, List


class Window:

  def __init__(self):
    self.start = self.end = 0.0
    self.outputs: List[Any] = []
    self.request_ids: List[int] = []
    self.latencies_s: List[float] = []
    self.frames = 0
    self.completed = 0

  def open(self) -> None:
    self.start = time.perf_counter()

  def done(self, out, frames: int) -> None:
    self.outputs.append(out)
    self.frames += frames
    self.completed += 1

  def close(self) -> None:
    self.end = time.perf_counter()

  @property
  def seconds(self) -> float:
    return self.end - self.start

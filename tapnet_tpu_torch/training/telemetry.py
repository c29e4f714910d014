"""Training telemetry: a JSONL scalar sink (port of
tapnet_tpu/training/telemetry.py).

One JSON object per line with `step`, a wall-clock `time`, a `kind` tag
("train"/"eval") and the scalar values. Each write is flushed, so the
history of a long run survives a crash and can be tailed live.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping, Optional


class ScalarSink:
  """Appends scalar dicts to a JSONL file; no-op when path is None."""

  def __init__(self, path: Optional[str]):
    self._path = path
    self._file = None
    if path:
      directory = os.path.dirname(path)
      if directory:
        os.makedirs(directory, exist_ok=True)
      self._file = open(path, "a", encoding="utf-8")

  @property
  def path(self) -> Optional[str]:
    return self._path

  def write(self, step: int, scalars: Mapping[str, float],
            kind: str = "train") -> None:
    if self._file is None:
      return
    record = {"step": int(step), "time": time.time(), "kind": kind}
    for key, value in scalars.items():
      record[key] = float(value)
    self._file.write(json.dumps(record) + "\n")
    self._file.flush()

  def close(self) -> None:
    if self._file is not None:
      self._file.close()
      self._file = None

  def __enter__(self) -> "ScalarSink":
    return self

  def __exit__(self, *exc) -> None:
    self.close()


def default_log_path(checkpoint_path: Optional[str]) -> Optional[str]:
  """`train_log.jsonl` next to the checkpoint file, or None."""
  if not checkpoint_path:
    return None
  return os.path.join(
      os.path.dirname(os.path.abspath(checkpoint_path)), "train_log.jsonl")

"""TAPVid-3D split management (the port's own copy of
tapnet_tpu/tapvid3d/splits.py and its `splits_data/`; no JAX).

The benchmark defines minival / full_eval splits as lists of npz filenames
per data source (adt, pstudio, drivetrack). The reference vendors them as
~4.6k Python string literals (tapvid3d/splits/tapvid3d_splits.py); here the
same lists ship as plain text files — one filename per line — under
`splits_data/` next to this module, so they work out of the box and stay
greppable. `$TAPVID3D_SPLITS_DIR` overrides the directory (e.g. to pin a
different benchmark release).
"""

from __future__ import annotations

import os
from typing import List

SPLITS_DIR_ENV = "TAPVID3D_SPLITS_DIR"
SOURCES = ("adt", "pstudio", "drivetrack")
SPLITS = ("minival", "full_eval")

_VENDORED_DIR = os.path.join(os.path.dirname(__file__), "splits_data")


def _splits_dir() -> str:
  return os.environ.get(SPLITS_DIR_ENV) or _VENDORED_DIR


def get_split_files(source: str, split: str) -> List[str]:
  if source not in SOURCES:
    raise ValueError(f"Unknown source {source!r}; expected one of {SOURCES}")
  if split not in SPLITS:
    raise ValueError(f"Unknown split {split!r}; expected one of {SPLITS}")
  path = os.path.join(_splits_dir(), f"{source}_{split}.txt")
  with open(path) as f:
    return [line.strip() for line in f if line.strip()]


def get_minival_files(source: str) -> List[str]:
  return get_split_files(source, "minival")


def get_full_eval_files(source: str) -> List[str]:
  return get_split_files(source, "full_eval")


def get_all_files(source: str) -> List[str]:
  """minival + full_eval (the splits are disjoint; reference
  tapvid3d_splits.get_all_files)."""
  return get_minival_files(source) + get_full_eval_files(source)

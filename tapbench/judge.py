"""How `correct` is decided: the gaps between the program's answers and the
plain reference's, summarised over every compared point-frame, each held to
its limit from the cell's file."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_KEYS = (("tracks", "track_px"), ("occlusion", "occlusion"),
         ("expected_dist", "expected_dist"))


def gap(out: Dict, ref: Dict) -> Dict[str, np.ndarray]:
  """Per point-frame gaps [B, N, T] of one answer from the reference's: the
  track's distance in px and each logit's absolute gap. An answer of another
  shape than the reference's, or a missing one, reads infinite."""
  keys = [(k, name) for k, name in _KEYS if ref.get(k) is not None]
  if any(out.get(k) is None or np.shape(out[k]) != np.shape(ref[k])
         for k, _ in keys):
    return {name: np.full((1, 1, 1), np.inf) for _, name in keys}
  res = {}
  for k, name in keys:
    d = np.asarray(out[k], np.float64) - np.asarray(ref[k], np.float64)
    res[name] = np.linalg.norm(d, axis=-1) if k == "tracks" else np.abs(d)
  return res


def summarize(gaps: List[Dict[str, np.ndarray]], block: int
              ) -> Dict[str, float]:
  """Over every compared point-frame: the median, 95th and 99th percentile
  of each gap; and `<gap>_worst_median`, the largest median of a group of
  point-frames that share a clip (or stream) and a block of `block`
  frames, which a fault confined to some frames or some clips moves where
  the overall median would not. A gap that is not finite reads infinite."""
  out = {}
  for key in gaps[0]:
    arrays = [np.where(np.isfinite(g[key]), g[key], np.inf) for g in gaps]
    v = np.concatenate([a.ravel() for a in arrays])
    for name, q in (("median", 50), ("p95", 95), ("p99", 99)):
      out[f"{key}_{name}"] = float(np.percentile(v, q))
    groups = [np.median(a[b, :, s:s + block])
              for a in arrays for b in range(a.shape[0])
              for s in range(0, a.shape[2], block)]
    out[f"{key}_worst_median"] = float(np.max(groups))
  return out


def verdict(stats: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, List[float]]]:
  """(every compared number within its limit, {name: [number, limit]})."""
  shown = {name: [stats.get(name, float("inf")), limit]
           for name, limit in limits.items()}
  return all(v <= lim for v, lim in shown.values()), shown

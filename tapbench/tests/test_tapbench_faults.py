"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, each cell rehearsed on the CPU at a tiny
size (`conftest.REHEARSAL`) with one fault planted in the port, once for
each fault the cell can have: a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced. (One
card: no exchange between cards to leave out.) A sound rehearsal of each
cell comes out correct."""

import numpy as np
import pytest
import torch

import harness
from conftest import REHEARSAL

SEED = 2**31 + 11


def _run(workload):
  return harness.run(workload, SEED, 0.5, False, "cpu", 0.0,
                     **REHEARSAL[workload])


def _tapir_state_unchanged(mp):
  from tapnet_tpu_torch.models import tapir  # pylint: disable=import-outside-toplevel
  orig = tapir.TAPIR._refine_pips

  def stuck(self, queries, pyramid, pos, occ, expd, *a, **k):
    out = orig(self, queries, pyramid, pos, occ, expd, *a, **k)
    return (pos, occ, expd) + tuple(out[3:])
  mp.setattr(tapir.TAPIR, "_refine_pips", stuck)


def _tapir_half(mp):
  from tapnet_tpu_torch import inference  # pylint: disable=import-outside-toplevel
  orig = inference.TapirPredictor._dispatch

  def half(self, video, qp):
    n = qp.shape[1]
    out, _, t = orig(self, video, qp[:, : n // 2])
    out = {k: torch.cat([v, v], 1) if k in ("tracks", "occlusion",
                                              "expected_dist") else v
           for k, v in out.items()}
    return out, n, t
  mp.setattr(inference.TapirPredictor, "_dispatch", half)


def _tapir_altered(mp):
  from tapnet_tpu_torch.models import tapir  # pylint: disable=import-outside-toplevel
  orig = tapir.TAPIR.forward

  def moved(self, *a, **k):
    out = dict(orig(self, *a, **k))
    out["tracks"] = out["tracks"] + 2.0
    return out
  mp.setattr(tapir.TAPIR, "forward", moved)


def _tapnext_state_unchanged(mp):
  from tapnet_tpu_torch.models import tapnext  # pylint: disable=import-outside-toplevel
  orig = tapnext.TAPNextTracker.forward_step

  def stuck(self, frames, query_points=None, query_padding=None, state=None):
    res = orig(self, frames, query_points, query_padding, state)
    if state is not None:
      res.state = state
    return res
  mp.setattr(tapnext.TAPNextTracker, "forward_step", stuck)


def _tapnext_half(mp):
  from tapnet_tpu_torch import inference  # pylint: disable=import-outside-toplevel
  orig_call = inference.TapnextPredictor.__call__
  orig_step = inference.OnlineTapnextPredictor.step

  def half_call(self, video, qp):
    n = qp.shape[1]
    out = orig_call(self, video, qp[:, : n // 2])
    return {k: None if v is None else np.concatenate([v, v], 1)
            for k, v in out.items()}

  def half_step(self, frame):
    tracks, logits = orig_step(self, frame)
    h = tracks.shape[0] // 2
    tracks[h:], logits[h:] = tracks[: tracks.shape[0] - h], logits[: logits.shape[0] - h]
    return tracks, logits
  mp.setattr(inference.TapnextPredictor, "__call__", half_call)
  mp.setattr(inference.OnlineTapnextPredictor, "step", half_step)


def _tapnext_altered(mp):
  from tapnet_tpu_torch.models import tapnext  # pylint: disable=import-outside-toplevel
  orig = tapnext.TAPNextTracker.prediction_heads

  def moved(self, feats):
    tracks, logits, vis = orig(self, feats)
    return tracks + 2.0, logits, vis
  mp.setattr(tapnext.TAPNextTracker, "prediction_heads", moved)


FAULTS = {
    "bootstapir.kinetics-480": (_tapir_state_unchanged, _tapir_half, _tapir_altered),
    "bootstapir.dense-256": (_tapir_state_unchanged, _tapir_half, _tapir_altered),
    "tapnext-b.kinetics-256": (_tapnext_state_unchanged, _tapnext_half,
                               _tapnext_altered),
    "tapnext-b.online-4x256": (_tapnext_state_unchanged, _tapnext_half,
                               _tapnext_altered),
}
BENCHMARKED = {w["name"] for w in harness.load_json(
    harness.REPO, "BENCHMARK.json")["workloads"]}
FAULTS = {w: f for w, f in FAULTS.items() if w in BENCHMARKED}
CASES = [(w, f) for w, faults in FAULTS.items() for f in faults]


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_sound_rehearsal_is_correct(workload):
  result = _run(workload)
  assert result["correct"], result["checks"]
  assert result["attempted"] >= 1


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, f in CASES])
def test_planted_fault_is_not_correct(workload, fault, monkeypatch):
  fault(monkeypatch)
  result = _run(workload)
  assert not result["correct"], result["checks"]

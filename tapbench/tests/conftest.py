"""The benchmark's own tests: `python -m pytest tapbench/tests` from the
root of the repository. Tests that need the card carry the `gpu` marker and
skip inside a fixture without one; run them on the card with
`python -m pytest -m gpu tapbench/tests`."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

# A tiny TAPNext for CPU rehearsals (the published widths run on the card).
TINY_TAPNEXT = {"width": 32, "depth": 1, "mlp_dim": 128, "num_heads": 2,
                "image_size": [64, 64]}

# Each cell cut to a few frames of 64x64 for CPU rehearsals: its loop,
# families, readers and reference run as on the card.
REHEARSAL = {
    "bootstapir.kinetics-480": dict(cell_override={
        "traffic": {"frames": 4, "height": 64, "width": 64, "queries": 8,
                    "pool": 2, "requests": 4},
        "program": {"query_chunk_size": 4, "refinement_resolutions": [[64, 64]]},
        "check": {"requests": 1, "query_chunk": 4, "frame_chunk": 2,
                  "block_frames": 2}}),
    "bootstapir.dense-256": dict(cell_override={
        "traffic": {"frames": 4, "height": 64, "width": 64, "queries": 16,
                    "grid": 4, "pool": 2, "requests": 4},
        "program": {"query_chunk_size": 8, "refinement_resolutions": [[64, 64]]},
        "check": {"requests": 1, "query_chunk": 8, "frame_chunk": 2,
                  "block_frames": 2}}),
    "tapnext-b.kinetics-256": dict(cell_override={
        "traffic": {"frames": 9, "height": 64, "width": 64, "queries": 8,
                    "pool": 2, "requests": 4},
        "program": {"chunk_size": 3},
        "check": {"requests": 1, "frame_chunk": 4, "block_frames": 3}},
                                   model_override=TINY_TAPNEXT),
    "tapnext-b.online-4x256": dict(cell_override={
        "traffic": {"frames": 5, "height": 64, "width": 64, "queries": 8},
        "check": {"frame_chunk": 3, "block_frames": 3}},
        model_override=TINY_TAPNEXT),
}


@pytest.fixture
def card():
  import torch  # pylint: disable=import-outside-toplevel
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  return torch.device("cuda:0")

"""PyTorch port, full width: the committed trained BootsTAPIR through
`TapirPredictor(device="cpu")` against the JAX package's golden outputs on
the same clip (tests/data/bootstapir_golden.npz, written by
tools/make_torch_golden.py).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tapnet_tpu_torch.checkpoints.tapir_checkpoint import load_tapir_checkpoint
from tapnet_tpu_torch.inference import TapirPredictor
from tapnet_tpu_torch.models.tapir import bootstapir_config
from tapnet_tpu_torch.utils.sampling import preprocess_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests/data/bootstapir_golden.npz")
CHECKPOINT = os.path.join(REPO, "runs/bootstapir_synth/trained_params_f16.npy")

# fp32 against fp32 on the CPU: summation order through the 12-block mixer
# and 4 refinement steps. Measured 6.6e-4 px on tracks of a 256 px clip and
# 5e-5 on logits of magnitude ~10.
TRACK_TOL = 1e-2
LOGIT_TOL = 1e-3


def test_trained_bootstapir_matches_jax_golden():
  golden = np.load(GOLDEN)
  params = load_tapir_checkpoint(CHECKPOINT)
  predictor = TapirPredictor(params, bootstapir_config(), device="cpu")
  frames = preprocess_frames(torch.from_numpy(golden["video"]))
  out = predictor(frames, golden["query_points"])
  np.testing.assert_allclose(
      out["tracks"], golden["tracks"], rtol=0, atol=TRACK_TOL
  )
  for key in ("occlusion", "expected_dist"):
    np.testing.assert_allclose(out[key], golden[key], rtol=0, atol=LOGIT_TOL)
  np.testing.assert_array_equal(
      predictor.visibles(out), predictor.visibles(dict(golden))
  )

"""PyTorch port, full width: the committed trained BootsTAPIR through
`TapirPredictor(device="cpu")` against the JAX package's golden outputs on
the same clip (tests/data/bootstapir_golden.npz, written by
tools/make_torch_golden.py), in full precision and in the two int8
configurations (tests/data/bootstapir_golden_int8.npz, same tool).
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
GOLDEN_INT8 = os.path.join(REPO, "tests/data/bootstapir_golden_int8.npz")
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


# The int8 configurations of tools/make_torch_golden.py.
INT8_CONFIGS = {
    "a": dict(quantized_mixer=True, quantized_corr="per_frame"),
    "b": dict(quantized_corr=True),
}
# fp32 model dtype on both sides, the same exact integer products on
# bit-equal int8 values. Differences are float32 noise plus the rare
# activation that this noise moves across an int8 or bf16 rounding boundary,
# carried through 12 blocks and 4 refinement steps. Where the golden run
# calls a point visible, the image pins its position; on occluded frames
# (22% here) it does not, and the same flip moves the estimate further.
# Measured, as (a, b): visible points 0.17 and 0.0094 px at most; all points
# 1.5 and 0.15 px at most, median 0.011 and 3e-5 px; logits 0.064 and 0.0078.
INT8_TOL = {
    "a": dict(visible_px=0.5, any_px=4.0, median_px=0.05, logits=0.2),
    "b": dict(visible_px=0.05, any_px=0.5, median_px=1e-3, logits=0.03),
}


@pytest.mark.parametrize("name", sorted(INT8_CONFIGS))
def test_trained_int8_bootstapir_matches_jax_golden(name):
  golden = np.load(GOLDEN)
  ref = {k[2:]: v for k, v in np.load(GOLDEN_INT8).items()
         if k.startswith(name + "_")}
  params = load_tapir_checkpoint(CHECKPOINT)
  predictor = TapirPredictor(
      params, bootstapir_config(**INT8_CONFIGS[name]), device="cpu")
  frames = preprocess_frames(torch.from_numpy(golden["video"]))
  out = predictor(frames, golden["query_points"])
  tol = INT8_TOL[name]
  err = np.linalg.norm(out["tracks"] - ref["tracks"], axis=-1)
  visible = predictor.visibles(ref)
  assert err[visible].max() <= tol["visible_px"], err[visible].max()
  assert err.max() <= tol["any_px"], err.max()
  assert np.median(err) <= tol["median_px"], np.median(err)
  for key in ("occlusion", "expected_dist"):
    np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=tol["logits"])
  np.testing.assert_array_equal(predictor.visibles(out), visible)
  # The int8 configuration is a different computation from the float one,
  # and a close one.
  shift = np.linalg.norm(ref["tracks"] - golden["tracks"], axis=-1)
  assert 0 < np.median(shift) < 0.5, np.median(shift)

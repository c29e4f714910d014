"""PyTorch port, full width: the committed trained BootsTAPIR through
`TapirPredictor(device="cpu")` against the JAX package's golden outputs on
the same clip (tests/data/bootstapir_golden.npz, written by
tools/golden_clip.py), in full precision and in the int8
configurations (tests/data/bootstapir_golden_int8.npz, same tool).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tapnet_tpu.ops import fused_extra_convs as jax_fec
from tapnet_tpu_torch.checkpoints.tapir_checkpoint import load_tapir_checkpoint
from tapnet_tpu_torch.inference import TapirPredictor
from tapnet_tpu_torch.models.tapir import bootstapir_config
from tapnet_tpu_torch.ops import fused_extra_convs
from tapnet_tpu_torch.utils.sampling import preprocess_frames
from tools import golden_clip

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


# The int8 configurations of tools/golden_clip.py: a (w8a8 mixer,
# per-frame int8 correlation), b (per-position int8 correlation), c (the JAX
# package's headline: a with the per-frame int8 ExtraConvs and 2 refinement
# steps) and d (the per-pixel int8 ExtraConvs, on a 24-frame clip).
INT8_CONFIGS = golden_clip.INT8_CONFIGS
# fp32 model dtype on both sides, the same exact integer products on
# bit-equal int8 values. Differences are float32 noise plus the rare
# activation that this noise moves across an int8 or bf16 rounding boundary,
# carried through 12 blocks and the refinement steps; in c and d also through
# the ExtraConvs, whose per-frame (c) or per-pixel (d) scales requantize every
# layer. Where the golden run calls a point visible, the image pins its
# position; on occluded frames (22% here; 16% in c, 35% in d) it does not,
# and the same flip moves the estimate further. Measured, as (a, b, c, d):
# visible points 0.17, 0.0094, 0.86 and 0.10 px at most; all points 1.5,
# 0.15, 1.8 and 0.84 px at most, median 0.011, 3e-5, 0.042 and 0.0017 px;
# logits 0.064, 0.0078, 0.11 and 0.082. c's own quantization moves the float
# golden tracks by 0.20 px in the median and 61 px at most (a near-tied
# stage-1 cost-volume peak flips).
INT8_TOL = {
    "a": dict(visible_px=0.5, any_px=4.0, median_px=0.05, logits=0.2),
    "b": dict(visible_px=0.05, any_px=0.5, median_px=1e-3, logits=0.03),
    "c": dict(visible_px=2.5, any_px=5.0, median_px=0.12, logits=0.3),
    "d": dict(visible_px=0.3, any_px=2.5, median_px=5e-3, logits=0.25),
}


def _int8_clip(name):
  """(video uint8, query points) of configuration `name`: the float golden
  clip, or the longer clip rebuilt from the tool's seed."""
  frames = golden_clip.CLIP_FRAMES[name]
  if frames == golden_clip.T:
    golden = np.load(GOLDEN)
    return golden["video"], golden["query_points"]
  return golden_clip.make_clip(num_frames=frames)


def test_per_pixel_golden_clip_takes_the_fused_gate():
  """Configuration d's low-resolution grid (24 frames of 32 x 32 x 256 at
  256^2) is over the JAX gate's threshold, so JAX ran the per-pixel scheme
  there; the 8-frame clip's grid is under it."""
  for frames, fused in ((24, True), (8, False)):
    grid = np.zeros((frames, 32, 32, 256), np.float32)
    assert bool(jax_fec.wants_fused(grid, True)) is fused
    assert fused_extra_convs.wants_fused(torch.from_numpy(grid), True) is fused
  video, _ = _int8_clip("d")
  assert video.shape == (1, 24, 256, 256, 3)


@pytest.mark.parametrize("name", sorted(INT8_CONFIGS))
def test_trained_int8_bootstapir_matches_jax_golden(name, monkeypatch):
  golden = np.load(GOLDEN)
  ref = {k[2:]: v for k, v in np.load(GOLDEN_INT8).items()
         if k.startswith(name + "_")}
  params = load_tapir_checkpoint(CHECKPOINT)
  predictor = TapirPredictor(
      params, bootstapir_config(**INT8_CONFIGS[name]), device="cpu")
  video, query_points = _int8_clip(name)
  calls = []
  real = fused_extra_convs.extra_convs_layer
  monkeypatch.setattr(fused_extra_convs, "extra_convs_layer",
                      lambda *a, **k: calls.append(1) or real(*a, **k))
  out = predictor(preprocess_frames(torch.from_numpy(video)), query_points)
  # d runs the per-pixel layer 5 times (one backbone resolution); the others
  # never.
  assert len(calls) == (5 if name == "d" else 0)
  tol = INT8_TOL[name]
  err = np.linalg.norm(out["tracks"] - ref["tracks"], axis=-1)
  visible = predictor.visibles(ref)
  assert err[visible].max() <= tol["visible_px"], err[visible].max()
  assert err.max() <= tol["any_px"], err.max()
  assert np.median(err) <= tol["median_px"], np.median(err)
  for key in ("occlusion", "expected_dist"):
    np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=tol["logits"])
  np.testing.assert_array_equal(predictor.visibles(out), visible)
  if video.shape[1] == golden["video"].shape[1]:
    # The int8 configuration is a different computation from the float one,
    # and a close one.
    shift = np.linalg.norm(ref["tracks"] - golden["tracks"], axis=-1)
    assert 0 < np.median(shift) < 0.5, np.median(shift)

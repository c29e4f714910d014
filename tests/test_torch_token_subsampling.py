"""PyTorch port, TAPNext's TokenSubsampling (models/ssm_vit.py) against the
JAX module: the masking step on the cutoffs read off JAX's own output (the
two packages' random streams differ, so the draws themselves are held to
their distribution), the switch by drop ratio, training flag and override.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_threads  # noqa: E402

_torch_threads.share_cores()

from tapnet_tpu.models import ssm_vit as jax_ssm_vit  # noqa: E402
from tapnet_tpu_torch.models import ssm_vit  # noqa: E402

B, T, N, D = 6, 9, 5, 8


def _inputs():
  rng = np.random.RandomState(0)
  tokens = rng.randn(B, T, N, D).astype(np.float32)
  mask_token = rng.randn(1, 1, 1, D).astype(np.float32)
  return tokens, mask_token


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masking_matches_jax_on_its_cutoffs(seed):
  tokens, mask_token = _inputs()
  module = jax_ssm_vit.TokenSubsampling(drop_ratio=0.5, is_training=True)
  ref_tokens, ref_masked = jax.device_get(module.apply(
      {}, jnp.asarray(tokens), jnp.asarray(mask_token),
      rngs={"degradation": jax.random.PRNGKey(seed)}))
  ref_masked = np.asarray(ref_masked)
  # Each row masks a non-empty suffix; its first frame is the cutoff.
  assert ref_masked.any(1).all() and not ref_masked[:, 0].any()
  cutoff = torch.from_numpy(ref_masked.argmax(1))
  got_tokens, got_masked = ssm_vit.mask_suffix(
      torch.from_numpy(tokens), torch.from_numpy(mask_token), cutoff)
  np.testing.assert_array_equal(got_masked.numpy(), ref_masked)
  np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(ref_tokens))


def test_cutoffs_cover_one_to_t_minus_one():
  """10,000 draws stay within [1, T-1] and reach every value of it, each
  about equally often."""
  gen = torch.Generator().manual_seed(0)
  draws = ssm_vit.draw_cutoffs(gen, 10_000, T).numpy()
  assert draws.min() == 1 and draws.max() == T - 1
  counts = np.bincount(draws, minlength=T)[1:]
  assert (counts > 0).all()
  expected = 10_000 / (T - 1)
  assert np.abs(counts - expected).max() < 0.15 * expected, counts


def test_module_masks_a_suffix_per_element():
  tokens, mask_token = _inputs()
  module = ssm_vit.TokenSubsampling(drop_ratio=0.5, is_training=True)
  out, masked = module(torch.from_numpy(tokens), torch.from_numpy(mask_token),
                       torch.Generator().manual_seed(3))
  masked = masked.numpy()
  assert masked.shape == (B, T) and masked.dtype == bool
  assert not masked[:, 0].any() and masked[:, -1].all()
  # A suffix: once masked, masked to the end.
  assert (np.diff(masked.astype(int), axis=1) >= 0).all()
  out = out.numpy()
  np.testing.assert_array_equal(out[~masked], tokens[~masked])
  assert (out[masked] == mask_token[0, 0]).all()


@pytest.mark.parametrize("drop_ratio,is_training,override,active", [
    (0.0, True, None, False),
    (0.5, False, None, False),
    (0.5, True, 0.0, False),
    (0.0, False, 0.3, True),
])
def test_drop_ratio_switches_as_jax(drop_ratio, is_training, override, active):
  """Drop ratio 0 (the training one, the test one, or an override) returns
  the tokens and an all-False mask, in both packages."""
  tokens, mask_token = _inputs()
  module = ssm_vit.TokenSubsampling(drop_ratio=drop_ratio,
                                    is_training=is_training)
  out, masked = module(torch.from_numpy(tokens), torch.from_numpy(mask_token),
                       torch.Generator().manual_seed(0),
                       override_drop_ratio=override)
  jax_module = jax_ssm_vit.TokenSubsampling(drop_ratio=drop_ratio,
                                            is_training=is_training)
  _, ref_masked = jax_module.apply(
      {}, jnp.asarray(tokens), jnp.asarray(mask_token),
      override_drop_ratio=override,
      rngs={"degradation": jax.random.PRNGKey(0)})
  assert bool(masked.any()) == bool(np.asarray(ref_masked).any()) == active
  if not active:
    np.testing.assert_array_equal(out.numpy(), tokens)
    assert masked.shape == (B, T) and masked.dtype == torch.bool

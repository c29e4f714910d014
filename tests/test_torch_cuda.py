"""PyTorch port, CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (the main-path shapes are held in chip_smoke.py).

Marked `gpu`: skips without a CUDA card. This file imports no JAX, so it also
runs where only the port is installed:

  python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tapnet_tpu_torch.ops import corr_tents, fused_mixer_block

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device("cuda")


# Kernel vs plain on the card, as (rtol, atol). fp32: summation order.
# bf16, for unit-norm grid and query rows (|corr| <= 1): both sides round the
# same correlation to bf16 and may land one step (<= 2^-7) apart; the plain
# version also rounds the y-tent stage and the x-tents to bf16 (<= 2^-8 of
# |corr| each) where the kernel keeps them in fp32. Sum: 2^-6.
CORR_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.0, 2.0**-6)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "bt,h,w,c,n", [(3, 12, 10, 40, 5), (2, 39, 17, 128, 70)],
    ids=["tiny", "ragged"],
)
def test_corr_tents_kernel_matches_plain(cuda, dtype, bt, h, w, c, n):
  rng = np.random.RandomState(0)
  grid = rng.randn(bt, h, w, c).astype(np.float32)
  grid /= np.linalg.norm(grid, axis=-1, keepdims=True)
  query = rng.randn(bt, n, c).astype(np.float32)
  query /= np.linalg.norm(query, axis=-1, keepdims=True)
  cy = (rng.rand(bt, n) * (h + 8) - 4).astype(np.float32)
  cx = (rng.rand(bt, n) * (w + 8) - 4).astype(np.float32)
  tdt = DTYPES[dtype]
  args = [torch.from_numpy(grid).to(cuda, tdt), torch.from_numpy(query).to(cuda, tdt),
          torch.from_numpy(cy).to(cuda), torch.from_numpy(cx).to(cuda)]
  before = corr_tents.LAUNCHES
  out = corr_tents.corr_tent_patches(*args, 7)
  torch.cuda.synchronize()
  assert corr_tents.LAUNCHES == before + 1
  ref = corr_tents.corr_tent_patches_reference(*args, 7)
  rtol, atol = CORR_TOL[dtype]
  torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


# fp32: SIMT GEMM vs cuBLAS fp32 (TF32 off), summation order (2e-4).
# bf16: elementwise, two bf16 steps of each value that the kernel and the
# plain version round separately (`fused_mixer_block.bf16_error_limit`).
MIXER_FP32_TOL = (2e-4, 2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "b,t,valid_len,c,hid", [(3, 13, None, 64, 256), (5, 37, 30, 128, 512)],
    ids=["one_tile", "tiles_valid_len"],
)
def test_mixer_block_kernel_matches_plain(cuda, dtype, causal, b, t, valid_len,
                                          c, hid):
  rng = np.random.RandomState(1)
  f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
  args = [
      f(b, t, c) * 0.5, f(c) * 0.2 + 1, f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1,
      f(3, 1, 4 * c) * 0.3, f(4 * c) * 0.1, f(c) * 0.2 + 1,
      f(c, hid) * 0.1, f(hid) * 0.1, f(hid, c) * 0.1, f(c) * 0.1,
  ]
  args = [a.to(cuda, DTYPES[dtype]) for a in args]
  before = fused_mixer_block.LAUNCHES
  out = fused_mixer_block.mixer_block(*args, causal, valid_len)
  torch.cuda.synchronize()
  assert fused_mixer_block.LAUNCHES == before + 1
  ref = fused_mixer_block.mixer_block_reference(*args, causal, valid_len)
  if dtype == "float32":
    rtol, atol = MIXER_FP32_TOL
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
  else:
    limit = fused_mixer_block.bf16_error_limit(*args, causal, valid_len)
    err = (out.float() - ref.float()).abs()
    assert (err <= limit).all(), float((err / limit.clamp_min(1e-30)).max())
  if valid_len is not None:
    assert not out[:, valid_len:].any()

"""The launch plan of the TMA + wgmma GEMM loop of `csrc/tma_gemm.cuh`, and
the float32 operands' TF32 split.

X (`qconv.conv2d_q8` on CUDA), K6f's two products
(`fused_extra_convs.extra_convs_layer`) and K3's two products
(`fused_mixer_block.mixer_block`) run on that loop: bf16 in bf16, float32 as
error-compensated TF32 (`tf32x3_pairs` gives the products the kernels sum,
for the CPU emulations). Its plan is computed here in pure Python, so that
the CPU tests can hold it to the card's shared memory and to the header's
constants, and the wrappers pass its shared-memory bytes to the kernels,
which refuse a plan that differs from their own count.

A CTA owns a TILE_M x TILE_N output tile (int8 and bf16; TILE_N_TF32 for
float32, whose two B boxes are the big and the small TF32 parts of the same
columns); K goes in steps of K_BYTES bytes through a ring of STAGES stages of
one A box and two B boxes (BOX_ROWS rows each), the same bytes for every
operand type; a producer warpgroup issues the TMA loads and CONSUMERS
warpgroups the wgmma products, whose epilogue stages each warp's values in shared
memory and stores them in 16-byte pieces. The grid is persistent: one CTA
per SM (132 on the H100 SXM), at most one per tile.
"""

from __future__ import annotations

import torch

TILE_M, TILE_N, K_BYTES = 128, 256, 128  # tg::kBM, kBN, kBK
TILE_N_TF32 = 128  # tg::kBNTf32
BOX_ROWS = 128  # tg::kBoxRows
STAGES = 4  # tg::kStages
CONSUMERS = 2  # tg::kConsumers
THREADS = 128 * (CONSUMERS + 1)
SMEM_ALIGN = 1024  # tg::kSmemAlign
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on the H100
STAGE_BYTES = (TILE_M + 2 * BOX_ROWS) * K_BYTES
# The epilogue's staging: per consumer warp, 16 rows of CHUNK_BYTES bytes of
# columns, each row padded by 16 bytes.
CHUNK_BYTES = 128  # tg::kChunkBytes
STAGING_BYTES = 16 * (CHUNK_BYTES + 16)
SMEM_BYTES = (SMEM_ALIGN + STAGES * STAGE_BYTES + 2 * STAGES * 8
              + CONSUMERS * 4 * STAGING_BYTES)
PRODUCER_REGS, CONSUMER_REGS = 40, 232  # setmaxnreg
H100_SMS = 132
INT32_MAX = 2**31 - 1


def gemm_plan(m: int, n: int, k_bytes: int, sms: int = H100_SMS,
              tile_n: int = TILE_N) -> dict:
  """The loop's plan for C [m, n] with k_bytes bytes of K a row in tiles of
  TILE_M x tile_n: tiles, K steps, the persistent grid on `sms` SMs,
  threads, stages and dynamic shared memory. Raises where the kernel's int32
  row coordinates would overflow."""
  if min(m, n, k_bytes) <= 0:
    raise ValueError(f"tma_gemm: empty problem {(m, n, k_bytes)}")
  if m + TILE_M > INT32_MAX:
    raise ValueError(f"tma_gemm: {m} rows overflow the kernel's coordinates")
  tiles_m, tiles_n = -(-m // TILE_M), -(-n // tile_n)
  tiles = tiles_m * tiles_n
  return dict(m=m, n=n, k_steps=-(-k_bytes // K_BYTES), tile_n=tile_n,
              tiles_m=tiles_m, tiles_n=tiles_n, tiles=tiles,
              grid=min(tiles, sms),
              threads=THREADS, stages=STAGES, smem_bytes=SMEM_BYTES)


def tf32_round(v):
  """float32 v rounded to TF32 (10 mantissa bits, to nearest, ties away from
  zero) as `cvt.rna.tf32.f32` rounds it: float32 with the low 13 bits 0."""
  bits = v.float().contiguous().view(torch.int32)
  return ((bits + 0x1000) & -0x2000).view(torch.float32)


# The products of the float32 kernels' split (each operand v = big + small,
# big = tf32(v), small = tf32(v - big)), named operand A's part first: all
# three terms they sum, and the two faults that their checks' limits must
# refuse (`fused_mixer_block.fp32_controls`, `fused_extra_convs.fp32_controls`).
TF32X3_TERMS = {
    "tf32x3": ("small_big", "big_small", "big_big"),
    "single_tf32": ("big_big",),
    "no_small_a": ("big_small", "big_big"),
}


def tf32x3_pairs(a, b, terms="tf32x3"):
  """The float64 operand pairs (A part, B part) of `TF32X3_TERMS[terms]` for
  float32 operands a and b (e.g. "small_big" = (tf32(a - tf32(a)), tf32(b))):
  the products of the pairs summed in float64 and rounded to float32 once
  are the float32 kernels' arithmetic with an exact accumulator."""
  parts = []
  for v in (a, b):
    big = tf32_round(v)
    parts.append(dict(big=big.double(), small=tf32_round(v.float() - big).double()))
  return [(parts[0][left], parts[1][right])
          for left, right in (term.split("_") for term in TF32X3_TERMS[terms])]

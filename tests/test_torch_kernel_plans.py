"""PyTorch port: the launch plans of the kernels on shared-memory rings, on
the CPU: K6 and K4 (the int8 tile loop of csrc/q8_tile.cuh), X, K3 and K6f
(bf16 and float32: the TMA + wgmma loop of csrc/tma_gemm.cuh), and
the loops and queries per block of K1 and of the int8 corr-tents (K2, K2b).

Each wrapper computes its launch plan in a pure function (rows per block,
tiles, dynamic shared memory, grid, ring stages) that the kernels check
against their own count. These tests hold the plans to the card's shared memory at
the served and test shapes in both dtypes, to the constants of the CUDA
sources, to the shapes the kernels refuse, and the wrappers' shape checks to
the plans. No JAX, no card.
"""

import ctypes
import re

import pytest

torch = pytest.importorskip("torch")

from tapnet_tpu_torch.models import layers  # noqa: E402
from tapnet_tpu_torch.ops import (  # noqa: E402
    _build, corr_tents, fused_extra_convs, fused_mixer_block, mixer_math, qconv,
    tma_gemm,
)

DTYPES = [torch.float32, torch.bfloat16]
SMEM_LIMIT = 232_448  # the shared memory a block may use on the H100 (227 KB)

# (n, h, w, C): the served grids of a 480x480 video, the card tests' shapes
# (tests/test_torch_cuda.py), and the edges: a pixel count no multiple of a
# block, frames smaller than a block, a partial K panel (C = 16, 48).
K6_SHAPES = [(250, 60, 60, 256), (250, 32, 32, 256), (2, 9, 7, 128),
             (1, 11, 13, 256), (3, 5, 5, 128), (4, 8, 10, 256), (2, 6, 37, 48),
             (1, 3, 4, 16)]
# (B, T, C, H): the served block, the card tests' shapes and the edges (H no
# multiple of 128, C below a tile).
K4_SHAPES = [(128, 250, 512, 2048), (3, 13, 64, 256), (5, 37, 128, 512),
             (2, 150, 48, 208), (2, 9, 512, 2048), (4, 70, 96, 336)]


def _source(name):
  return (_build.SRC_DIR / name).read_text()


def _constants(text, names):
  """The integer values of `constexpr int` constants in a CUDA source."""
  found = {}
  for name in names:
    match = re.search(rf"\b{name} = (\d+)", text)
    assert match, name
    found[name] = int(match.group(1))
  return found


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w,c", K6_SHAPES)
def test_k6_plan_fits_the_card(dtype, n, h, w, c):
  plan = fused_extra_convs.q8_launch_plan(n, h, w, c, 4 * c, dtype)
  rows = n * h * w
  assert plan["rows"] == rows
  for part in ("up", "out"):
    assert 0 < plan[part]["smem_bytes"] <= SMEM_LIMIT
    assert plan[part]["threads"] == 256
    assert plan[part]["stages"] >= 3
  assert plan["up"]["grid"] * plan["up"]["rows_per_block"] >= rows
  assert (plan["up"]["grid"] - 1) * plan["up"]["rows_per_block"] < rows
  out = plan["out"]
  assert out["grid"] == -(-rows // out["rows_per_block"]) * -(-c // out["cols_per_block"])
  # conv_up keeps the whole 3x3xC patch of its block: 147,456 bytes at C=256.
  assert plan["up"]["smem_bytes"] >= 64 * 9 * c


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,c,hid", K4_SHAPES)
def test_k4_plan_fits_the_card(dtype, b, t, c, hid):
  plan = fused_mixer_block.q8_launch_plan(b, t, c, hid, dtype)
  rows = b * t
  assert plan["rows"] == rows
  for part in ("temporal", "mlp"):
    assert 0 < plan[part]["smem_bytes"] <= SMEM_LIMIT
  mlp = plan["mlp"]
  assert mlp["grid"] == -(-rows // mlp["rows_per_block"])
  assert plan["temporal"]["grid"] == b * -(-t // 16)
  # The int8 operand of a block (64 x C) stays in shared memory.
  assert mlp["smem_bytes"] >= mlp["rows_per_block"] * c


def test_served_plans():
  """The numbers PERF.md and the kernels' notes state for the served shapes."""
  k6 = fused_extra_convs.q8_launch_plan(250, 60, 60, 256, 1024)
  assert k6["up"]["grid"] == 14063 and k6["out"]["grid"] == 7032 * 2
  assert k6["up"]["smem_bytes"] == 1024 + 147_456 + 2 * 5 * 128 * 64 + 64 * 4 * 5
  k4 = fused_mixer_block.q8_launch_plan(128, 250, 512, 2048)
  assert k4["mlp"]["grid"] == 500 and k4["temporal"]["grid"] == 128 * 16


def test_plans_mirror_the_sources():
  """The plans' tile sizes and stages are the CUDA sources' constants."""
  up = _constants(_source("extra_convs.cu"),
                  ["kUpRows", "kUpCols", "kUpStages", "kOutRows", "kOutCols",
                   "kOutStages"])
  assert (up["kUpRows"], up["kUpCols"], up["kUpStages"]) == (
      fused_extra_convs._UP_ROWS, fused_extra_convs._UP_COLS,  # pylint: disable=protected-access
      fused_extra_convs._UP_STAGES)  # pylint: disable=protected-access
  assert (up["kOutRows"], up["kOutCols"], up["kOutStages"]) == (
      fused_extra_convs._OUT_ROWS, fused_extra_convs._OUT_COLS,  # pylint: disable=protected-access
      fused_extra_convs._OUT_STAGES)  # pylint: disable=protected-access
  mlp = _constants(_source("fused_mixer_block.cu"),
                   ["kMlpRows", "kMlpTile", "kMlpStages", "kMlpWgs", "kMlpW1K",
                    "kTileT"])
  assert (mlp["kMlpRows"], mlp["kMlpTile"], mlp["kMlpStages"], mlp["kMlpWgs"],
          mlp["kMlpW1K"], mlp["kTileT"]) == (
              fused_mixer_block._MLP_ROWS, fused_mixer_block._MLP_TILE,  # pylint: disable=protected-access
              fused_mixer_block._MLP_STAGES, fused_mixer_block._MLP_WGS,  # pylint: disable=protected-access
              fused_mixer_block._MLP_W1K, fused_mixer_block._TILE_T)  # pylint: disable=protected-access
  tile = _constants(_source("q8_tile.cuh"), ["kThreads", "kPanel", "kSmemAlign"])
  assert tile["kThreads"] == fused_extra_convs.THREADS
  assert tile["kPanel"] == fused_extra_convs._PANEL == fused_mixer_block._PANEL  # pylint: disable=protected-access
  assert (tile["kSmemAlign"] == fused_extra_convs._SMEM_ALIGN  # pylint: disable=protected-access
          == fused_mixer_block._SMEM_ALIGN)  # pylint: disable=protected-access


# Shapes the kernels refuse, with the error and a fragment of its message.
K6_REFUSED = [
    ((1, 4, 4, 24, 96, torch.float32), ValueError, "multiple of 16"),
    ((1, 4, 4, 32, 96, torch.float32), ValueError, "multiple of 64"),
    ((1, 4, 4, 288, 1152, torch.float32), ValueError, "shared memory"),
    ((0, 4, 4, 32, 128, torch.float32), ValueError, "empty"),
    ((1, 4, 4, 32, 128, torch.float16), TypeError, "float32 or bfloat16"),
]
K4_REFUSED = [
    ((2, 5, 8, 32, torch.float32), ValueError, "multiples of 16"),
    ((2, 5, 32, 24, torch.float32), ValueError, "multiples of 16"),
    ((2, 5, 528, 2112, torch.float32), ValueError, "output columns"),
    ((2, 0, 32, 128, torch.float32), ValueError, "empty"),
    ((2, 5, 32, 128, torch.float16), TypeError, "float32 or bfloat16"),
]


@pytest.mark.parametrize("args,error,match", K6_REFUSED,
                         ids=["c24", "m96", "c288_smem", "empty", "fp16"])
def test_k6_plan_refuses(args, error, match):
  with pytest.raises(error, match=match):
    fused_extra_convs.q8_launch_plan(*args)


@pytest.mark.parametrize("args,error,match", K4_REFUSED,
                         ids=["c8", "h24", "c528", "empty", "fp16"])
def test_k4_plan_refuses(args, error, match):
  with pytest.raises(error, match=match):
    fused_mixer_block.q8_launch_plan(*args)


class _Reached(Exception):
  """Raised in place of loading a library: the wrapper passed its checks."""


@pytest.fixture
def no_library(monkeypatch):
  def reached(*args, **kwargs):
    raise _Reached()
  monkeypatch.setattr(_build, "load", reached)


def _plan_outcome(plan, *args):
  try:
    plan(*args)
  except (ValueError, TypeError) as err:
    return type(err)
  return _Reached


# (n, h, w, C, M) for K6 and (B, T, C, H) for K4: shapes both take and
# shapes both refuse. The wrapper sees CPU tensors; it must raise exactly
# where the plan does, and otherwise reach the library.
K6_WRAPPER_SHAPES = [(1, 3, 4, 16, 64), (2, 5, 5, 32, 128), (1, 3, 4, 24, 96),
                     (1, 3, 4, 32, 96), (1, 2, 2, 288, 1152)]
K4_WRAPPER_SHAPES = [(2, 5, 32, 128), (1, 7, 48, 208), (2, 5, 8, 32),
                     (2, 5, 32, 24), (1, 3, 528, 2112)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w,c,m", K6_WRAPPER_SHAPES)
def test_k6_wrapper_checks_agree_with_the_plan(no_library, dtype, n, h, w, c, m):  # pylint: disable=redefined-outer-name,unused-argument
  gen = torch.Generator().manual_seed(0)
  f = lambda *s: torch.randn(*s, generator=gen)
  x = f(n, h, w, c).to(dtype)
  qweights = fused_extra_convs.quantized_weights(f(3, 3, c, m), f(3, 3, m, c))
  expected = _plan_outcome(fused_extra_convs.q8_launch_plan, n, h, w, c, m, dtype)
  with pytest.raises(expected):
    fused_extra_convs._launch(x, f(c), f(c), f(m), f(c), qweights)  # pylint: disable=protected-access


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,c,hid", K4_WRAPPER_SHAPES)
def test_k4_wrapper_checks_agree_with_the_plan(no_library, dtype, b, t, c, hid):  # pylint: disable=redefined-outer-name,unused-argument
  gen = torch.Generator().manual_seed(0)
  f = lambda *s: torch.randn(*s, generator=gen).to(dtype)
  args = [f(b, t, c), f(c), f(3, 1, 4 * c), f(4 * c), f(3, 1, 4 * c),
          f(4 * c), f(c), f(hid), f(c)]
  qweights = (*mixer_math.quantize_weight_cols(f(c, hid)),
              *mixer_math.quantize_weight_cols(f(hid, c)))
  expected = _plan_outcome(fused_mixer_block.q8_launch_plan, b, t, c, hid, dtype)
  with pytest.raises(expected):
    fused_mixer_block._launch_q8(*args, qweights, False, None)  # pylint: disable=protected-access


def test_build_key_follows_the_shared_header(tmp_path, monkeypatch):
  """A library's key changes with the headers its source may include."""
  src = tmp_path / "csrc"
  src.mkdir()
  (src / "k.cu").write_text('#include "t.cuh"\n')
  (src / "t.cuh").write_text("// one\n")
  monkeypatch.setattr(_build, "SRC_DIR", src)
  before = _build._library_path("k")  # pylint: disable=protected-access
  (src / "t.cuh").write_text("// two\n")
  assert _build._library_path("k") != before  # pylint: disable=protected-access


# ------------------------------------------ X and K3 on csrc/tma_gemm.cuh

# (n, h, w, C_in, C_out) of X: the four served shapes (conv_up and conv_out
# at both grids of a 480x480 video), the card tests' shapes and the edges
# (single-pixel frames, C_in below and over one K step, C_out over one tile).
X_SHAPES = [(250, 60, 60, 256, 1024), (250, 60, 60, 1024, 256),
            (250, 32, 32, 256, 1024), (250, 32, 32, 1024, 256),
            (3, 9, 7, 128, 512), (2, 11, 13, 256, 1024), (1, 1, 1, 16, 16),
            (2, 6, 9, 48, 272), (1, 5, 6, 1024, 256)]
# (B, T, C, H) of K3: the served block, the causal shapes chip_smoke.py
# checks, the card tests' shapes and the edges.
K3_SHAPES = [(128, 250, 512, 2048), (32, 8, 512, 2048), (3, 13, 64, 256),
             (5, 37, 128, 512), (2, 150, 48, 208), (7, 19, 40, 160)]
H100_SMS = 132


def _check_gemm(g, m, n, k_bytes, tile_n=256):
  assert (g["m"], g["n"], g["tile_n"]) == (m, n, tile_n)
  assert 0 < g["smem_bytes"] <= SMEM_LIMIT
  assert g["threads"] == 384 and g["stages"] >= 3
  assert (g["tiles_m"] - 1) * 128 < m <= g["tiles_m"] * 128
  assert (g["tiles_n"] - 1) * tile_n < n <= g["tiles_n"] * tile_n
  assert (g["k_steps"] - 1) * 128 < k_bytes <= g["k_steps"] * 128
  assert g["tiles"] == g["tiles_m"] * g["tiles_n"]
  assert g["grid"] == min(g["tiles"], H100_SMS)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,cout", X_SHAPES)
def test_x_plan_fits_the_card(dtype, n, h, w, cin, cout):
  plan = qconv.q8_frame_launch_plan(n, h, w, cin, cout, dtype)
  rows = n * (h + 2) * (w + 2)
  assert plan["xq_shape"] == (n, h + 2, w + 2, cin)
  assert plan["padded_rows"] == rows
  # K is nine taps of whole 128-channel steps (zeros past C_in).
  _check_gemm(plan["gemm"], rows, cout, 9 * -(-cin // 128) * 128)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,c,hid", K3_SHAPES)
def test_k3_plan_fits_the_card(dtype, b, t, c, hid):
  plan = fused_mixer_block.launch_plan(b, t, c, hid, dtype)
  rows = b * t
  assert plan["rows"] == rows
  assert plan["temporal"]["grid"] == b * -(-t // 16)
  assert 0 < plan["temporal"]["smem_bytes"] <= SMEM_LIMIT
  # bf16: 128 x 256 tiles; float32 (error-compensated TF32): 128 x 128, the
  # stage's two B boxes being the big and small parts of 128 columns.
  elt, tile_n = (2, 256) if dtype == torch.bfloat16 else (4, 128)
  _check_gemm(plan["gemm_up"], rows, hid, elt * c, tile_n)
  _check_gemm(plan["gemm_down"], rows, c, elt * hid, tile_n)
  assert plan["gemm_smem_bytes"] == plan["gemm_up"]["smem_bytes"]


def test_served_tma_plans():
  """The numbers PERF.md and the kernels' notes state for the served shapes."""
  up60 = qconv.q8_frame_launch_plan(250, 60, 60, 256, 1024)
  assert (up60["gemm"]["tiles_m"], up60["gemm"]["tiles_n"],
          up60["gemm"]["k_steps"]) == (7508, 4, 18)
  # The ring rows computed and dropped: 6.8% more rows at 60x60, 13% at 32x32.
  assert round(up60["padded_rows"] / (250 * 60 * 60) - 1, 4) == 0.0678
  out32 = qconv.q8_frame_launch_plan(250, 32, 32, 1024, 256)
  assert (out32["gemm"]["tiles_m"], out32["gemm"]["tiles_n"],
          out32["gemm"]["k_steps"]) == (2258, 1, 72)
  assert round(out32["padded_rows"] / (250 * 32 * 32) - 1, 4) == 0.1289
  k3 = fused_mixer_block.launch_plan(128, 250, 512, 2048)
  assert (k3["gemm_up"]["tiles_m"], k3["gemm_up"]["tiles_n"],
          k3["gemm_up"]["k_steps"]) == (250, 8, 8)
  assert (k3["gemm_down"]["tiles_m"], k3["gemm_down"]["tiles_n"],
          k3["gemm_down"]["k_steps"]) == (250, 2, 32)
  # Four stages of a 128 x 128-byte A box and a 256 x 128-byte B tile, the
  # 1024-byte alignment slack, eight mbarriers and the epilogue's staging
  # (16 rows of 144 bytes for each of the 8 consumer warps).
  assert (k3["gemm_smem_bytes"] == up60["gemm"]["smem_bytes"]
          == 1024 + 4 * (128 + 256) * 128 + 8 * 8 + 8 * 16 * 144 == 216_128)
  # float32: 128 x 128 tiles, K steps of 32 values, the same ring and bytes.
  f32 = fused_mixer_block.launch_plan(128, 250, 512, 2048, torch.float32)
  assert (f32["gemm_up"]["tiles_m"], f32["gemm_up"]["tiles_n"],
          f32["gemm_up"]["k_steps"]) == (250, 16, 16)
  assert (f32["gemm_down"]["tiles_m"], f32["gemm_down"]["tiles_n"],
          f32["gemm_down"]["k_steps"]) == (250, 4, 64)
  assert f32["gemm_smem_bytes"] == 216_128


def test_tma_plan_mirrors_the_header():
  """The plan's tile, ring and register numbers are tma_gemm.cuh's."""
  head = _constants(_source("tma_gemm.cuh"),
                    ["kBM", "kBN", "kBK", "kBoxRows", "kStages", "kConsumers",
                     "kSmemAlign", "kProducerRegs", "kConsumerRegs",
                     "kChunkBytes"])
  assert (head["kBM"], head["kBN"], head["kBK"], head["kBoxRows"]) == (
      tma_gemm.TILE_M, tma_gemm.TILE_N, tma_gemm.K_BYTES, tma_gemm.BOX_ROWS)
  assert (head["kStages"], head["kConsumers"], head["kSmemAlign"]) == (
      tma_gemm.STAGES, tma_gemm.CONSUMERS, tma_gemm.SMEM_ALIGN)
  assert (head["kProducerRegs"], head["kConsumerRegs"]) == (
      tma_gemm.PRODUCER_REGS, tma_gemm.CONSUMER_REGS)
  assert head["kChunkBytes"] == tma_gemm.CHUNK_BYTES
  assert _constants(_source("tma_gemm.cuh"), ["kBNTf32"])["kBNTf32"] == (
      tma_gemm.TILE_N_TF32)
  # A Tf32x3 stage holds the same bytes: a 128-row A box and the big and
  # small B boxes of its 128 columns.
  assert tma_gemm.STAGE_BYTES == (tma_gemm.TILE_M + 2 * tma_gemm.TILE_N_TF32) * 128
  # setmaxnreg hands the consumers what the producer gives up: the 384
  # threads must start with (2 * 232 + 40) / 3 = 168 registers, which the
  # launcher checks, and the register file (65,536) must hold them.
  launch_regs = (tma_gemm.CONSUMERS * tma_gemm.CONSUMER_REGS
                 + tma_gemm.PRODUCER_REGS) // (tma_gemm.CONSUMERS + 1)
  assert launch_regs == 168 and launch_regs * tma_gemm.THREADS <= 65_536
  assert tma_gemm.BOX_ROWS * 2 == tma_gemm.TILE_N  # two B boxes a stage
  assert tma_gemm.TILE_M == 64 * tma_gemm.CONSUMERS  # a wgmma m64 each


X_REFUSED = [
    ((1, 4, 4, 24, 64, torch.float32), ValueError, "multiples of 16"),
    ((1, 4, 4, 32, 40, torch.bfloat16), ValueError, "multiples of 16"),
    ((0, 4, 4, 32, 64, torch.float32), ValueError, "empty"),
    ((1, 4, 4, 32, 64, torch.float16), TypeError, "float32 or bfloat16"),
]
K3_REFUSED = [
    ((2, 5, 12, 64, torch.bfloat16), ValueError, "multiples of 8"),
    ((2, 5, 32, 36, torch.bfloat16), ValueError, "multiples of 8"),
    ((2, 5, 10, 64, torch.float32), ValueError, "multiples of 4"),
    ((2, 5, 32, 18, torch.float32), ValueError, "multiples of 4"),
    ((2, 0, 32, 128, torch.float32), ValueError, "empty"),
    ((2, 5, 32, 128, torch.float16), TypeError, "float32 or bfloat16"),
]


@pytest.mark.parametrize("args,error,match", X_REFUSED,
                         ids=["cin24", "cout40", "empty", "fp16"])
def test_x_plan_refuses(args, error, match):
  with pytest.raises(error, match=match):
    qconv.q8_frame_launch_plan(*args)


@pytest.mark.parametrize("args,error,match", K3_REFUSED,
                         ids=["c12_bf16", "h36_bf16", "c10_fp32", "h18_fp32",
                              "empty", "fp16"])
def test_k3_plan_refuses(args, error, match):
  with pytest.raises(error, match=match):
    fused_mixer_block.launch_plan(*args)


def test_k3_fp32_plan_takes_any_width():
  """The fp32 GEMMs take widths the bf16 TMA boxes do not: any multiple of
  4 (16 bytes of float32), where bf16 needs multiples of 8."""
  plan = fused_mixer_block.launch_plan(2, 5, 12, 36, torch.float32)
  assert plan["gemm_up"]["n"] == 36 and plan["gemm_down"]["n"] == 12


X_WRAPPER_SHAPES = [(1, 3, 4, 16, 32), (2, 5, 5, 48, 272), (1, 1, 1, 16, 16),
                    (1, 3, 4, 24, 32), (1, 3, 4, 32, 40)]
K3_WRAPPER_SHAPES = [(2, 5, 32, 128), (1, 7, 48, 208), (2, 5, 12, 64),
                     (2, 5, 32, 36), (2, 5, 10, 64)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,cout", X_WRAPPER_SHAPES)
def test_x_wrapper_checks_agree_with_the_plan(no_library, dtype, n, h, w, cin, cout):  # pylint: disable=redefined-outer-name,unused-argument
  gen = torch.Generator().manual_seed(0)
  x = torch.randn(n, cin, h, w, generator=gen).to(dtype)
  qweights = qconv.quantize_conv_weight(torch.randn(cout, cin, 3, 3, generator=gen))
  expected = _plan_outcome(qconv.q8_frame_launch_plan, n, h, w, cin, cout, dtype)
  with pytest.raises(expected):
    qconv._launch_q8(x, qweights, torch.randn(cout, generator=gen))  # pylint: disable=protected-access


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,c,hid", K3_WRAPPER_SHAPES)
def test_k3_wrapper_checks_agree_with_the_plan(no_library, dtype, b, t, c, hid):  # pylint: disable=redefined-outer-name,unused-argument
  gen = torch.Generator().manual_seed(0)
  f = lambda *s: torch.randn(*s, generator=gen).to(dtype)
  args = [f(b, t, c), f(c), f(3, 1, 4 * c), f(4 * c), f(3, 1, 4 * c),
          f(4 * c), f(c), f(c, hid), f(hid), f(hid, c), f(c)]
  expected = _plan_outcome(fused_mixer_block.launch_plan, b, t, c, hid, dtype)
  with pytest.raises(expected):
    fused_mixer_block._launch(*args, False, None)  # pylint: disable=protected-access


def test_mixer_module_hands_the_kernel_its_weights_in_place():
  """MixerBlock passes its Linear weights as `weight.t()`: the K-major layout
  the bf16 GEMMs' TMA boxes read is the weight's own storage, with no copy
  per call; a weight in any other layout is copied."""
  block = layers.MixerBlock(64)
  for lin in (block.fc_up, block.fc_down):
    kernel_w = fused_mixer_block._linear_layout(lin.weight.t())  # pylint: disable=protected-access
    assert kernel_w.data_ptr() == lin.weight.data_ptr()
  w = torch.randn(64, 256)
  assert fused_mixer_block._linear_layout(w).data_ptr() != w.data_ptr()  # pylint: disable=protected-access


# ------------------------------------------------- K6f on csrc/tma_gemm.cuh

# (n, h, w, C, M) of K6f: the served grids of a 480x480 video (M = 4C), the
# card tests' shapes (tests/test_torch_cuda.py) and the edges (single-pixel
# frames, C = 16 below one K step, M no multiple of 64).
K6F_SHAPES = [(250, 60, 60, 256, 1024), (250, 32, 32, 256, 1024),
              (2, 9, 7, 128, 512), (1, 11, 13, 256, 1024), (3, 5, 5, 64, 256),
              (2, 6, 37, 32, 128), (4, 20, 20, 64, 256), (2, 1, 1, 16, 64),
              (1, 3, 4, 48, 80)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w,c,m", K6F_SHAPES)
def test_k6f_plan_fits_the_card(dtype, n, h, w, c, m):
  plan = fused_extra_convs.fp_launch_plan(n, h, w, c, m, dtype)
  rows = n * h * w
  assert plan["rows"] == rows
  padded = n * (h + 2) * (w + 2)
  assert plan["padded_rows"] == padded
  assert plan["t_shape"] == (n, h + 2, w + 2, c)
  assert plan["hidden_shape"] == (n, h + 2, w + 2, m)
  # K is nine taps of whole 128-byte steps of channels (zeros past C): 64
  # bf16 or 32 float32 values; float32 on 128-column Tf32x3 tiles, its
  # weights' two TF32 parts in the split scratch.
  elt, tile_n = (4, 128) if dtype == torch.float32 else (2, 256)
  _check_gemm(plan["up"], padded, m, 9 * -(-elt * c // 128) * 128, tile_n)
  _check_gemm(plan["out"], padded, c, 9 * -(-elt * m // 128) * 128, tile_n)
  assert plan["split_elements"] == (2 * 2 * 9 * m * c
                                    if dtype == torch.float32 else 0)
  assert (plan["gemm_smem_bytes"] == plan["up"]["smem_bytes"]
          == plan["out"]["smem_bytes"] == tma_gemm.SMEM_BYTES)


def test_served_k6f_plans():
  """The numbers PERF.md and the kernel's notes state for the served
  shapes: in bf16, 36 K steps a conv_up tile (9 taps x 4), 144 a conv_out
  tile, four N tiles of conv_up and one of conv_out, and the padded hidden
  (1.97 GB at 60x60, against 1.84 GB dense); in float32, 72 and 288 K steps
  on eight and two 128-column N tiles, the padded hidden 3.94 GB (3.69
  dense), and the split weights 18.9 MB a conv, 2.36 MB of conv_up's and
  9.44 MB of conv_out's a tile."""
  p60 = fused_extra_convs.fp_launch_plan(250, 60, 60, 256, 1024)
  assert (p60["up"]["tiles_m"], p60["up"]["tiles_n"], p60["up"]["k_steps"]) == (
      7508, 4, 36)
  assert (p60["out"]["tiles_m"], p60["out"]["tiles_n"],
          p60["out"]["k_steps"]) == (7508, 1, 144)
  assert p60["padded_rows"] == 961_000
  assert round(p60["padded_rows"] * 1024 * 2 / 1e9, 2) == 1.97
  assert round(250 * 60 * 60 * 1024 * 2 / 1e9, 2) == 1.84
  p32 = fused_extra_convs.fp_launch_plan(250, 32, 32, 256, 1024)
  assert p32["padded_rows"] == 250 * 34 * 34 and p32["up"]["tiles_m"] == 2258
  f60 = fused_extra_convs.fp_launch_plan(250, 60, 60, 256, 1024, torch.float32)
  assert (f60["up"]["tiles_m"], f60["up"]["tiles_n"], f60["up"]["k_steps"]) == (
      7508, 8, 72)
  assert (f60["out"]["tiles_m"], f60["out"]["tiles_n"],
          f60["out"]["k_steps"]) == (7508, 2, 288)
  assert round(f60["padded_rows"] * 1024 * 4 / 1e9, 2) == 3.94
  assert round(250 * 60 * 60 * 1024 * 4 / 1e9, 2) == 3.69
  assert round(f60["split_elements"] * 4 / 2 / 1e6, 1) == 18.9
  assert round(2 * 128 * 9 * 256 * 4 / 1e6, 2) == 2.36
  assert round(2 * 128 * 9 * 1024 * 4 / 1e6, 2) == 9.44


def test_k6f_plan_mirrors_the_sources():
  """The plan steps K by the header's 128 bytes (64 bf16 or 32 float32
  values) over ceil(e C / 128) steps a tap, as X's int8 plan does over
  ceil(C / 128); float32 runs on tg::Tf32x3, whose tiles are the plan's,
  with the split weights [2 cout, 9, cin] as the B map's rows and the
  scratch the plan counts (two convs of 2 * 9 * m * c values); the entry
  refuses a float32 call without it and any plan whose shared memory is
  not the loop's. The SIMT float32 loop is gone."""
  src = _source("extra_convs.cu")
  header = _source("tma_gemm.cuh")
  assert "const SlabLoader ld{per_tap, w + 2, tg::kBK / Op::kElem};" in src
  assert ("const uint64_t row_bytes = static_cast<uint64_t>(cin) * Op::kElem;"
          in src)
  assert ("const int per_tap = static_cast<int>((row_bytes + tg::kBK - 1) / "
          "tg::kBK);" in src)
  assert src.count("conv3x3_slab<tg::Bf16>(") == 1
  assert src.count("conv3x3_slab<tg::Tf32x3>(") == 1
  assert src.count("conv3x3_slab<tg::S8>(") == 1
  assert "tg::gemm<tg::Tf32x3>(smem_raw" in src
  assert ("static_cast<uint64_t>(cout) * (std::is_same<Op, tg::Tf32x3>::value "
          "? 2 : 1);" in src)
  assert "const long long count = 9LL * m * c;" in src
  assert src.count("tg::split_weights(") == 2 and "split + 2 * count" in src
  assert ("gemm_smem != tg::kSmemBytes || (dtype == 0 && wsplit == nullptr)"
          in src)
  assert _constants(header, ["kBNTf32"])["kBNTf32"] == tma_gemm.TILE_N_TF32
  assert "return n0 + half * n;" in header  # Tf32x3::b_row: the small half
  # The mma.sync and SIMT loops are gone: every product is tg::gemm.
  for gone in ("mma.sync", "conv3x3_f32", "ConvParams", "fmaf("):
    assert gone not in src, gone
  assert "conv3x3_bf16_tma" in src and "conv3x3_tf32x3_tma" in src
  # The C entry takes the twelve pointers the wrapper passes.
  entry = src[src.index("int extra_convs_fp_forward("):]
  entry = entry[:entry.index(")")]
  assert entry.count("void*") == 12 + 1  # and the stream
  assert qconv.SIGNATURES["extra_convs_fp_forward"][:12] == [
      ctypes.c_void_p] * 12


K6F_REFUSED = [
    ((1, 4, 4, 24, 96, torch.bfloat16), ValueError, "multiples of 16"),
    ((1, 4, 4, 32, 40, torch.float32), ValueError, "multiples of 16"),
    ((0, 4, 4, 32, 128, torch.bfloat16), ValueError, "empty"),
    ((1, 4, 4, 32, 128, torch.float16), TypeError, "float32 or bfloat16"),
    ((600_000, 60, 60, 16, 64, torch.float32), ValueError, "overflow"),
    ((580_000, 60, 60, 16, 64, torch.bfloat16), ValueError, "overflow"),
]


@pytest.mark.parametrize("args,error,match", K6F_REFUSED,
                         ids=["c24", "m40", "empty", "fp16", "rows_fp32",
                              "padded_rows_bf16"])
def test_k6f_plan_refuses(args, error, match):
  with pytest.raises(error, match=match):
    fused_extra_convs.fp_launch_plan(*args)


def test_k6f_padded_rows_bound_is_the_kernels():
  """580,000 60x60 frames fit the dense pixel index but not the padded
  rows' coordinates (rows + a tile + a row and a pixel of the ring), in
  either dtype; 550,000 fit both."""
  assert 580_000 * 60 * 60 + 128 < tma_gemm.INT32_MAX
  assert 580_000 * 62 * 62 + 60 + 3 + 128 > tma_gemm.INT32_MAX
  for dtype in DTYPES:
    with pytest.raises(ValueError, match="padded rows overflow"):
      fused_extra_convs.fp_launch_plan(580_000, 60, 60, 16, 64, dtype)
    fused_extra_convs.fp_launch_plan(550_000, 60, 60, 16, 64, dtype)


K6F_WRAPPER_SHAPES = [(1, 3, 4, 16, 64), (2, 5, 5, 32, 128), (1, 3, 4, 24, 96),
                      (1, 3, 4, 32, 40), (2, 1, 1, 16, 64)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,w,c,m", K6F_WRAPPER_SHAPES)
def test_k6f_wrapper_checks_agree_with_the_plan(no_library, dtype, n, h, w, c, m):  # pylint: disable=redefined-outer-name,unused-argument
  gen = torch.Generator().manual_seed(0)
  f = lambda *s: torch.randn(*s, generator=gen)
  args = [f(n, h, w, c).to(dtype), f(c), f(c), f(3, 3, c, m), f(m),
          f(3, 3, m, c), f(c)]
  expected = _plan_outcome(fused_extra_convs.fp_launch_plan, n, h, w, c, m, dtype)
  with pytest.raises(expected):
    fused_extra_convs._launch_fp(*args)  # pylint: disable=protected-access


# --------------------------------------------- K1: loop and queries per block

# (C, element bytes, aligned bases) -> K1's loop: the row-wise loop wherever
# a position is a power of two of 16-byte pieces (4 to 128) at aligned
# bases, the scalar loop elsewhere.
K1_LOOPS = [
    ((128, 2, True), "rows"), ((256, 2, True), "rows"), ((128, 4, True), "rows"),
    ((256, 4, True), "rows"), ((32, 2, True), "rows"), ((16, 4, True), "rows"),
    ((512, 4, True), "rows"), ((1024, 2, True), "rows"), ((16, 2, True), "scalar"),
    ((40, 4, True), "scalar"), ((48, 2, True), "scalar"), ((8, 4, True), "scalar"),
    ((1024, 4, True), "scalar"), ((128, 2, False), "scalar"),
    ((256, 4, False), "scalar"),
]


@pytest.mark.parametrize("args,loop", K1_LOOPS)
def test_k1_loop_by_width_and_alignment(args, loop):
  c, elt, aligned = args
  dtype = torch.float32 if elt == 4 else torch.bfloat16
  plan = corr_tents.float_launch_plan(250, 30, 30, c, 128, dtype, aligned)
  assert plan["loop"] == loop
  assert corr_tents.float_rows_ok(c, elt, aligned) == (loop == "rows")
  assert plan["smem_bytes"] == (
      0 if loop == "rows" else 4 * plan["queries_per_block"] * c)


def test_k1_queries_per_block_fill_the_card():
  """Served 480x480 grids (250 frames x 128 queries): 8 queries a block, a
  warp each, at the 30x30 grid; 4 at 60x60 and 2 at 120x120 in bf16 (2 and
  1 in float32), so that the frames the resident blocks cover keep their
  grid within 32 MB of L2. An online step (1 frame x 64 queries): a query a
  block and its 8 warps split the window rows, 64 blocks in place of 8."""
  served = corr_tents.float_launch_plan(250, 30, 30, 256, 128)
  assert (served["queries_per_block"], served["warps_per_query"],
          served["grid"]) == (8, 1, (16, 250))
  by_level = {
      dtype: [corr_tents.float_launch_plan(250, h, h, c, 128, dtype)
              ["queries_per_block"] for h, c in ((120, 128), (60, 256), (30, 256))]
      for dtype in (torch.bfloat16, torch.float32)}
  assert by_level == {torch.bfloat16: [2, 4, 8], torch.float32: [1, 2, 8]}
  for h, c in ((64, 128), (32, 256), (16, 256)):
    online = corr_tents.float_launch_plan(1, h, h, c, 64, torch.float32)
    assert (online["queries_per_block"], online["warps_per_query"],
            online["grid"]) == (1, 8, (64, 1))
  # Between the two: the largest block that still gives 528 blocks.
  mid = corr_tents.float_launch_plan(8, 16, 16, 128, 256)
  assert mid["queries_per_block"] == 2 and mid["grid"] == (128, 8)
  for bt, n in ((1, 1), (3, 37), (250, 128), (2, 1000)):
    plan = corr_tents.float_launch_plan(bt, 20, 20, 64, n)
    qpb = plan["queries_per_block"]
    assert qpb in (1, 2, 4, 8) and plan["warps_per_query"] * qpb == 8
    assert plan["grid"] == (-(-n // qpb), bt)


def test_k1_plan_mirrors_the_source():
  text = _source("corr_tents.cu")
  found = _constants(text, ["kWarps", "kMaxLanePieces"])
  assert found["kWarps"] == corr_tents._WARPS  # pylint: disable=protected-access
  assert found["kMaxLanePieces"] == corr_tents._MAX_LANE_PIECES  # pylint: disable=protected-access


@pytest.mark.parametrize("args,error,match", [
    ((0, 4, 4, 64, 5, torch.float32), ValueError, "empty"),
    ((1, 4, 4, 64, 5, torch.float16), TypeError, "float32 or bfloat16"),
    ((65536, 4, 4, 64, 5, torch.float32), ValueError, "overflow"),
], ids=["empty", "fp16", "grid_overflow"])
def test_k1_plan_refuses(args, error, match):
  with pytest.raises(error, match=match):
    corr_tents.float_launch_plan(*args)


# ------------------------------- K2 and K2b: the int8 kernel's loop and plan

# (C, aligned bases) -> the int8 kernel's loop: row-wise for C = 16 * 2^k
# from 64 to 512 at 16-byte aligned bases, word-wise elsewhere (the small
# configurations' 16 and 32, widths of no power of two, a base off 16 bytes).
K2_LOOPS = [
    ((128, True), "rows"), ((256, True), "rows"), ((64, True), "rows"),
    ((512, True), "rows"), ((16, True), "words"), ((32, True), "words"),
    ((40, True), "words"), ((192, True), "words"), ((1024, True), "words"),
    ((128, False), "words"), ((256, False), "words"),
]


@pytest.mark.parametrize("args,loop", K2_LOOPS)
def test_k2_loop_by_width_and_alignment(args, loop):
  c, aligned = args
  plan = corr_tents.q8_launch_plan(250, 30, 30, c, 128, aligned)
  assert plan["loop"] == loop
  assert corr_tents.q8_rows_ok(c, aligned) == (loop == "rows")
  # The word-wise loop keeps each warp's int8 query in shared memory.
  assert plan["smem_bytes"] == (0 if loop == "rows" else 8 * c)


# (bt, h, w, C, n) -> queries a block: the served 480x480 grids (250 frames x
# 128 queries; the hires grid's 1.8 MB frames put 4 a block, so that the
# frames in flight hold at most 32 MB), the headline's 1024 queries, and a
# one-frame call of 64 queries, which falls to a query a block so that the
# card gets 64 blocks and not 8.
K2_PLANS = [
    ((250, 120, 120, 128, 128), 4), ((250, 60, 60, 256, 128), 8),
    ((250, 30, 30, 256, 128), 8), ((250, 120, 120, 128, 1024), 8),
    ((250, 60, 60, 256, 1024), 8), ((250, 30, 30, 256, 1024), 8),
    ((1, 64, 64, 128, 64), 1), ((1, 16, 16, 256, 64), 1), ((8, 16, 16, 128, 256), 2),
]


@pytest.mark.parametrize("shape,qpb", K2_PLANS)
def test_k2_queries_per_block(shape, qpb):
  bt, h, w, c, n = shape
  plan = corr_tents.q8_launch_plan(bt, h, w, c, n)
  assert plan["queries_per_block"] == qpb
  assert plan["warps_per_query"] * qpb == 8
  assert plan["grid"] == (-(-n // qpb), bt)
  blocks = plan["grid"][0] * bt
  # At least 528 blocks where 8 queries a block would give fewer, and at
  # most 32 MB of int8 grid in the frames the resident blocks cover.
  assert blocks >= 528 or qpb == 1
  frames = min(bt, 396 / plan["grid"][0])
  assert frames * h * w * c <= 32 * 2**20 or qpb == 1
  # The int8 grid is half the bf16 one: never fewer queries a block than K1.
  assert qpb >= corr_tents.float_launch_plan(bt, h, w, c, n)["queries_per_block"]


def test_k2_plan_mirrors_the_source():
  text = _source("corr_tents.cu")
  found = _constants(text, ["kWarps", "kQ8MinRowWidth", "kQ8MaxRowWidth"])
  assert found["kWarps"] == corr_tents._WARPS  # pylint: disable=protected-access
  assert (found["kQ8MinRowWidth"], found["kQ8MaxRowWidth"]) == (
      corr_tents._Q8_ROW_WIDTHS)  # pylint: disable=protected-access
  # kTileN is kWarps: a block takes at most a query a warp.
  assert re.search(r"\bkTileN = kWarps\b", text)
  # The C side refuses a queries-per-block count or loop of no plan.
  assert re.search(r"qpb != 1 && qpb != 2 && qpb != 4 && qpb != 8", text)
  assert "rows != static_cast<int>(q8_rows_ok(grid, query, c))" in text


@pytest.mark.parametrize("args,match", [
    ((0, 4, 4, 64, 5), "empty"), ((2, 4, 4, 64, 0), "empty"),
    ((65536, 4, 4, 64, 5), "overflow"), ((2, 4, 4, 6, 5), "multiple of 4"),
    ((2, 4, 4, 130, 5), "multiple of 4"),
], ids=["no_frames", "no_queries", "grid_overflow", "c6", "c130"])
def test_k2_plan_refuses(args, match):
  with pytest.raises(ValueError, match=match):
    corr_tents.q8_launch_plan(*args)

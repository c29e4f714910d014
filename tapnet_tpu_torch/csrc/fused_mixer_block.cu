// One PIPs-mixer block, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tapnet_tpu/ops/fused_mixer_block.py::_kernel
// (launched by _pallas_forward), full-precision path (fp32 and bf16):
//
//   x1 = x + fold(dwconv_mix(gelu(dwconv_up(LN1(x)))))      (temporal half)
//   y  = x1 + W2 . gelu(W1 . LN2(x1) + b1) + b2             (channel MLP)
//
// over x [rows, T, C]; rows at or beyond `t_real` come out exactly zero and
// are treated as absent (zero) by the temporal convolutions.
//
// Design: three launches from one file.
//   (a) mixer_temporal: one block per (row, tile of 16 time steps). LN1 of the
//       tile plus its 2-step temporal halo goes to shared memory in float32;
//       each thread owns a channel and runs the depthwise pair over its mult
//       lanes in registers (the c-major weight layout [k, 1, C*mult] gives a
//       thread its mult*k taps contiguously, so no re-layout is needed), adds
//       the residual, then one warp per row takes LN2. Writes x1 and the MLP
//       operand LN2(x1) in the compute dtype.
//   (b) gemm (W1): hidden = gelu(LN2(x1) . W1^T + b1) into [rows*T, 4C].
//   (c) gemm (W2): y = x1 + (hidden . W2^T + b2), rows >= t_real zeroed.
// The GEMMs are written here: bf16 on the tensor cores with WMMA (mma.sync
// underneath), 128x128x32 tiles double-buffered through cp.async, float32
// accumulation; fp32 on SIMT 64x64 tiles with 4x4 register blocks.
//
// The w8a8 block (mixer_block_q8_forward) replaces the same TPU kernel with
// quantized=True (_mlp_operand, _mlp_hidden, _mlp_epilogue). Five launches:
//   (a') mixer_temporal<Q>: as (a), but LN2's float32 output is quantized per
//        row (amax floored at 1e-8, x * (127 / amax), round half to even, clip
//        to +-127) into int8 [rows*T, C] with its scale amax / 127.
//   (b') mixer_gemm_q8<gelu>: int8 x int8 -> int32 on the tensor cores (WMMA
//        s8 m16n16k16, 128x128x64 tiles through cp.async); the epilogue does
//        acc * (xs * s1) + b1 and GELU in float32, writes the float32 hidden
//        and raises the row's amax with atomicMax on the bits of |h| (ordered
//        as integers for non-negative floats), because a row's amax spans
//        every column tile.
//   (c') mixer_quantize_rows: the hidden, from its float32 value, to int8 and
//        its row scale.
//   (d') mixer_gemm_q8<residual>: the second int8 product; the epilogue does
//        acc * (hs * s2) + b2, rounds to the compute dtype, adds x1 and zeroes
//        rows >= t_real.
// bf16 enters only at x, x1 and the output. Bound on the H100: 134 G integer
// operations at 1979 TOP/s dense int8 (0.07 ms) against the activations'
// bytes. What this first design gives away: the float32 hidden [rows*T, 4C]
// (262 MB at [128, 250, 512]) is written and read once and its int8 form
// again, about 0.25 ms of memory traffic at 3.35 TB/s, and WMMA reaches a
// fraction of the int8 peak. A later design keeps a row block's whole hidden
// on chip.
//
// Numerics as in the JAX kernel: LN eps 1e-5 with float32 statistics (LN1
// single-pass, LN2 two-pass as in mixer_math.mlp_math), GELU tanh, float32
// accumulation, depthwise fold bias = sum over the mult lanes of b_mix.
//
// Bound on the H100: the two products, 2 * 2 * rows*T * C * 4C flops (about
// 134 GFLOP per launch at [128, 250, 512], 0.14 ms at 989 TFLOP/s bf16)
// against ~70 MB of activations (0.02 ms at 3.35 TB/s): compute-bound. What
// this first design gives away: the [rows*T, 4C] hidden makes a round trip
// through device memory between (b) and (c) (the TPU kernel kept it in VMEM),
// and WMMA without TMA/wgmma reaches a fraction of the tensor-core peak. A
// later design fuses (b) and (c) on wgmma with the hidden kept on chip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-5f;
constexpr int kThreads = 256;
constexpr int kTileT = 16;  // time steps per temporal block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(inner));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- (a)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Symmetric int8 quantization, as mixer_math.quantize_rows: the caller gives
// inv = 127 / max(amax, 1e-8); the row's scale is max(amax, 1e-8) * (1 / 127).
constexpr float kAmaxFloor = 1e-8f;
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ int8_t quantize(float v, float inv) {
  return static_cast<int8_t>(
      fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f));
}

// Q: write the MLP operand as int8 rows (q_out, with q_scale [rows*T]) in
// place of mlp_in.
template <typename T, int K, bool Q>
__global__ void __launch_bounds__(kThreads)
    mixer_temporal(const T* __restrict__ x, const T* __restrict__ g1,
                   const T* __restrict__ wu, const T* __restrict__ bu,
                   const T* __restrict__ wm, const T* __restrict__ bm,
                   const T* __restrict__ g2, T* __restrict__ x1_out,
                   T* __restrict__ mlp_in, int8_t* __restrict__ q_out,
                   float* __restrict__ q_scale, int t_full, int t_real, int c,
                   int mult, int off) {
  extern __shared__ float xs[];  // [kTileT + 2*(K-1), c]
  constexpr int kRows = kTileT + 2 * (K - 1);
  const int ntiles = (t_full + kTileT - 1) / kTileT;
  const int row = blockIdx.x / ntiles;
  const int t0 = (blockIdx.x % ntiles) * kTileT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = kThreads / 32;
  const T* xr = x + static_cast<size_t>(row) * t_full * c;
  const float inv_c = 1.f / static_cast<float>(c);

  // LN1 (single-pass statistics) of time steps t0 - 2*off ... ; steps
  // outside [0, t_real) are the convolution's zero padding.
  for (int r = warp; r < kRows; r += nwarps) {
    const int t = t0 - 2 * off + r;
    float* dst = xs + r * c;
    if (t < 0 || t >= t_real) {
      for (int k = lane; k < c; k += 32) dst[k] = 0.f;
      continue;
    }
    const T* src = xr + static_cast<size_t>(t) * c;
    float s = 0.f, s2 = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float v = to_f(src[k]);
      s += v;
      s2 += v * v;
    }
    const float mu = warp_sum(s) * inv_c;
    const float var = warp_sum(s2) * inv_c - mu * mu;
    const float rs = rsqrtf(var + kEps);
    for (int k = lane; k < c; k += 32) {
      dst[k] = (to_f(src[k]) - mu) * rs * to_f(g1[k]);
    }
  }
  __syncthreads();

  // Depthwise pair per channel. Hidden step tau = t0 - off + u reads LN1
  // rows u .. u+K-1 of the tile; output step t0 + t reads hidden t .. t+K-1.
  const int lanes = c * mult;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float acc[kTileT];
#pragma unroll
    for (int t = 0; t < kTileT; ++t) acc[t] = 0.f;
    float bfold = 0.f;
    for (int m = 0; m < mult; ++m) {
      const int l = ch * mult + m;
      float wuj[K], wmj[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        wuj[j] = to_f(wu[j * lanes + l]);
        wmj[j] = to_f(wm[j * lanes + l]);
      }
      const float bum = to_f(bu[l]);
      bfold += to_f(bm[l]);
      float hv[kTileT + K - 1];
#pragma unroll
      for (int u = 0; u < kTileT + K - 1; ++u) {
        float v = bum;
#pragma unroll
        for (int j = 0; j < K; ++j) v = fmaf(xs[(u + j) * c + ch], wuj[j], v);
        const int tau = t0 - off + u;
        hv[u] = (tau >= 0 && tau < t_real) ? gelu_tanh(v) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kTileT; ++t) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) s = fmaf(hv[t + j], wmj[j], s);
        acc[t] += s;
      }
    }
    // Residual. Column ch of xs is read only by this thread, so its first
    // kTileT rows can take x1 now.
#pragma unroll
    for (int t = 0; t < kTileT; ++t) {
      const int tg = t0 + t;
      if (tg < t_full) {
        const size_t idx = static_cast<size_t>(tg) * c + ch;
        const float v = round_to<T>(to_f(xr[idx]) + round_to<T>(acc[t] + bfold));
        xs[t * c + ch] = v;
        x1_out[static_cast<size_t>(row) * t_full * c + idx] = from_f<T>(v);
      }
    }
  }
  __syncthreads();

  // LN2 (two-pass statistics), the channel-MLP operand.
  for (int r = warp; r < kTileT; r += nwarps) {
    const int tg = t0 + r;
    if (tg >= t_full) break;
    float* src = xs + r * c;
    float s = 0.f;
    for (int k = lane; k < c; k += 32) s += src[k];
    const float mu = warp_sum(s) * inv_c;
    float s2 = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float d = src[k] - mu;
      s2 += d * d;
    }
    const float rs = rsqrtf(warp_sum(s2) * inv_c + kEps);
    const size_t orow = static_cast<size_t>(row) * t_full + tg;
    if (Q) {
      // The normalized row stays float32 (kept in xs: a lane reads back only
      // what it wrote) and is quantized from that.
      float amax = 0.f;
      for (int k = lane; k < c; k += 32) {
        const float v = (src[k] - mu) * rs * to_f(g2[k]);
        src[k] = v;
        amax = fmaxf(amax, fabsf(v));
      }
      amax = fmaxf(warp_max(amax), kAmaxFloor);
      const float inv = 127.f / amax;
      int8_t* qdst = q_out + orow * c;
      for (int k = lane; k < c; k += 32) qdst[k] = quantize(src[k], inv);
      if (lane == 0) q_scale[orow] = amax * kInv127;
    } else {
      T* dst = mlp_in + orow * c;
      for (int k = lane; k < c; k += 32) {
        dst[k] = from_f<T>((src[k] - mu) * rs * to_f(g2[k]));
      }
    }
  }
}

// ------------------------------------------------------- GEMM epilogues

template <typename T>
struct Epilogue {
  const T* bias;   // [n]
  const T* resid;  // [m, n] (residual epilogue only)
  T* out;          // [m, n]
  int n;
  int t_full;
  int t_real;
};

constexpr int kEpiGelu = 0;      // out = gelu(acc + bias)
constexpr int kEpiResidual = 1;  // out = resid + (acc + bias), masked rows 0

template <typename T, int EPI>
__device__ __forceinline__ void apply_epilogue(const Epilogue<T>& ep, float acc,
                                               int row, int col) {
  const size_t idx = static_cast<size_t>(row) * ep.n + col;
  const float v = acc + to_f(ep.bias[col]);
  if (EPI == kEpiGelu) {
    ep.out[idx] = from_f<T>(gelu_tanh(v));
  } else {
    const bool valid = (row % ep.t_full) < ep.t_real;
    const float y = round_to<T>(v);
    ep.out[idx] = from_f<T>(valid ? to_f(ep.resid[idx]) + y : 0.f);
  }
}

// ------------------------------------------- fp32 GEMM: C = A . W^T (SIMT)

template <int EPI>
__global__ void __launch_bounds__(256)
    mixer_gemm_f32(const float* __restrict__ a, const float* __restrict__ wt, int m,
             int n, int k, Epilogue<float> ep) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float as[BK][BM + 4];
  __shared__ float ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256;
      const int r = e / BK, kk = e % BK;
      const int gk = k0 + kk;
      as[kk][r] = (m0 + r < m && gk < k) ? a[static_cast<size_t>(m0 + r) * k + gk] : 0.f;
      ws[kk][r] = (n0 + r < n && gk < k) ? wt[static_cast<size_t>(n0 + r) * k + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < n) apply_epilogue<float, EPI>(ep, acc[i][j], row, col);
    }
  }
}

// ---------------------------------- bf16 GEMM: C = A . W^T (WMMA, cp.async)

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kBM = 128, kBN = 128, kBK = 32, kLds = kBK + 8;
constexpr int kTileElems = kBM * kLds;  // per operand and stage (kBM == kBN)
constexpr int kGemmSmem = 2 * 2 * kTileElems * sizeof(bf16);  // 40960 B

// Copies a 128 x 32 tile of a row-major [rows, k] bf16 matrix (k % 8 == 0)
// into shared memory with row stride kLds; rows/columns past the end are 0.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int rows, int k, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * 256;  // 512 chunks of 8 values
    const int r = chunk / 4, cc = (chunk % 4) * 8;
    const bool pred = (r0 + r < rows) && (k0 + cc < k);
    const bf16* g = pred ? src + static_cast<size_t>(r0 + r) * k + k0 + cc : src;
    cp_async16(dst + r * kLds + cc, g, pred);
  }
}

template <int EPI>
__global__ void __launch_bounds__(256)
    mixer_gemm_bf16(const bf16* __restrict__ a, const bf16* __restrict__ wt, int m,
              int n, int k, Epilogue<bf16> ep) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem_raw[kGemmSmem];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);        // [2][kTileElems]
  bf16* ws = as + 2 * kTileElems;                      // [2][kTileElems]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm_ = warp / 4, wn_ = warp % 4;  // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (k + kBK - 1) / kBK;
  load_tile(as, a, m, k, m0, 0);
  load_tile(ws, wt, n, k, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile(as + (cur ^ 1) * kTileElems, a, m, k, m0, (kt + 1) * kBK);
      load_tile(ws + (cur ^ 1) * kTileElems, wt, n, k, n0, (kt + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* at = as + cur * kTileElems;
    const bf16* bt = ws + cur * kTileElems;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], at + (wm_ * 64 + i * 16) * kLds + ks, kLds);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bt + (wn_ * 32 + j * 16) * kLds + ks, kLds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16x16 float staging tile (reusing the
  // operand buffers, free after the last __syncthreads above).
  float* stage = reinterpret_cast<float*>(smem_raw) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + wm_ * 64 + i * 16 + e / 16;
        const int col = n0 + wn_ * 32 + j * 16 + e % 16;
        if (row < m && col < n) apply_epilogue<bf16, EPI>(ep, stage[e], row, col);
      }
      __syncwarp();
    }
  }
}

// ------------------------- int8 GEMM: C = A . W^T (WMMA s8, cp.async), w8a8

template <typename T>
struct EpilogueQ8 {
  const float* row_scale;  // [m] activation scales
  const float* col_scale;  // [n] weight scales
  const T* bias;           // [n]
  const T* resid;          // [m, n] (residual epilogue only)
  float* hidden;           // [m, n] float32 (gelu epilogue only)
  int* row_amax_bits;      // [m] bits of max |hidden| (gelu epilogue only)
  T* out;                  // [m, n] (residual epilogue only)
  int n;
  int t_full;
  int t_real;
};

constexpr int kQBK = 64, kQLds = kQBK + 16;   // bytes per tile row
constexpr int kQTileBytes = kBM * kQLds;      // per operand and stage
constexpr int kQGemmSmem = 2 * 2 * kQTileBytes;  // 40960 B

// Copies a 128 x 64 tile of a row-major [rows, k] int8 matrix (k % 16 == 0)
// into shared memory with row stride kQLds; rows/columns past the end are 0.
__device__ __forceinline__ void load_tile_q8(int8_t* dst, const int8_t* src,
                                             int rows, int k, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * 256;  // 512 chunks of 16 bytes
    const int r = chunk / 4, cc = (chunk % 4) * 16;
    const bool pred = (r0 + r < rows) && (k0 + cc < k);
    const int8_t* g = pred ? src + static_cast<size_t>(r0 + r) * k + k0 + cc : src;
    cp_async16(dst + r * kQLds + cc, g, pred);
  }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(256)
    mixer_gemm_q8(const int8_t* __restrict__ a, const int8_t* __restrict__ wt,
                  int m, int n, int k, EpilogueQ8<T> ep) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem_raw[kQGemmSmem];
  int8_t* as = reinterpret_cast<int8_t*>(smem_raw);  // [2][kQTileBytes]
  int8_t* ws = as + 2 * kQTileBytes;                 // [2][kQTileBytes]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm_ = warp / 4, wn_ = warp % 4;  // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int nk = (k + kQBK - 1) / kQBK;
  load_tile_q8(as, a, m, k, m0, 0);
  load_tile_q8(ws, wt, n, k, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile_q8(as + (cur ^ 1) * kQTileBytes, a, m, k, m0, (kt + 1) * kQBK);
      load_tile_q8(ws + (cur ^ 1) * kQTileBytes, wt, n, k, n0, (kt + 1) * kQBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const signed char* at =
        reinterpret_cast<const signed char*>(as + cur * kQTileBytes);
    const signed char* bt =
        reinterpret_cast<const signed char*>(ws + cur * kQTileBytes);
#pragma unroll
    for (int ks = 0; ks < kQBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], at + (wm_ * 64 + i * 16) * kQLds + ks, kQLds);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bt + (wn_ * 32 + j * 16) * kQLds + ks, kQLds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16x16 int staging tile (reusing the operand
  // buffers). Lanes 0-15 and 16-31 each hold one row of the tile per step.
  int* stage = reinterpret_cast<int*>(smem_raw) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + wm_ * 64 + i * 16 + e / 16;
        const int col = n0 + wn_ * 32 + j * 16 + e % 16;
        const bool ok = row < m && col < n;
        float habs = 0.f;
        if (ok) {
          const size_t idx = static_cast<size_t>(row) * ep.n + col;
          const float scale = __fmul_rn(ep.row_scale[row], ep.col_scale[col]);
          const float v = __fadd_rn(
              __fmul_rn(static_cast<float>(stage[e]), scale), to_f(ep.bias[col]));
          if (EPI == kEpiGelu) {
            const float hval = gelu_tanh(v);
            ep.hidden[idx] = hval;
            habs = fabsf(hval);
          } else {
            const bool valid = (row % ep.t_full) < ep.t_real;
            const float y = round_to<T>(v);
            ep.out[idx] = from_f<T>(valid ? to_f(ep.resid[idx]) + y : 0.f);
          }
        }
        if (EPI == kEpiGelu) {
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) {
            habs = fmaxf(habs, __shfl_xor_sync(0xffffffffu, habs, o));
          }
          if ((lane & 15) == 0 && row < m) {
            atomicMax(ep.row_amax_bits + row, __float_as_int(habs));
          }
        }
      }
      __syncwarp();
    }
  }
}

// One warp per row: h [m, n] float32 -> int8 with the row's scale, from the
// amax that the first product's epilogue gathered.
__global__ void __launch_bounds__(kThreads)
    mixer_quantize_rows(const float* __restrict__ h,
                        const int* __restrict__ row_amax_bits,
                        int8_t* __restrict__ q, float* __restrict__ q_scale,
                        int m, int n) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const float amax = fmaxf(__int_as_float(row_amax_bits[row]), kAmaxFloor);
  const float inv = 127.f / amax;
  const float* src = h + static_cast<size_t>(row) * n;
  int8_t* dst = q + static_cast<size_t>(row) * n;
  if (n % 4 == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    char4* dst4 = reinterpret_cast<char4*>(dst);
    for (int k = lane; k < n / 4; k += 32) {
      const float4 v = src4[k];
      char4 o;
      o.x = quantize(v.x, inv);
      o.y = quantize(v.y, inv);
      o.z = quantize(v.z, inv);
      o.w = quantize(v.w, inv);
      dst4[k] = o;
    }
  } else {
    for (int k = lane; k < n; k += 32) dst[k] = quantize(src[k], inv);
  }
  if (lane == 0) q_scale[row] = amax * kInv127;
}

template <typename T, int EPI>
cudaError_t run_gemm_q8(const int8_t* a, const int8_t* wt, int m, int n, int k,
                        EpilogueQ8<T> ep, cudaStream_t s) {
  if (k % 16 != 0) return cudaErrorInvalidValue;
  dim3 blocks((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  mixer_gemm_q8<T, EPI><<<blocks, 256, 0, s>>>(a, wt, m, n, k, ep);
  return cudaGetLastError();
}

template <typename T, int K, bool Q>
cudaError_t run_temporal(const void* x, const void* g1, const void* wu,
                         const void* bu, const void* wm, const void* bm,
                         const void* g2, void* x1, void* mlp_in, void* q_out,
                         void* q_scale, int rows, int t_full, int t_real, int c,
                         int mult, int causal, cudaStream_t s) {
  const int off = causal ? K - 1 : (K - 1) / 2;
  const size_t smem = sizeof(float) * (kTileT + 2 * (K - 1)) * c;
  auto temporal = mixer_temporal<T, K, Q>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        temporal, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int ntiles = (t_full + kTileT - 1) / kTileT;
  temporal<<<rows * ntiles, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g1),
      static_cast<const T*>(wu), static_cast<const T*>(bu),
      static_cast<const T*>(wm), static_cast<const T*>(bm),
      static_cast<const T*>(g2), static_cast<T*>(x1), static_cast<T*>(mlp_in),
      static_cast<int8_t*>(q_out), static_cast<float*>(q_scale), t_full,
      t_real, c, mult, off);
  return cudaGetLastError();
}

template <typename T>
int launch_q8(const void* x, const void* g1, const void* wu, const void* bu,
              const void* wm, const void* bm, const void* g2, const void* w1q,
              const void* s1, const void* b1, const void* w2q, const void* s2,
              const void* b2, void* x1, void* xq, void* xs, void* hidden,
              void* hmax, void* hq, void* hs, void* out, int rows, int t_full,
              int t_real, int c, int hid, int mult, int causal,
              cudaStream_t s) {
  cudaError_t err = run_temporal<T, 3, true>(
      x, g1, wu, bu, wm, bm, g2, x1, nullptr, xq, xs, rows, t_full, t_real, c,
      mult, causal, s);
  if (err != cudaSuccess) return err;
  const int mrows = rows * t_full;
  err = cudaMemsetAsync(hmax, 0, sizeof(int) * mrows, s);
  if (err != cudaSuccess) return err;
  EpilogueQ8<T> up{static_cast<const float*>(xs), static_cast<const float*>(s1),
                   static_cast<const T*>(b1), nullptr,
                   static_cast<float*>(hidden), static_cast<int*>(hmax),
                   nullptr, hid, t_full, t_real};
  err = run_gemm_q8<T, kEpiGelu>(static_cast<const int8_t*>(xq),
                                 static_cast<const int8_t*>(w1q), mrows, hid, c,
                                 up, s);
  if (err != cudaSuccess) return err;
  const int qblocks = (mrows + kThreads / 32 - 1) / (kThreads / 32);
  mixer_quantize_rows<<<qblocks, kThreads, 0, s>>>(
      static_cast<const float*>(hidden), static_cast<const int*>(hmax),
      static_cast<int8_t*>(hq), static_cast<float*>(hs), mrows, hid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  EpilogueQ8<T> down{static_cast<const float*>(hs),
                     static_cast<const float*>(s2), static_cast<const T*>(b2),
                     static_cast<const T*>(x1), nullptr, nullptr,
                     static_cast<T*>(out), c, t_full, t_real};
  return run_gemm_q8<T, kEpiResidual>(static_cast<const int8_t*>(hq),
                                      static_cast<const int8_t*>(w2q), mrows, c,
                                      hid, down, s);
}

template <typename T>
struct Gemm;

template <>
struct Gemm<float> {
  template <int EPI>
  static cudaError_t run(const float* a, const float* wt, int m, int n, int k,
                         Epilogue<float> ep, cudaStream_t s) {
    dim3 blocks((n + 63) / 64, (m + 63) / 64);
    mixer_gemm_f32<EPI><<<blocks, 256, 0, s>>>(a, wt, m, n, k, ep);
    return cudaGetLastError();
  }
};

template <>
struct Gemm<bf16> {
  template <int EPI>
  static cudaError_t run(const bf16* a, const bf16* wt, int m, int n, int k,
                         Epilogue<bf16> ep, cudaStream_t s) {
    if (k % 8 != 0) return cudaErrorInvalidValue;
    dim3 blocks((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    mixer_gemm_bf16<EPI><<<blocks, 256, 0, s>>>(a, wt, m, n, k, ep);
    return cudaGetLastError();
  }
};

template <typename T>
int launch(const void* x, const void* g1, const void* wu, const void* bu,
           const void* wm, const void* bm, const void* g2, const void* w1,
           const void* b1, const void* w2, const void* b2, void* x1,
           void* mlp_in, void* hidden, void* out, int rows, int t_full,
           int t_real, int c, int hid, int mult, int causal,
           cudaStream_t s) {
  cudaError_t err = run_temporal<T, 3, false>(
      x, g1, wu, bu, wm, bm, g2, x1, mlp_in, nullptr, nullptr, rows, t_full,
      t_real, c, mult, causal, s);
  if (err != cudaSuccess) return err;

  const int mrows = rows * t_full;
  Epilogue<T> up{static_cast<const T*>(b1), nullptr, static_cast<T*>(hidden),
                 hid, t_full, t_real};
  err = Gemm<T>::template run<kEpiGelu>(static_cast<const T*>(mlp_in),
                                        static_cast<const T*>(w1), mrows, hid,
                                        c, up, s);
  if (err != cudaSuccess) return err;
  Epilogue<T> down{static_cast<const T*>(b2), static_cast<const T*>(x1),
                   static_cast<T*>(out), c, t_full, t_real};
  return Gemm<T>::template run<kEpiResidual>(static_cast<const T*>(hidden),
                                             static_cast<const T*>(w2), mrows,
                                             c, hid, down, s);
}

}  // namespace

extern "C" {

// x [rows, t_full, c]; g1, g2, b2 [c]; wu, wm [3, 1, c*mult] (c-major);
// bu, bm [c*mult]; w1 [hid, c] and w2 [c, hid] (Linear layout, out x in);
// b1 [hid]; scratch x1, mlp_in [rows, t_full, c] and hidden
// [rows*t_full, hid]; out [rows, t_full, c]. Every tensor in the compute dtype
// (dtype 0: float32, 1: bfloat16). Returns the first failing cudaError_t.
int mixer_block_forward(const void* x, const void* g1, const void* wu,
                        const void* bu, const void* wm, const void* bm,
                        const void* g2, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* x1,
                        void* mlp_in, void* hidden, void* out, int rows,
                        int t_full, int t_real, int c, int hid, int mult,
                        int k, int causal, int dtype, void* stream) {
  if (k != 3 || rows <= 0 || t_full <= 0 || t_real < 0 || t_real > t_full ||
      c <= 0 || hid <= 0 || mult <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, x1, mlp_in,
                         hidden, out, rows, t_full, t_real, c, hid, mult,
                         causal, s);
  }
  if (dtype == 1) {
    return launch<bf16>(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, x1, mlp_in,
                        hidden, out, rows, t_full, t_real, c, hid, mult,
                        causal, s);
  }
  return cudaErrorInvalidValue;
}

// The block with the w8a8 channel MLP. x, g1, wu, bu, wm, bm, g2, b1, b2 as
// above in the compute dtype; w1q [hid, c] and w2q [c, hid] int8 (Linear
// layout, 16-byte aligned, c and hid multiples of 16) with their float32
// column scales s1 [hid], s2 [c]; scratch x1 [rows, t_full, c] (compute
// dtype), xq int8 [rows*t_full, c] with xs float32 [rows*t_full], hidden
// float32 [rows*t_full, hid], hmax int32 [rows*t_full], hq int8
// [rows*t_full, hid] with hs float32 [rows*t_full]; out [rows, t_full, c].
int mixer_block_q8_forward(const void* x, const void* g1, const void* wu,
                           const void* bu, const void* wm, const void* bm,
                           const void* g2, const void* w1q, const void* s1,
                           const void* b1, const void* w2q, const void* s2,
                           const void* b2, void* x1, void* xq, void* xs,
                           void* hidden, void* hmax, void* hq, void* hs,
                           void* out, int rows, int t_full, int t_real, int c,
                           int hid, int mult, int k, int causal, int dtype,
                           void* stream) {
  if (k != 3 || rows <= 0 || t_full <= 0 || t_real < 0 || t_real > t_full ||
      c <= 0 || hid <= 0 || mult <= 0 || c % 16 != 0 || hid % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_q8<float>(x, g1, wu, bu, wm, bm, g2, w1q, s1, b1, w2q, s2,
                            b2, x1, xq, xs, hidden, hmax, hq, hs, out, rows,
                            t_full, t_real, c, hid, mult, causal, s);
  }
  if (dtype == 1) {
    return launch_q8<bf16>(x, g1, wu, bu, wm, bm, g2, w1q, s1, b1, w2q, s2, b2,
                           x1, xq, xs, hidden, hmax, hq, hs, out, rows, t_full,
                           t_real, c, hid, mult, causal, s);
  }
  return cudaErrorInvalidValue;
}

const char* tapnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

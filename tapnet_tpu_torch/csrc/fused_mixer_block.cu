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
// Design: three launches from one file (two more small ones in float32).
//   (a) mixer_temporal: one block per (row, tile of 16 time steps). LN1 of the
//       tile plus its 2-step temporal halo goes to shared memory in float32;
//       each thread owns a channel and runs the depthwise pair over its mult
//       lanes in registers (the c-major weight layout [k, 1, C*mult] gives a
//       thread its mult*k taps contiguously, so no re-layout is needed), adds
//       the residual, then one warp per row takes LN2. Writes x1 and the MLP
//       operand LN2(x1) in the compute dtype.
//   (b) gemm (W1): hidden = gelu(LN2(x1) . W1^T + b1) into [rows*T, 4C].
//   (c) gemm (W2): y = x1 + (hidden . W2^T + b2), rows >= t_real zeroed.
// Both GEMMs are mixer_gemm_tma<EPI, T>, the TMA + wgmma loop of
// tma_gemm.cuh (a 4-stage ring of 128-byte-swizzled TMA boxes, a producer
// warp and two consumer warpgroups, persistent CTAs) with float32 sums and
// the epilogues of MlpEpilogue. The hidden goes through device memory in
// the compute dtype, as JAX rounds it (_mlp_hidden :212-223) before the
// second product.
//   * bf16: tg::Bf16, 128 x 256 tiles (131 MB of hidden each way at [128,
//     250, 512], about 0.08 ms).
//   * float32: tg::Tf32x3, 128 x 128 tiles of error-compensated TF32: each
//     float32 value v is split into big = tf32(v) and small = tf32(v -
//     big), and a product is As.Bb + Ab.Bs + Ab.Bb into one float32
//     accumulator, within about 2^-21 of a product of the float32 values
//     where one TF32 product is 2^-11 off (the 1e-4 limit of the fp32 block
//     refuses that: fused_mixer_block.fp32_controls). The activations are
//     split in registers as the consumers read them; the weights are split
//     into [2, n, k] (big rows, then small rows) by tg::split_tf32, two
//     small launches per call (8 MB read, 16 MB written). Bound: three TF32
//     products, 3 x 134 GFLOP at 495 TFLOP/s, 0.81 ms at [128, 250, 512]
//     (the hidden, 262 MB each way in float32, 0.16 ms of bytes, is below
//     it); the SIMT float32 GEMMs this replaces were bound at 2.0 ms by the
//     67 TFLOP/s of the float32 pipes.
//
// The w8a8 block (mixer_block_q8_forward) replaces the same TPU kernel with
// quantized=True (_mlp_operand :187, _mlp_hidden :212, _mlp_epilogue :225).
// Two launches:
//   (a') mixer_temporal<Q>: as (a), but LN2's float32 output is quantized per
//        row (amax floored at 1e-8, x * (127 / amax), round half to even, clip
//        to +-127) into int8 [rows*T, C] with its scale amax / 127.
//   (b') mixer_mlp_q8: the whole channel MLP, one CTA per 64 rows, on the int8
//        tile loop of q8_tile.cuh (wgmma on swizzled shared-memory panels).
//        The 64 x C int8 operand stays in shared memory. Four warpgroups
//        each take a quarter of the hidden columns (m64n32) and of the
//        output columns (m64n64), and stream their W1 and W2 tiles through
//        cp.async rings of their own, from different K tiles. Pass 1 walks
//        W1's column chunks of 128 for each row's amax of
//        gelu(acc * (xs * s1) + b1); the CTA sees whole rows, so no atomics,
//        and a value whose exact bound (gelu(v) <= v, |gelu(v)| <= |v| / 2)
//        cannot raise the amax skips its GELU. Pass 2 recomputes each chunk
//        (one code site, every step rounded, so both passes give the same
//        floats), quantizes it as the plain version does (v * (127 / amax))
//        into shared memory and feeds it at once to the second product,
//        whose int32 sums [64, C <= 512] stay in registers; the epilogue
//        does acc * (hs * s2) + b2, rounds to the compute dtype, adds x1 and
//        zeroes rows >= t_real. Neither the float32 hidden [rows*T, 4C] (262
//        MB at [128, 250, 512]) nor its int8 form reaches device memory
//        (debug pointers, null on the main path, store them for checks).
// bf16 enters only at x, x1 and the output. Bound on the H100: 134 G integer
// operations at 1979 TOP/s dense int8 (0.068 ms) against the activations'
// bytes; pass 1 adds half again to the operations. What holds this design
// back (PERF.md section 6): a 64-row CTA reads 3 MB of weights from L2 for
// 403 M operations (134 a byte), and its epilogues (the GELU twice, on 16
// warps with 128 registers each) run beside a loop that L2 feeds; the
// temporal half (a') is a sixth of the block's time.
//
// Numerics as in the JAX kernel: LN eps 1e-5 with float32 statistics (LN1
// single-pass, LN2 two-pass as in mixer_math.mlp_math), GELU tanh, float32
// accumulation, depthwise fold bias = sum over the mult lanes of b_mix.
//
// Bound on the H100: the two products, 2 * 2 * rows*T * C * 4C flops (about
// 134 GFLOP per launch at [128, 250, 512]): in bf16 0.14 ms at 989 TFLOP/s,
// in float32 0.81 ms (three TF32 products at 495) against ~70 MB (bf16) or
// 140 MB of activations (0.02 / 0.04 ms at 3.35 TB/s): compute-bound. The
// products are not fused: a CTA that kept the hidden on chip would hold 64
// rows and read the weights from L2 at 64 flops a byte (the fused w8a8 MLP
// below is L2-bound at twice that); PERF.md section 6 has what the two GEMMs
// reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "q8_tile.cuh"
#include "tma_gemm.cuh"

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
      // As mixer_math.quantize_rows: scale max(amax, 1e-8) / 127.
      amax = fmaxf(warp_max(amax), q8::kAmaxFloor);
      const float inv = 127.f / amax;
      int8_t* qdst = q_out + orow * c;
      for (int k = lane; k < c; k += 32) {
        qdst[k] = static_cast<int8_t>(q8::quantize_mul(src[k], inv));
      }
      if (lane == 0) q_scale[orow] = amax * q8::kInv127;
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

// ------------------------- the two products: C = A . W^T on tma_gemm.cuh

// bf16 operands are tg::Bf16; float32 ones tg::Tf32x3 (error-compensated
// TF32, the weights pre-split by tg::split_tf32).
template <typename T>
struct GemmOp;
template <>
struct GemmOp<bf16> {
  using type = tg::Bf16;
};
template <>
struct GemmOp<float> {
  using type = tg::Tf32x3;
};

// K step kk of a tile: A's box {step kk, m0} of [m, k], B's {step kk, n} of
// the weights [n, k] (Linear's layout, K-major; for Tf32x3 [2n, k], the big
// rows then the small ones); step: the values in tg::kBK bytes.
struct RowLoader {
  static constexpr int kBDims = 2;
  int step;
  __device__ __forceinline__ void a(int kk, int m0, int& c0, int& c1) const {
    c0 = kk * step;
    c1 = m0;
  }
  __device__ __forceinline__ void b(int kk, int n, int& c0, int& c1, int& c2) const {
    c0 = kk * step;
    c1 = n;
    c2 = 0;
  }
};

// The epilogues on tg::gemm's staged values, at the rounding points of the
// plain version: GEMM 1 writes T(gelu(acc + b1)); GEMM 2 stages y = T(acc +
// b2) and writes T(x1 + y), rows at t >= t_real 0.
template <int EPI, typename T>
struct MlpEpilogue {
  using Out = T;
  Epilogue<T> ep;
  struct Row {
    bool ok;
    bool valid;
    size_t base;
  };
  __device__ __forceinline__ Row row(int r) const {
    return Row{true, (r % ep.t_full) < ep.t_real, static_cast<size_t>(r) * ep.n};
  }
  __device__ __forceinline__ float value(const Row&, int col, float s) const {
    const float v = s + to_f(ep.bias[col]);
    return EPI == kEpiGelu ? gelu_tanh(v) : v;
  }
  __device__ __forceinline__ void store(const Row& r, int col, uint4 y) const {
    uint4 o = y;
    if constexpr (EPI == kEpiResidual) {
      o = make_uint4(0u, 0u, 0u, 0u);
      if (r.valid) {
        const uint4 x1 = *reinterpret_cast<const uint4*>(ep.resid + r.base + col);
        if constexpr (sizeof(T) == 4) {
          const float* xf = reinterpret_cast<const float*>(&x1);
          const float* yf = reinterpret_cast<const float*>(&y);
          float* of = reinterpret_cast<float*>(&o);
#pragma unroll
          for (int k = 0; k < 4; ++k) of[k] = xf[k] + yf[k];
        } else {
          const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&x1);
          const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&y);
          __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 a = __bfloat1622float2(xh[k]), b = __bfloat1622float2(yh[k]);
            oh[k] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(ep.out + r.base + col) = o;
  }
};

template <int EPI, typename T>
__global__ void __launch_bounds__(tg::kThreads, 1)
    mixer_gemm_tma(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap w_map, tg::Problem pb,
                   RowLoader ld, MlpEpilogue<EPI, T> ep) {
  extern __shared__ __align__(16) int8_t smem_raw[];
  tg::gemm<typename GemmOp<T>::type>(smem_raw, &a_map, &w_map, pb, ld, ep);
}

// ------------------------------- the w8a8 channel MLP on the q8 tile loop

// 64 rows per CTA, kMlpWgs warpgroups. Warpgroup w computes hidden columns
// w*32 .. +31 of each 128-column chunk and output columns w*128 .. +127
// (c <= 512), and streams its W1 tiles (32 weight rows by 256 bytes of K)
// and W2 tiles (64 weight rows by 128 bytes), 8 KB each, through kMlpStages
// stages of a ring of its own. fused_mixer_block.q8_launch_plan mirrors these numbers.
constexpr int kMlpRows = 64, kMlpTile = 128, kMlpStages = 4, kMlpWgs = 4;
constexpr int kMlpThreads = 128 * kMlpWgs;
constexpr int kMlpW1Rows = kMlpTile / kMlpWgs;        // a warpgroup's hidden columns
constexpr int kMlpW1K = 256;                           // bytes of K of a W1 tile
constexpr int kMlpOutCols = 512 / kMlpWgs;            // its output columns
constexpr int kMlpOutBlocks = kMlpOutCols / 64;       // as m64n64 blocks

// Dynamic shared memory, with the slack of q8::aligned_smem: the int8 operand
// (ceil(c / 256) tiles of four panels), two buffers of a 128-column chunk of
// the int8 hidden (two panels each), the rings (stages of 64 rows by 128
// bytes), the warpgroups' amax partials [kMlpWgs][64], the operand's and the
// hidden's row scales.
size_t mlp_smem_bytes(int c) {
  const size_t ktiles = (c + kMlpW1K - 1) / kMlpW1K;
  return q8::kSmemAlign + ktiles * kMlpW1K * kMlpRows +
         2 * 2 * kMlpRows * q8::kPanel + kMlpWgs * kMlpStages * kMlpRows * kMlpTile +
         kMlpRows * sizeof(float) * (kMlpWgs + 2);
}

template <typename T>
struct MlpParams {
  const int8_t* xq;   // [m, c] the int8 operand (LN2 quantized per row)
  const float* xs;    // [m]
  const int8_t* w1q;  // [hid, c]
  const float* s1;    // [hid]
  const T* b1;        // [hid]
  const int8_t* w2q;  // [c, hid]
  const float* s2;    // [c]
  const T* b2;        // [c]
  const T* x1;        // [m, c] the residual
  T* out;             // [m, c]
  float* hidden;      // [m, hid] float32, or null (the main path)
  int8_t* hq;         // [m, hid], or null
  float* hs;          // [m], or null
  int m, c, hid, t_full, t_real;
};

// y = x1 + (q(gelu(xq . W1^T * (xs * s1) + b1)) . W2^T * (hs * s2) + b2),
// rows >= t_real of each time series zeroed. Pass 1 walks W1's column chunks
// for each row's amax of the hidden; pass 2 walks them again, quantizes each
// 64 x 128 chunk of the hidden into shared memory as mixer_math.quantize_rows
// does (v * (127 / amax)), and feeds it at once to the second product, whose
// int32 sums [64, 512] stay in registers. One code site computes the hidden
// in both passes (the loops are not unrolled). The warpgroups wait on
// barriers of their own (1 + w) for their rings and walk K from different
// tiles, so that in pass 1 one's epilogue runs while the others multiply.
// They meet between the passes (the amax) and, in pass 2, once a chunk
// (barrier 6: every part of the int8 hidden chunk written; the buffers
// alternate, so a chunk's is rewritten only after the next chunk's meeting,
// when all have finished reading it).
template <typename T>
__global__ void __launch_bounds__(kMlpThreads, 1) mixer_mlp_q8(MlpParams<T> p) {
  extern __shared__ __align__(16) int8_t smem_raw[];
  int8_t* smem = q8::aligned_smem(smem_raw);
  constexpr int S = kMlpStages;
  constexpr int kWg = 128;
  constexpr int kStage = kMlpRows * kMlpTile;          // bytes of a stage
  constexpr int kChunk = 2 * kMlpRows * q8::kPanel;    // bytes of a hidden chunk
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wtid = tid & (kWg - 1);
  const int ktiles = (p.c + kMlpW1K - 1) / kMlpW1K;    // W1 tiles per chunk
  const int nob = min(kMlpOutBlocks, max(0, (p.c - wg * kMlpOutCols + 63) / 64));
  const int nch = (p.hid + kMlpTile - 1) / kMlpTile;   // hidden chunks
  const int koff = wg * ktiles / kMlpWgs;               // its first K tile
  const int tiles = nch * ktiles + nch * (ktiles + nob);
  int8_t* xq_s = smem;
  int8_t* hq_s = xq_s + ktiles * kMlpW1K * kMlpRows;  // [2][chunk]
  int8_t* ring = hq_s + 2 * kChunk + wg * S * kStage;
  float* s_part = reinterpret_cast<float*>(hq_s + 2 * kChunk + kMlpWgs * S * kStage);
  float* s_xs = s_part + kMlpWgs * kMlpRows;
  float* s_hs = s_xs + kMlpRows;
  const int m0 = blockIdx.x * kMlpRows;

  // The operand rows, by the whole CTA, before the warpgroups part.
  for (int s = 0; s < ktiles; ++s) {
    q8::copy_panels<kMlpRows, kMlpW1K / q8::kPanel, kMlpThreads>(
        xq_s + s * kMlpW1K * kMlpRows, p.xq, p.m, p.c, m0, s * kMlpW1K);
  }
  q8::cp_async_commit();
  for (int r = tid; r < kMlpRows; r += kMlpThreads) {
    s_xs[r] = m0 + r < p.m ? p.xs[m0 + r] : 0.f;
  }
  q8::cp_async_wait<0>();
  q8::fence_proxy_async();
  __syncthreads();

  // Tile t of this warpgroup: pass 1 is chunk-major W1 tiles; in pass 2
  // each chunk's W1 tiles are followed by its W2 tiles (output blocks).
  auto issue = [&](int t) {
    if (t < tiles) {
      int8_t* dst = ring + (t % S) * kStage;
      const bool first = t < nch * ktiles;
      const int u = first ? t : t - nch * ktiles;
      const int per = first ? ktiles : ktiles + nob;
      const int j = u / per, v = u % per;
      if (v < ktiles) {
        q8::copy_panels<kMlpW1Rows, kMlpW1K / q8::kPanel, kWg>(
            dst, p.w1q, p.hid, p.c, j * kMlpTile + wg * kMlpW1Rows,
            ((v + koff) % ktiles) * kMlpW1K, wtid);
      } else {
        q8::copy_panels<kMlpRows, 2, kWg>(dst, p.w2q, p.c, p.hid,
                                          wg * kMlpOutCols + (v - ktiles) * 64,
                                          j * kMlpTile, wtid);
      }
    }
    q8::cp_async_commit();
  };
  for (int t = 0; t < S - 2; ++t) issue(t);

  // This thread holds rows r0 and r0 + 8 of the block.
  const int r0 = (warp & 3) * 16 + (lane >> 2), tq = lane & 3;
  int acc1[kMlpW1Rows / 2];
  int acc2[kMlpOutBlocks][32];
  float amax[2] = {0.f, 0.f};
  int t = 0;

#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      // The warpgroups' row amaxes meet.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float a = amax[half];
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
        if (tq == 0) s_part[wg * kMlpRows + r0 + half * 8] = a;
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int j = 0; j < nch; ++j) {
#pragma unroll 1
      for (int s = 0; s < ktiles; ++s, ++t) {
        q8::ring_wait<S>(1 + wg, kWg);
        issue(t + S - 2);
        const int8_t* stage = ring + (t % S) * kStage;
        const int8_t* a = xq_s + ((s + koff) % ktiles) * kMlpW1K * kMlpRows;
        q8::fence_regs<kMlpW1Rows / 2>(acc1);
        q8::wgmma_fence();
#pragma unroll
        for (int pp = 0; pp < kMlpW1K / q8::kPanel; ++pp) {
          q8::wg_panel<kMlpW1Rows>(acc1, a + pp * kMlpRows * q8::kPanel,
                                   stage + pp * kMlpW1Rows * q8::kPanel,
                                   s != 0 || pp != 0);
        }
        q8::wgmma_commit();
        q8::wgmma_wait<1>();
      }
      q8::wgmma_wait<0>();
      q8::fence_regs<kMlpW1Rows / 2>(acc1);
      // The hidden chunk: pass 1 takes each row's amax, pass 2 quantizes it
      // into this chunk's buffer of hq_s.
      int8_t* chunk = hq_s + (j & 1) * kChunk;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + half * 8;
        const int row = m0 + r;
        float inv = 0.f;
        if (pass == 1) {
          float a = s_part[r];
#pragma unroll
          for (int w = 1; w < kMlpWgs; ++w) a = fmaxf(a, s_part[w * kMlpRows + r]);
          a = fmaxf(a, q8::kAmaxFloor);
          inv = __fdiv_rn(127.f, a);
          if (j == 0 && wg == 0 && tq == 0) {
            s_hs[r] = __fmul_rn(a, q8::kInv127);
            if (p.hs != nullptr && row < p.m) p.hs[row] = s_hs[r];
          }
        }
#pragma unroll
        for (int jj = 0; jj < kMlpW1Rows / 8; ++jj) {
          const int cc = wg * kMlpW1Rows + jj * 8 + tq * 2;  // column in the chunk
          const int col = j * kMlpTile + cc;
          float hv[2] = {0.f, 0.f};
          int q[2] = {0, 0};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= p.hid) continue;
            const float scale = __fmul_rn(s_xs[r], p.s1[col + e]);
            const float v = __fadd_rn(
                __fmul_rn(__int2float_rn(acc1[4 * jj + 2 * half + e]), scale),
                to_f(p.b1[col + e]));
            // Pass 1 skips the values that cannot raise the amax.
            if (pass == 1 || (row < p.m && q8::gelu_bound(v) > amax[half])) {
              hv[e] = q8::gelu_rn(v);
              if (pass == 0) amax[half] = fmaxf(amax[half], fabsf(hv[e]));
              q[e] = q8::quantize_mul(hv[e], inv);
            }
          }
          if (pass == 0) continue;
          *reinterpret_cast<uint16_t*>(chunk + (cc >> 6) * kMlpRows * q8::kPanel +
                                       q8::panel_offset(r, (cc & 63) >> 4) +
                                       (cc & 15)) = q8::pack2(q[0], q[1]);
          if (row < p.m && col < p.hid) {
            const size_t o = static_cast<size_t>(row) * p.hid + col;
            if (p.hq != nullptr) {
              *reinterpret_cast<uint16_t*>(p.hq + o) = q8::pack2(q[0], q[1]);
            }
            if (p.hidden != nullptr) {
              *reinterpret_cast<float2*>(p.hidden + o) = make_float2(hv[0], hv[1]);
            }
          }
        }
      }
      if (pass == 0) continue;
      // Every part of the chunk written, then its share of the second
      // product, one output block per tile.
      q8::fence_proxy_async();
      q8::bar_sync(1 + kMlpWgs, kMlpThreads);
#pragma unroll
      for (int ob = 0; ob < kMlpOutBlocks; ++ob) {
        if (ob >= nob) break;
        q8::ring_wait<S>(1 + wg, kWg);
        issue(t + S - 2);
        const int8_t* stage = ring + (t % S) * kStage;
        q8::fence_regs<32>(acc2[ob]);
        q8::wgmma_fence();
        q8::wg_panel<64>(acc2[ob], chunk, stage, j != 0);
        q8::wg_panel<64>(acc2[ob], chunk + kMlpRows * q8::kPanel,
                         stage + kMlpRows * q8::kPanel, 1);
        q8::wgmma_commit();
        q8::wgmma_wait<1>();
        ++t;
      }
    }
  }
  q8::wgmma_wait<0>();
#pragma unroll
  for (int ob = 0; ob < kMlpOutBlocks; ++ob) q8::fence_regs<32>(acc2[ob]);

  // y = acc2 * (hs * s2) + b2, rounded to T, + x1; rows >= t_real zeroed.
#pragma unroll
  for (int ob = 0; ob < kMlpOutBlocks; ++ob) {
    if (ob >= nob) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
      const int row = m0 + r;
      if (row >= p.m) continue;
      const bool valid = (row % p.t_full) < p.t_real;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wg * kMlpOutCols + ob * 64 + jj * 8 + tq * 2 + e;
          if (col >= p.c) continue;
          const size_t idx = static_cast<size_t>(row) * p.c + col;
          const float scale = __fmul_rn(s_hs[r], p.s2[col]);
          const float v = __fadd_rn(
              __fmul_rn(__int2float_rn(acc2[ob][4 * jj + 2 * half + e]), scale),
              to_f(p.b2[col]));
          const float y = round_to<T>(v);
          p.out[idx] = from_f<T>(valid ? to_f(p.x1[idx]) + y : 0.f);
        }
      }
    }
  }
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
              void* hq, void* hs, void* out, int rows, int t_full, int t_real,
              int c, int hid, int mult, int causal, cudaStream_t s) {
  cudaError_t err = run_temporal<T, 3, true>(
      x, g1, wu, bu, wm, bm, g2, x1, nullptr, xq, xs, rows, t_full, t_real, c,
      mult, causal, s);
  if (err != cudaSuccess) return err;
  const int mrows = rows * t_full;
  const size_t smem = mlp_smem_bytes(c);
  err = cudaFuncSetAttribute(mixer_mlp_q8<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  MlpParams<T> prm{static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
                   static_cast<const int8_t*>(w1q), static_cast<const float*>(s1),
                   static_cast<const T*>(b1), static_cast<const int8_t*>(w2q),
                   static_cast<const float*>(s2), static_cast<const T*>(b2),
                   static_cast<const T*>(x1), static_cast<T*>(out),
                   static_cast<float*>(hidden), static_cast<int8_t*>(hq),
                   static_cast<float*>(hs), mrows, c, hid, t_full, t_real};
  mixer_mlp_q8<T><<<(mrows + kMlpRows - 1) / kMlpRows, kMlpThreads, smem, s>>>(prm);
  return cudaGetLastError();
}

// out = epilogue(a [m, k] . w^T): w is [n, k] for bf16, the split [2, n, k]
// for float32. k and n multiples of 16 bytes of T, bases 16-byte aligned.
template <int EPI, typename T>
cudaError_t run_gemm(const T* a, const T* w, int m, int n, int k, Epilogue<T> ep,
                     cudaStream_t s) {
  using Op = typename GemmOp<T>::type;
  constexpr int kUnit = 16 / sizeof(T);
  if (k % kUnit != 0 || n % kUnit != 0) return cudaErrorInvalidValue;
  const int w_rows = std::is_same<Op, tg::Tf32x3>::value ? 2 * n : n;
  CUtensorMap a_map, w_map;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(w_rows)};
  const uint64_t strides[1] = {sizeof(T) * static_cast<uint64_t>(k)};
  cudaError_t err = tg::make_map(&a_map, Op::kType, Op::kElem, 2, a, a_dims, strides);
  if (err != cudaSuccess) return err;
  err = tg::make_map(&w_map, Op::kType, Op::kElem, 2, w, w_dims, strides);
  if (err != cudaSuccess) return err;
  const tg::Problem pb = tg::problem<Op>(m, n, static_cast<long long>(sizeof(T)) * k);
  const MlpEpilogue<EPI, T> pep{ep};
  return tg::launch(mixer_gemm_tma<EPI, T>, pb, s, a_map, w_map, pb,
                    RowLoader{tg::kBK / Op::kElem}, pep);
}

template <typename T>
int launch(const void* x, const void* g1, const void* wu, const void* bu,
           const void* wm, const void* bm, const void* g2, const void* w1,
           const void* b1, const void* w2, const void* b2, void* x1,
           void* mlp_in, void* hidden, void* wsplit, void* out, int rows,
           int t_full, int t_real, int c, int hid, int mult, int causal,
           cudaStream_t s) {
  const T* w1_op = static_cast<const T*>(w1);
  const T* w2_op = static_cast<const T*>(w2);
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    // The weights' big and small TF32 parts, [2, hid, c] and [2, c, hid].
    const long long count = static_cast<long long>(hid) * c;
    float* split = static_cast<float*>(wsplit);
    err = tg::split_weights(w1_op, split, count, s);
    if (err != cudaSuccess) return err;
    err = tg::split_weights(w2_op, split + 2 * count, count, s);
    if (err != cudaSuccess) return err;
    w1_op = split;
    w2_op = split + 2 * count;
  }
  err = run_temporal<T, 3, false>(
      x, g1, wu, bu, wm, bm, g2, x1, mlp_in, nullptr, nullptr, rows, t_full,
      t_real, c, mult, causal, s);
  if (err != cudaSuccess) return err;

  const int mrows = rows * t_full;
  Epilogue<T> up{static_cast<const T*>(b1), nullptr, static_cast<T*>(hidden),
                 hid, t_full, t_real};
  err = run_gemm<kEpiGelu>(static_cast<const T*>(mlp_in), w1_op, mrows, hid, c, up, s);
  if (err != cudaSuccess) return err;
  Epilogue<T> down{static_cast<const T*>(b2), static_cast<const T*>(x1),
                   static_cast<T*>(out), c, t_full, t_real};
  return run_gemm<kEpiResidual>(static_cast<const T*>(hidden), w2_op, mrows, c, hid,
                                down, s);
}

}  // namespace

extern "C" {

// x [rows, t_full, c]; g1, g2, b2 [c]; wu, wm [3, 1, c*mult] (c-major);
// bu, bm [c*mult]; w1 [hid, c] and w2 [c, hid] (Linear layout, out x in;
// bf16: 16-byte aligned); b1 [hid]; scratch x1, mlp_in [rows, t_full, c]
// and hidden [rows*t_full, hid], and for float32 wsplit [4 * hid * c] (the
// weights' TF32 parts; null for bf16); out [rows, t_full, c]. Every tensor
// in the compute dtype (dtype 0: float32, 1: bfloat16); c and hid multiples
// of 16 bytes of it. gemm_smem: the GEMMs' dynamic shared memory as the
// caller's launch plan gives it (tg::kSmemBytes); a plan that disagrees is
// refused. Returns the first failing cudaError_t.
int mixer_block_forward(const void* x, const void* g1, const void* wu,
                        const void* bu, const void* wm, const void* bm,
                        const void* g2, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* x1,
                        void* mlp_in, void* hidden, void* wsplit, void* out,
                        int rows, int t_full, int t_real, int c, int hid,
                        int mult, int k, int causal, int gemm_smem, int dtype,
                        void* stream) {
  if (k != 3 || rows <= 0 || t_full <= 0 || t_real < 0 || t_real > t_full ||
      c <= 0 || hid <= 0 || mult <= 0 ||
      static_cast<long long>(rows) * t_full + tg::kBM > 0x7fffffffLL ||
      gemm_smem != tg::kSmemBytes || (dtype == 0 && wsplit == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, x1, mlp_in,
                         hidden, wsplit, out, rows, t_full, t_real, c, hid,
                         mult, causal, s);
  }
  if (dtype == 1) {
    return launch<bf16>(x, g1, wu, bu, wm, bm, g2, w1, b1, w2, b2, x1, mlp_in,
                        hidden, nullptr, out, rows, t_full, t_real, c, hid,
                        mult, causal, s);
  }
  return cudaErrorInvalidValue;
}

// The block with the w8a8 channel MLP. x, g1, wu, bu, wm, bm, g2, b1, b2 as
// above in the compute dtype; w1q [hid, c] and w2q [c, hid] int8 (Linear
// layout, 16-byte aligned, c and hid multiples of 16, c <= 512) with their
// float32 column scales s1 [hid], s2 [c]; scratch x1 [rows, t_full, c]
// (compute dtype), xq int8 [rows*t_full, c] with xs float32 [rows*t_full];
// hidden (float32 [rows*t_full, hid]), hq (int8 [rows*t_full, hid]) and hs
// (float32 [rows*t_full]): null on the main path, or the tensors to receive
// the hidden that the MLP quantizes, its int8 form and row scales; out
// [rows, t_full, c]. mlp_smem: the MLP kernel's dynamic shared memory as the
// caller's launch plan gives it; a plan that disagrees is refused.
int mixer_block_q8_forward(const void* x, const void* g1, const void* wu,
                           const void* bu, const void* wm, const void* bm,
                           const void* g2, const void* w1q, const void* s1,
                           const void* b1, const void* w2q, const void* s2,
                           const void* b2, void* x1, void* xq, void* xs,
                           void* hidden, void* hq, void* hs, void* out,
                           int rows, int t_full, int t_real, int c, int hid,
                           int mult, int k, int causal, int mlp_smem,
                           int dtype, void* stream) {
  if (k != 3 || rows <= 0 || t_full <= 0 || t_real < 0 || t_real > t_full ||
      c <= 0 || hid <= 0 || mult <= 0 || c % 16 != 0 || hid % 16 != 0 ||
      c > kMlpWgs * kMlpOutCols ||
      static_cast<size_t>(mlp_smem) != mlp_smem_bytes(c)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_q8<float>(x, g1, wu, bu, wm, bm, g2, w1q, s1, b1, w2q, s2,
                            b2, x1, xq, xs, hidden, hq, hs, out, rows, t_full,
                            t_real, c, hid, mult, causal, s);
  }
  if (dtype == 1) {
    return launch_q8<bf16>(x, g1, wu, bu, wm, bm, g2, w1q, s1, b1, w2q, s2, b2,
                           x1, xq, xs, hidden, hq, hs, out, rows, t_full,
                           t_real, c, hid, mult, causal, s);
  }
  return cudaErrorInvalidValue;
}

const char* tapnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// The ExtraConvs of BootsTAPIR, hand-written for Hopper (sm_90a). The two
// int8 entry points and the float layer in bf16 share one implicit-GEMM loop
// (conv3x3_mma, on int8 or bf16 mma.sync); the float layer in fp32 runs on
// the SIMT cores (see extra_convs_fp_forward below).
//
// conv3x3_q8_frame_forward: the per-frame w8a8 SAME 3x3 stride-1 convolution
// (quantized_extra_convs=True). It replaces XLA's int8 convolution of
// tapnet_tpu/ops/qconv.py::conv2d_q8_math, which has no Pallas kernel and no
// PyTorch counterpart on CUDA. Three launches:
//   (1) frame_amax: max |x| over each frame's H*W*C (atomicMax on the bits of
//       a non-negative float, ordered as integers);
//   (2) quantize_frames: xq = clip(rint(x / xs), +-127), xs = max(amax, 1e-8)
//       * (1/127), one scale per frame;
//   (3) conv3x3_q8<kFrame>: y = acc * (xs[frame] * ws[col]) + b[col], cast to
//       the model dtype.
//
// extra_convs_q8_pixel_forward: K6, one whole ExtraConvs layer with per-pixel
// int8 scales (quantized_extra_convs="per_pixel"). It replaces the Pallas TPU
// kernel tapnet_tpu/ops/fused_extra_convs.py::_kernel (launched by
// _pallas_forward) with quantized=True, and computes what its reference
// _math_reference(quantized=True) computes:
//   (a) ln_bias_rows: t32 = LN(x) * g + b in float32 (single-pass statistics),
//       and each pixel's amax of |t32|;
//   (b) patch_scale: cs[p] = max(amax over the in-frame 3x3 neighbours of p,
//       1e-8) * (1/127), the scale of p's whole 3x3xC patch (zero padding does
//       not raise an amax);
//   (c) conv3x3_q8<kUp>: conv_up with the patch scheme. The A-operand loader
//       reads float32 t32 and quantizes it on the fly with the scale of the
//       OUTPUT row, so one input value is quantized differently for each of
//       the 9 output pixels that read it. Epilogue: GELU(acc * (cs * su) + bu),
//       the float32 hidden, and each pixel's amax of |hidden| by atomicMax
//       (a row spans every column tile);
//   (d) quantize_rows: the hidden to int8 with one scale per pixel, vs;
//   (e) conv3x3_q8<kOut>: conv_out with per-tap exact dequantization: after
//       each tap's K range, that tap's int32 partial is scaled by
//       vs[p + off_tap] * so[col] (the scale of the pixel the tap READS, so it
//       cannot leave the tap sum) and summed in float32 from zero in tap
//       order; then + bo, + t32, cast to the model dtype.
// The TPU kernel keeps one frame's t32, hidden and int8 copies in VMEM. One
// frame's 62x62x1024 float32 hidden is 15.7 MB, against 227 KB of shared
// memory on an SM, so here they go through device memory.
//
// The implicit GEMM: rows are output pixels (p = (n*H + y)*W + x), columns
// output channels, K = 9 * C_in ordered tap-major (k = tap*C_in + c, tap =
// (dy+1)*3 + (dx+1)); the weights are int8 [C_out, 9*C_in], one output
// channel per row. 128x128 tiles, K by 64 bytes, 8 warps of 64x32, int8
// mma.sync m16n8k32 with int32 accumulation, operands double-buffered in
// shared memory (cp.async for int8 operands; the float32 operand of (c) is
// prefetched into registers and quantized into shared memory). A 64-byte K
// chunk lies within one tap when C_in % 16 == 0, so each 16-byte piece of a
// row is one contiguous read of the shifted pixel, or zeros outside the frame.
//
// Numerics as in the JAX code: quantizers divide (IEEE division, rintf rounds
// half to even, no fast math), scales multiply as (row scale * column scale)
// and then the accumulator, with __fmul_rn / __fadd_rn so that no multiply-add
// is contracted; GELU is the tanh form; LN eps 1e-5.
//
// Bound on the H100: operations. A 3x3 conv of [250, 60, 60] pixels from 256
// to 1024 channels is 4.25 T int8 operations, 2.15 ms at 1979 TOP/s, against
// 2.3 GB of bf16 activations (0.69 ms at 3.35 TB/s); K6 is two of them,
// 4.29 ms. What this first design gives away: mma.sync without ldmatrix, TMA
// or wgmma reaches a fraction of the int8 peak; K6's float32 hidden (3.7 GB at
// that shape) and t32 make round trips through device memory. A later design
// keeps a row block's hidden on chip and uses wgmma.

// extra_convs_fp_forward: K6f, one whole ExtraConvs layer in full
// precision. It replaces the same Pallas kernel
// tapnet_tpu/ops/fused_extra_convs.py::_kernel with quantized=False (no model
// path reaches it: the JAX gate wants_fused demands the per-pixel mode), and
// computes what _math_reference(quantized=False) computes:
//   (a) ln_bias_rows: t32 = LN(x) * g + b in float32, and t = t32 rounded to
//       the model dtype (bf16 only; in fp32 conv_up reads t32);
//   (b) conv3x3_<dtype><kUpF>: conv_up of t with the weights in the model
//       dtype, float32 sums, then + bu, GELU (tanh), rounded to the model
//       dtype: the hidden [P, 4C], through device memory (one frame's
//       3600 x 1024 hidden does not fit on an SM);
//   (c) conv3x3_<dtype><kOutF>: conv_out of the hidden, + bo, + t32 (the
//       residual adds the float32 LN output, not t), cast to the model dtype.
// Taps outside the frame read zeros, so the hidden of a pad pixel, which
// would be gelu(bu), never exists. bf16: the int8 loop instantiated with
// mma.sync m16n8k16 and float32 accumulation (a 64-byte K chunk is 32
// values).
// fp32: IEEE float32 products on the SIMT cores (FFMA), not TF32, which
// keeps 10 bits and could not hold the port's 1e-4. Bound: operations,
// 8.49 T at [250, 60, 60] (8.6 ms at the bf16 peak, 127 ms at the fp32
// SIMT peak); the hidden's round trip (1.84 GB in bf16) is 0.55 ms more.
// What this first design gives away: mma.sync without ldmatrix or wgmma,
// the hidden through device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-5f;
constexpr float kAmaxFloor = 1e-8f;
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr int kThreads = 256;

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

__device__ __forceinline__ float gelu_tanh(float v) {
  const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(inner));
}

// The ExtraConvs quantizer: clip(round(v / s), +-127), s from scale_of.
__device__ __forceinline__ float scale_of(float amax) {
  return __fmul_rn(fmaxf(amax, kAmaxFloor), kInv127);
}
__device__ __forceinline__ int quantize(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) |
         ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) |
         ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------- per-frame quantizer

// amax_bits [n] zeroed by the caller; grid (blocks, n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    frame_amax(const T* __restrict__ x, int* __restrict__ amax_bits,
               long long per_frame) {
  __shared__ float partial[kThreads / 32];
  const T* src = x + static_cast<long long>(blockIdx.y) * per_frame;
  float m = 0.f;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < per_frame; i += static_cast<long long>(gridDim.x) * kThreads) {
    m = fmaxf(m, fabsf(to_f(src[i])));
  }
  m = warp_max(m);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? partial[threadIdx.x] : 0.f;
    m = warp_max(m);
    if (threadIdx.x == 0) atomicMax(amax_bits + blockIdx.y, __float_as_int(m));
  }
}

// 16 values per thread and step (per_frame % 16 == 0); grid (blocks, n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_frames(const T* __restrict__ x, const int* __restrict__ amax_bits,
                    int8_t* __restrict__ q, float* __restrict__ scale,
                    long long per_frame) {
  const float s = scale_of(__int_as_float(amax_bits[blockIdx.y]));
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[blockIdx.y] = s;
  const long long base = static_cast<long long>(blockIdx.y) * per_frame;
  const long long groups = per_frame / 16;
  for (long long gi = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       gi < groups; gi += static_cast<long long>(gridDim.x) * kThreads) {
    const T* src = x + base + gi * 16;
    uint32_t words[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      words[w] = pack4(quantize(to_f(src[4 * w]), s), quantize(to_f(src[4 * w + 1]), s),
                       quantize(to_f(src[4 * w + 2]), s), quantize(to_f(src[4 * w + 3]), s));
    }
    *reinterpret_cast<uint4*>(q + base + gi * 16) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
}

// ------------------------------------------------------------- K6 pieces

// (a) One warp per pixel: t32 = (x - mu) * rsqrt(var + eps) * g + b with
// var = mean(x^2) - mu^2; amax[p] = max |t32| (K6) and t = T(t32) (K6f) where
// those pointers are not null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bias_rows(const T* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, float* __restrict__ t32,
                 float* __restrict__ amax, T* __restrict__ t, int rows, int c) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* src = x + static_cast<size_t>(row) * c;
  float s = 0.f, s2 = 0.f;
  for (int k = lane; k < c; k += 32) {
    const float v = to_f(src[k]);
    s += v;
    s2 += v * v;
  }
  const float inv_c = 1.f / static_cast<float>(c);
  const float mu = warp_sum(s) * inv_c;
  const float var = warp_sum(s2) * inv_c - mu * mu;
  const float rs = rsqrtf(var + kEps);
  float* dst = t32 + static_cast<size_t>(row) * c;
  float m = 0.f;
  for (int k = lane; k < c; k += 32) {
    const float v = __fadd_rn(__fmul_rn(__fmul_rn(to_f(src[k]) - mu, rs), g[k]), b[k]);
    dst[k] = v;
    if (t != nullptr) t[static_cast<size_t>(row) * c + k] = from_f<T>(v);
    m = fmaxf(m, fabsf(v));
  }
  m = warp_max(m);
  if (lane == 0 && amax != nullptr) amax[row] = m;
}

// (b) One thread per pixel: the scale of its 3x3 patch.
__global__ void __launch_bounds__(kThreads)
    patch_scale(const float* __restrict__ amax, float* __restrict__ cs, int rows,
                int h, int w) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= rows) return;
  const int rem = p % (h * w);
  const int y = rem / w, x = rem % w;
  float m = 0.f;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      if (y + dy >= 0 && y + dy < h && x + dx >= 0 && x + dx < w) {
        m = fmaxf(m, amax[p + dy * w + dx]);
      }
    }
  }
  cs[p] = scale_of(m);
}

// (d) One warp per row: float32 [rows, n] -> int8 with the row's scale, from
// the amax that the conv_up epilogue gathered (n % 4 == 0).
__global__ void __launch_bounds__(kThreads)
    quantize_rows(const float* __restrict__ h, const int* __restrict__ amax_bits,
                  int8_t* __restrict__ q, float* __restrict__ scale, int rows,
                  int n) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float s = scale_of(__int_as_float(amax_bits[row]));
  const float4* src = reinterpret_cast<const float4*>(h + static_cast<size_t>(row) * n);
  uint32_t* dst = reinterpret_cast<uint32_t*>(q + static_cast<size_t>(row) * n);
  for (int k = lane; k < n / 4; k += 32) {
    const float4 v = src[k];
    dst[k] = pack4(quantize(v.x, s), quantize(v.y, s), quantize(v.z, s),
                   quantize(v.w, s));
  }
  if (lane == 0) scale[row] = s;
}

// ------------------------------------------------ implicit-GEMM 3x3 conv

constexpr int kBM = 128, kBN = 128, kBK = 64;  // kBK in bytes of K
constexpr int kLds = kBK + 16;                 // padded shared row (80 bytes)
constexpr int kTileBytes = kBM * kLds;         // per operand and stage

// Modes of the loop: int8 operands (X, K6) and operands in the model dtype
// (K6f).
constexpr int kFrame = 0;  // int8 A; y = T(acc * (xs[frame] * ws) + b)
constexpr int kUp = 1;     // float32 A, quantized per output row; GELU hidden
constexpr int kOut = 2;    // int8 A; per-tap dequantization; + t32 residual
constexpr int kUpF = 3;    // K6f conv_up: hidden = T(gelu(acc + bu))
constexpr int kOutF = 4;   // K6f conv_out: out = T(t32 + (acc + bo))

struct ConvParams {
  const void* a;           // kFrame, kOut: int8 [P, cin]; kUp: float32 [P, cin];
                           // kUpF: t (t32 in fp32), kOutF: the hidden, in the
                           // model dtype [P, cin]
  const void* wt;          // [cout, 9 * cin], k = tap * cin + c: int8, or the
                           // model dtype in kUpF and kOutF
  const float* row_scale;  // kFrame: [n] per frame; kUp: [P] patch; kOut: [P] pixel
  const float* col_scale;  // int8 modes: [cout]
  const float* bias;       // [cout]
  const float* t32;        // kOut, kOutF: [P, cout] residual
  float* hidden;           // kUp: [P, cout]
  int* amax_bits;          // kUp: [P], zeroed by the caller
  void* out;               // [P, cout] in the model dtype (kUpF: the hidden)
  int n, h, w, cin, cout;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
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

// The loop's MMA: int8 m16n8k32 with int32 accumulation, or bf16 m16n8k16
// with float32 accumulation. Both take 32 bytes of K per instruction, and
// their fragments and accumulators sit at the same offsets, so one tile
// layout serves both. kElem: bytes per operand value.
struct MmaS8 {
  using Acc = int;
  static constexpr int kElem = 1;
  static __device__ __forceinline__ void run(int* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
  }
};
struct MmaBf16 {
  using Acc = float;
  static constexpr int kElem = 2;
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  }
};

// Each tile row's pixel coordinates; past the last pixel -4, so that every
// tap lands outside the frame.
__device__ __forceinline__ void tile_rows(int* s_y, int* s_x, int m0, int rows,
                                          int h, int w) {
  const int hw = h * w;
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int pix = m0 + r;
    s_y[r] = pix < rows ? (pix % hw) / w : -4;
    s_x[r] = pix < rows ? (pix % hw) % w : -4;
  }
}

// Where the A operand at K index k (in values) of tile row r (pixel m0 + r)
// comes from: the element offset of the shifted pixel's channel run in the
// [P, cin] operand, or -1 for zeros (outside the frame, past the last pixel
// or past K).
__device__ __forceinline__ long long a_source(const int* s_y, const int* s_x,
                                              int m0, int r, int k, int K,
                                              int cin, int h, int w) {
  const int tap = k / cin;
  const int c = k - tap * cin;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int y = s_y[r] + dy, x = s_x[r] + dx;
  if (k >= K || y < 0 || y >= h || x < 0 || x >= w) return -1;
  return (static_cast<long long>(m0 + r) + dy * w + dx) * cin + c;
}

// K6f's epilogues, per output element: acc the float32 tap sum.
template <typename T, int MODE>
__device__ __forceinline__ void fp_epilogue(const ConvParams& p, int row,
                                            int col, float acc) {
  const size_t o = static_cast<size_t>(row) * p.cout + col;
  const float v = __fadd_rn(acc, p.bias[col]);
  if constexpr (MODE == kUpF) {
    static_cast<T*>(p.out)[o] = from_f<T>(gelu_tanh(v));
  } else {
    static_cast<T*>(p.out)[o] = from_f<T>(__fadd_rn(p.t32[o], v));
  }
}

// The loop: 128x128 tiles, K by 64 bytes, 8 warps of 64x32, operands
// double-buffered in shared memory (cp.async; the float32 operand of kUp is
// prefetched into registers and quantized into shared memory). T is the
// model dtype; Op the MMA, whose operand type the mode's A and weights have.
// p by value, and each 16-byte piece of A issued beside the weights' piece:
// with the parameters by reference and A and the weights in two passes, X
// and K6f's bf16 path ran 2-5% slower (H100; PERF.md section 6).
template <typename Op, typename T, int MODE>
__device__ __forceinline__ void conv3x3_mma(ConvParams p) {
  using Acc = typename Op::Acc;
  constexpr bool kFloat = MODE == kUpF || MODE == kOutF;
  constexpr int kVals = kBK / Op::kElem;  // K values per chunk
  __shared__ __align__(128) int8_t as[2][kTileBytes];
  __shared__ __align__(128) int8_t bs[2][kTileBytes];
  __shared__ int s_y[kBM], s_x[kBM];
  __shared__ float s_rs[kBM];  // kUp: each row's patch scale

  const int hw = p.h * p.w;
  const int rows = p.n * hw;
  const int K = 9 * p.cin;
  const int ncol = (p.cout + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / ncol) * kBM;
  const int n0 = (blockIdx.x % ncol) * kBN;
  const int tid = threadIdx.x;
  tile_rows(s_y, s_x, m0, rows, p.h, p.w);
  if constexpr (MODE == kUp) {
    for (int r = tid; r < kBM; r += kThreads) {
      s_rs[r] = m0 + r < rows ? p.row_scale[m0 + r] : 1.f;
    }
  }
  __syncthreads();

  const char* a_bytes = static_cast<const char*>(p.a);
  const char* w_bytes = static_cast<const char*>(p.wt);

  // 512 pieces of 16 bytes per operand tile: 2 per thread, row = piece / 4.
  // The weights' pieces, and with `with_a` the A operand's, by cp.async.
  auto load = [&](int stage, int k0, bool with_a) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int piece = tid + i * kThreads;
      const int r = piece >> 2, cc = (piece & 3) * 16;
      const int k = k0 + cc / Op::kElem;
      if (with_a) {
        const long long src = a_source(s_y, s_x, m0, r, k, K, p.cin, p.h, p.w);
        cp_async16(&as[stage][r * kLds + cc],
                   src >= 0 ? a_bytes + src * Op::kElem : a_bytes, src >= 0);
      }
      const bool pred = (n0 + r < p.cout) && (k < K);
      const char* src =
          pred ? w_bytes + (static_cast<size_t>(n0 + r) * K + k) * Op::kElem : w_bytes;
      cp_async16(&bs[stage][r * kLds + cc], src, pred);
    }
  };
  float4 up_regs[2][4];
  auto fetch_a_up = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int piece = tid + i * kThreads;
      const int r = piece >> 2, cc = (piece & 3) * 16;
      const long long src = a_source(s_y, s_x, m0, r, k0 + cc, K, p.cin, p.h, p.w);
      const float4* v = reinterpret_cast<const float4*>(
          static_cast<const float*>(p.a) + (src >= 0 ? src : 0));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        up_regs[i][j] = src >= 0 ? v[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  auto store_a_up = [&](int stage) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int piece = tid + i * kThreads;
      const int r = piece >> 2, cc = (piece & 3) * 16;
      const float s = s_rs[r];
      uint32_t words[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = up_regs[i][j];
        words[j] = pack4(quantize(v.x, s), quantize(v.y, s), quantize(v.z, s),
                         quantize(v.w, s));
      }
      *reinterpret_cast<uint4*>(&as[stage][r * kLds + cc]) =
          make_uint4(words[0], words[1], words[2], words[3]);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each
  const int g = lane >> 2, tq = lane & 3;

  // This thread's 8 columns: col(j, e) = n0 + wn*32 + j*8 + tq*2 + e.
  float cscale[4][2], cbias[4][2];
  if constexpr (!kFloat) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + wn * 32 + j * 8 + tq * 2 + e;
        cscale[j][e] = col < p.cout ? p.col_scale[col] : 0.f;
        cbias[j][e] = col < p.cout ? p.bias[col] : 0.f;
      }
    }
  }

  Acc acc[4][4][4];
  float facc[4][4][4];  // kOut: the float32 sum over the finished taps
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        facc[i][j][e] = 0.f;
      }

  const int nk = (K + kVals - 1) / kVals;
  const int chunks_per_tap = p.cin / kBK;  // kOut: cin % kBK == 0
  if constexpr (MODE == kUp) {
    fetch_a_up(0);
    store_a_up(0);
  }
  load(0, 0, MODE != kUp);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load(cur ^ 1, (kt + 1) * kVals, MODE != kUp);
      cp_async_commit();
      if constexpr (MODE == kUp) fetch_a_up((kt + 1) * kVals);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* base = &as[cur][(wm * 64 + i * 16 + g) * kLds + ks + tq * 4];
        af[i][0] = *reinterpret_cast<const uint32_t*>(base);
        af[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLds);
        af[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLds + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* base = &bs[cur][(wn * 32 + j * 8 + g) * kLds + ks + tq * 4];
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(base);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Op::run(acc[i][j], af[i], bfr[j]);
    }

    if constexpr (MODE == kOut) {
      // After the last K chunk of a tap: that tap's int32 partial, scaled by
      // the scale of the pixel it read, joins the float32 sum.
      if ((kt + 1) % chunks_per_tap == 0) {
        const int tap = kt / chunks_per_tap;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wm * 64 + i * 16 + g + half * 8;
            const int y = s_y[r] + dy, x = s_x[r] + dx;
            const float vs = (y >= 0 && y < p.h && x >= 0 && x < p.w)
                                 ? p.row_scale[m0 + r + dy * p.w + dx]
                                 : 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int idx = half * 2 + e;
                const float part = __int2float_rn(acc[i][j][idx]);
                facc[i][j][idx] = __fadd_rn(
                    facc[i][j][idx], __fmul_rn(part, __fmul_rn(vs, cscale[j][e])));
                acc[i][j][idx] = 0;
              }
            }
          }
        }
      }
    }
    if constexpr (MODE == kUp) {
      if (kt + 1 < nk) store_a_up(cur ^ 1);
    }
    __syncthreads();
  }

  // Epilogue. Accumulator element idx = half*2 + e of tile (i, j) is row
  // wm*64 + i*16 + g + half*8, column wn*32 + j*8 + tq*2 + e.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 64 + i * 16 + g + half * 8;
      const int row = m0 + r;
      const bool row_ok = row < rows;
      if constexpr (kFloat) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + wn * 32 + j * 8 + tq * 2 + e;
            if (row_ok && col < p.cout) {
              fp_epilogue<T, MODE>(p, row, col, acc[i][j][half * 2 + e]);
            }
          }
        }
      } else {
        float rscale = 0.f;
        if constexpr (MODE == kFrame) rscale = row_ok ? p.row_scale[row / hw] : 0.f;
        if constexpr (MODE == kUp) rscale = s_rs[r];
        float habs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + wn * 32 + j * 8 + tq * 2 + e;
            const int idx = half * 2 + e;
            if (!row_ok || col >= p.cout) continue;
            const size_t o = static_cast<size_t>(row) * p.cout + col;
            if constexpr (MODE == kOut) {
              const float y = __fadd_rn(facc[i][j][idx], cbias[j][e]);
              static_cast<T*>(p.out)[o] = from_f<T>(__fadd_rn(p.t32[o], y));
            } else {
              const float v = __fadd_rn(
                  __fmul_rn(__int2float_rn(acc[i][j][idx]), __fmul_rn(rscale, cscale[j][e])),
                  cbias[j][e]);
              if constexpr (MODE == kFrame) {
                static_cast<T*>(p.out)[o] = from_f<T>(v);
              } else {
                const float hv = gelu_tanh(v);
                p.hidden[o] = hv;
                habs = fmaxf(habs, fabsf(hv));
              }
            }
          }
        }
        if constexpr (MODE == kUp) {
          // The 4 lanes of a group hold the same row.
          habs = fmaxf(habs, __shfl_xor_sync(0xffffffffu, habs, 1));
          habs = fmaxf(habs, __shfl_xor_sync(0xffffffffu, habs, 2));
          if (tq == 0 && row_ok) atomicMax(p.amax_bits + row, __float_as_int(habs));
        }
      }
    }
  }
}

// X and K6: int8 operands.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) conv3x3_q8(ConvParams p) {
  conv3x3_mma<MmaS8, T, MODE>(p);
}

// K6f in bf16: the same loop on bf16 operands (a 64-byte K chunk is 32
// values).
template <int MODE>
__global__ void __launch_bounds__(kThreads) conv3x3_bf16(ConvParams p) {
  conv3x3_mma<MmaBf16, bf16, MODE>(p);
}

// K6f in fp32: SIMT, 128 x 128 tiles, K chunks of 16 values, each thread an
// 8 x 8 block of outputs by fmaf (IEEE float32). Both operands are read as
// 16-byte pieces into registers one chunk ahead and stored k-major
// ([k][row]), so a step of the product reads 8 rows and 8 columns as float4s.
constexpr int kFK = 16;
constexpr int kFLd = kBM + 4;

template <int MODE>
__global__ void __launch_bounds__(kThreads) conv3x3_f32(ConvParams p) {
  __shared__ __align__(16) float as[2][kFK][kFLd];
  __shared__ __align__(16) float bs[2][kFK][kFLd];
  __shared__ int s_y[kBM], s_x[kBM];

  const int rows = p.n * p.h * p.w;
  const int K = 9 * p.cin;
  const int ncol = (p.cout + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / ncol) * kBM;
  const int n0 = (blockIdx.x % ncol) * kBN;
  const int tid = threadIdx.x;
  tile_rows(s_y, s_x, m0, rows, p.h, p.w);
  __syncthreads();
  const float* a = static_cast<const float*>(p.a);
  const float* wt = static_cast<const float*>(p.wt);

  float4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int piece = tid + i * kThreads;
      const int r = piece >> 2, k = k0 + (piece & 3) * 4;
      const long long src = a_source(s_y, s_x, m0, r, k, K, p.cin, p.h, p.w);
      ra[i] = src >= 0 ? *reinterpret_cast<const float4*>(a + src)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      rb[i] = (n0 + r < p.cout && k < K)
                  ? *reinterpret_cast<const float4*>(
                        wt + static_cast<size_t>(n0 + r) * K + k)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int stage) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int piece = tid + i * kThreads;
      const int r = piece >> 2, kk = (piece & 3) * 4;
      as[stage][kk][r] = ra[i].x;
      as[stage][kk + 1][r] = ra[i].y;
      as[stage][kk + 2][r] = ra[i].z;
      as[stage][kk + 3][r] = ra[i].w;
      bs[stage][kk][r] = rb[i].x;
      bs[stage][kk + 1][r] = rb[i].y;
      bs[stage][kk + 2][r] = rb[i].z;
      bs[stage][kk + 3][r] = rb[i].w;
    }
  };

  const int tx = tid & 15, ty = tid >> 4;  // rows ty*8.., columns tx*8..
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + kFK - 1) / kFK;
  fetch(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kFK);
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 8 + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx * 8 + j;
      if (col < p.cout) fp_epilogue<float, MODE>(p, row, col, acc[i][j]);
    }
  }
}

template <typename T, int MODE>
cudaError_t run_conv(const ConvParams& prm, cudaStream_t s) {
  const long long rows = static_cast<long long>(prm.n) * prm.h * prm.w;
  const long long blocks = ((rows + kBM - 1) / kBM) * ((prm.cout + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  if constexpr (MODE != kUpF && MODE != kOutF) {
    conv3x3_q8<T, MODE><<<grid, kThreads, 0, s>>>(prm);
  } else if constexpr (sizeof(T) == 2) {
    conv3x3_bf16<MODE><<<grid, kThreads, 0, s>>>(prm);
  } else {
    conv3x3_f32<MODE><<<grid, kThreads, 0, s>>>(prm);
  }
  return cudaGetLastError();
}

int grid_for(long long work, int per_block) {
  const long long b = (work + per_block - 1) / per_block;
  return static_cast<int>(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

template <typename T>
int launch_frame(const void* x, const void* wq, const void* ws, const void* bias,
                 void* amax, void* xq, void* xs, void* out, int n, int h, int w,
                 int cin, int cout, cudaStream_t s) {
  const long long per_frame = static_cast<long long>(h) * w * cin;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(int) * n, s);
  if (err != cudaSuccess) return err;
  dim3 amax_grid(grid_for(per_frame, kThreads * 16), n);
  frame_amax<T><<<amax_grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                               static_cast<int*>(amax), per_frame);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 q_grid(grid_for(per_frame / 16, kThreads * 4), n);
  quantize_frames<T><<<q_grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(amax),
      static_cast<int8_t*>(xq), static_cast<float*>(xs), per_frame);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ConvParams prm{xq, wq, static_cast<const float*>(xs),
                 static_cast<const float*>(ws), static_cast<const float*>(bias),
                 nullptr, nullptr, nullptr, out, n, h, w, cin, cout};
  return run_conv<T, kFrame>(prm, s);
}

template <typename T>
int launch_pixel(const void* x, const void* g, const void* bln, const void* wuq,
                 const void* su, const void* bu, const void* woq, const void* so,
                 const void* bo, void* t32, void* pixel_amax, void* cs,
                 void* hidden, void* hidden_amax, void* hq, void* hs, void* out,
                 int n, int h, int w, int c, int m, cudaStream_t s) {
  const int rows = n * h * w;
  const int warp_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  ln_bias_rows<T><<<warp_blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(bln), static_cast<float*>(t32),
      static_cast<float*>(pixel_amax), nullptr, rows, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  patch_scale<<<(rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(pixel_amax), static_cast<float*>(cs), rows, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(hidden_amax, 0, sizeof(int) * rows, s);
  if (err != cudaSuccess) return err;
  ConvParams up{t32, wuq, static_cast<const float*>(cs),
                static_cast<const float*>(su), static_cast<const float*>(bu),
                nullptr, static_cast<float*>(hidden), static_cast<int*>(hidden_amax),
                nullptr, n, h, w, c, m};
  err = run_conv<T, kUp>(up, s);
  if (err != cudaSuccess) return err;
  quantize_rows<<<warp_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(hidden), static_cast<const int*>(hidden_amax),
      static_cast<int8_t*>(hq), static_cast<float*>(hs), rows, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ConvParams down{hq, woq, static_cast<const float*>(hs),
                  static_cast<const float*>(so), static_cast<const float*>(bo),
                  static_cast<const float*>(t32), nullptr, nullptr, out,
                  n, h, w, m, c};
  return run_conv<T, kOut>(down, s);
}

template <typename T>
int launch_fp(const void* x, const void* g, const void* bln, const void* wu,
              const void* bu, const void* wo, const void* bo, void* t32,
              void* t, void* hidden, void* out, int n, int h, int w, int c,
              int m, cudaStream_t s) {
  const int rows = n * h * w;
  const int warp_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  // fp32: conv_up reads t32 itself.
  T* t_cast = sizeof(T) == 2 ? static_cast<T*>(t) : nullptr;
  ln_bias_rows<T><<<warp_blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(bln), static_cast<float*>(t32), nullptr,
      t_cast, rows, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const void* up_in = sizeof(T) == 2 ? t : t32;
  ConvParams up{up_in, wu, nullptr, nullptr, static_cast<const float*>(bu),
                nullptr, nullptr, nullptr, hidden, n, h, w, c, m};
  err = run_conv<T, kUpF>(up, s);
  if (err != cudaSuccess) return err;
  ConvParams down{hidden, wo, nullptr, nullptr, static_cast<const float*>(bo),
                  static_cast<const float*>(t32), nullptr, nullptr, out,
                  n, h, w, m, c};
  return run_conv<T, kOutF>(down, s);
}

}  // namespace

extern "C" {

// Per-frame int8 SAME 3x3 convolution. x [n, h, w, cin] (NHWC) in the model
// dtype (0: float32, 1: bfloat16); wq int8 [cout, 3, 3, cin] with float32
// scales ws [cout]; bias float32 [cout]; scratch amax int32 [n], xq int8
// [n, h, w, cin], xs float32 [n]; out [n, h, w, cout] in the model dtype.
// cin and cout multiples of 16. Returns the first failing cudaError_t.
int conv3x3_q8_frame_forward(const void* x, const void* wq, const void* ws,
                             const void* bias, void* amax, void* xq, void* xs,
                             void* out, int n, int h, int w, int cin, int cout,
                             int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin % 16 != 0 ||
      cout % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_frame<float>(x, wq, ws, bias, amax, xq, xs, out, n, h, w, cin,
                               cout, s);
  }
  if (dtype == 1) {
    return launch_frame<bf16>(x, wq, ws, bias, amax, xq, xs, out, n, h, w, cin,
                              cout, s);
  }
  return cudaErrorInvalidValue;
}

// K6: one ExtraConvs layer with per-pixel int8 scales. x [n, h, w, c] (NHWC)
// in the model dtype; g, bln [c], bu [m], bo [c] float32; wuq int8
// [m, 3, 3, c] and woq int8 [c, 3, 3, m] with float32 scales su [m], so [c];
// scratch t32 float32 [rows, c], pixel_amax and cs float32 [rows], hidden
// float32 [rows, m], hidden_amax int32 [rows], hq int8 [rows, m], hs float32
// [rows] (rows = n*h*w); out [n, h, w, c] in the model dtype. c % 16 == 0,
// m % 64 == 0.
int extra_convs_q8_pixel_forward(const void* x, const void* g, const void* bln,
                                 const void* wuq, const void* su, const void* bu,
                                 const void* woq, const void* so, const void* bo,
                                 void* t32, void* pixel_amax, void* cs,
                                 void* hidden, void* hidden_amax, void* hq,
                                 void* hs, void* out, int n, int h, int w, int c,
                                 int m, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || m <= 0 || c % 16 != 0 ||
      m % kBK != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_pixel<float>(x, g, bln, wuq, su, bu, woq, so, bo, t32,
                               pixel_amax, cs, hidden, hidden_amax, hq, hs, out,
                               n, h, w, c, m, s);
  }
  if (dtype == 1) {
    return launch_pixel<bf16>(x, g, bln, wuq, su, bu, woq, so, bo, t32,
                              pixel_amax, cs, hidden, hidden_amax, hq, hs, out,
                              n, h, w, c, m, s);
  }
  return cudaErrorInvalidValue;
}

// K6f: one ExtraConvs layer in full precision. x [n, h, w, c] (NHWC) in the
// model dtype (0: float32, 1: bfloat16); g, bln [c], bu [m], bo [c] float32;
// wu [m, 3, 3, c] and wo [c, 3, 3, m] in the model dtype (OHWI); scratch t32
// float32 [rows, c], t [rows, c] in the model dtype (read only in bf16),
// hidden [rows, m] in the model dtype (rows = n*h*w); out [n, h, w, c] in
// the model dtype. c and m multiples of 16.
int extra_convs_fp_forward(const void* x, const void* g, const void* bln,
                           const void* wu, const void* bu, const void* wo,
                           const void* bo, void* t32, void* t, void* hidden,
                           void* out, int n, int h, int w, int c, int m,
                           int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || m <= 0 || c % 16 != 0 ||
      m % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_fp<float>(x, g, bln, wu, bu, wo, bo, t32, t, hidden, out, n,
                            h, w, c, m, s);
  }
  if (dtype == 1) {
    return launch_fp<bf16>(x, g, bln, wu, bu, wo, bo, t32, t, hidden, out, n,
                           h, w, c, m, s);
  }
  return cudaErrorInvalidValue;
}

const char* tapnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

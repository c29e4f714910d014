// The ExtraConvs of BootsTAPIR, hand-written for Hopper (sm_90a). The
// per-frame int8 convolution (X) and the float layer's two products (K6f:
// bf16, and float32 as error-compensated TF32) run on the TMA + wgmma GEMM
// loop of tma_gemm.cuh, which K3's products share. The per-pixel int8 layer
// (K6) runs on the int8 tile loop of q8_tile.cuh, which K4
// (csrc/fused_mixer_block.cu) shares.
//
// conv3x3_q8_frame_forward: the per-frame w8a8 SAME 3x3 stride-1 convolution
// (quantized_extra_convs=True). It replaces XLA's int8 convolution of
// tapnet_tpu/ops/qconv.py::conv2d_q8_math, which has no Pallas kernel and no
// PyTorch counterpart on CUDA. Three launches:
//   (1) frame_amax: max |x| over each frame's H*W*C (atomicMax on the bits of
//       a non-negative float, ordered as integers);
//   (2) quantize_frames: xq = clip(rint(x / xs), +-127), xs = max(amax, 1e-8)
//       * (1/127), one scale per frame, written as padded frames [N, H+2,
//       W+2, C_in] with a zero ring;
//   (3) conv3x3_q8_tma: the convolution as one GEMM over the padded raster
//       (tg::gemm, s8 x s8 -> s32, 128 x 256 tiles), then y = acc *
//       (xs[frame] * ws[col]) + b[col], cast to the model dtype, stored for
//       the rows inside their frame only.
// The padded slab: row p' = (n (H+2) + y') (W+2) + x' of the GEMM is a
// padded pixel, and tap (dy, dx) of every row of a tile reads the rows p' +
// dy (W+2) + dx of xq viewed as [N (H+2) (W+2), C_in]: one 2D TMA box at a
// shifted row coordinate (TMA fills rows outside the tensor with zeros; a
// row inside its frame never reads across the ring). K = 9 C_in tap-major,
// in steps of 128 channels (zeros past C_in), the weights [C_out, 3, 3,
// C_in] a 3D tensor map {C_in, 9, C_out}. The ring rows are computed and
// dropped: 6.8% more work at 60x60, 13% at 32x32, the price of one box per
// tap (ops/qconv.py::conv2d_q8_padded_slab emulates this indexing in
// float64).
//
// Bound on the H100: operations. A 3x3 conv of [250, 60, 60] pixels from 256
// to 1024 channels is 4.25 T int8 operations, 2.15 ms at 1979 TOP/s, against
// 2.3 GB of bf16 activations (0.69 ms at 3.35 TB/s). PERF.md section 6 has
// what the design reaches and what holds it back.
//
// extra_convs_q8_pixel_forward: K6, one whole ExtraConvs layer with per-pixel
// int8 scales (quantized_extra_convs="per_pixel"). It replaces the Pallas TPU
// kernel tapnet_tpu/ops/fused_extra_convs.py::_kernel (launched by
// _pallas_forward) with quantized=True, and computes what its reference
// _math_reference(quantized=True) computes. Four launches:
//   (a) ln_bias_rows: t32 = LN(x) * g + b in float32 (single-pass
//       statistics), and each pixel's amax of |t32|;
//   (b) patch_scale: cs[p] = max(amax over the in-frame 3x3 neighbours of p,
//       1e-8) * (1/127), the scale of p's whole 3x3xC patch (zero padding
//       does not raise an amax);
//   (c) k6_conv_up: one CTA per block of 64 output pixels. It quantizes the
//       block's 3x3xC patches once, with each row's patch scale (one IEEE
//       division per value and output pixel: the same input value is
//       quantized differently for each of the 9 output pixels that read it),
//       and keeps them in shared memory (64 x 2304 bytes at C = 256). It then
//       walks all M output columns over that patch twice. Its two
//       warpgroups take alternate 128-column steps (wgmma m64n128k32), each
//       streaming its int8 weights [M, 9C] through a cp.async ring of its
//       own, from a different K panel, so that one's epilogue overlaps the
//       other's loads. Pass 1 gathers each pixel's amax of
//       GELU(acc * (cs * su) + bu): the CTA sees a pixel's whole hidden row,
//       so the amax needs no atomics. Pass 2 recomputes the same products
//       and values (one code site, rounded at every step, so both passes
//       give the same floats), quantizes them with hs = max(amax, 1e-8) /
//       127 and writes only the int8 hidden [P, M] and hs. The float32
//       hidden never reaches device memory (a debug pointer, null on the
//       main path, stores it for checks).
//   (d) k6_conv_out: conv_out with per-tap exact dequantization, 128x128
//       tiles (two warpgroups of m64n128) over a ring that carries both
//       operands: after each tap's K range, that tap's int32 partial is
//       scaled by vs[p + off_tap] * so[col] (the scale of the pixel the tap
//       READS, so it cannot leave the tap sum) and summed in float32 from
//       zero in tap order; then + bo, + t32, cast to the model dtype.
// Both products run on the int8 tile loop of q8_tile.cuh (wgmma on
// swizzled shared-memory panels). The TPU kernel keeps one frame's t32,
// hidden and int8 copies in VMEM; here one frame's 62x62x1024 hidden does
// not fit on an SM, and the int8 hidden goes through device memory.
//
// Bound on the H100: operations, two 3x3 products of 4.25 T int8 operations
// each at [250, 60, 60] (4.29 ms at 1979 TOP/s); pass 1 adds half again to
// the operations (the price of keeping the float32 hidden, 3.7 GB at that
// shape, off device memory). What holds this design back (PERF.md section
// 6): a 64-pixel CTA reads the weights (2.36 MB) twice from L2 for 604 M
// operations, 128 a byte, and L2 feeds the SMs about 3.5 TB/s; the patch
// (147 KB) leaves room for only 80 KB of ring, so the epilogues (GELU,
// division, stores on 8 warps) and the patch build do not hide behind the
// loads.
//
// Numerics as in the JAX code: quantizers divide (IEEE division, rintf
// rounds half to even, no fast math), scales multiply as (row scale * column
// scale) and then the accumulator, with __fmul_rn / __fadd_rn so that no
// multiply-add is contracted; GELU is the tanh form; LN eps 1e-5.

// extra_convs_fp_forward: K6f, one whole ExtraConvs layer in full
// precision. It replaces the same Pallas kernel
// tapnet_tpu/ops/fused_extra_convs.py::_kernel with quantized=False (no model
// path reaches it: the JAX gate wants_fused demands the per-pixel mode), and
// computes what _math_reference(quantized=False) computes:
//   t32 = LN(x) * g + b (float32);  h = T(gelu(conv_up(T(t32)) + bu));
//   y = T(t32 + (conv_out(h) + bo))
// with T the model dtype, float32 sums, the residual on the float32 LN
// output (not t). Taps outside the frame read zeros, so the hidden of a pad
// pixel, which would be gelu(bu), never reaches conv_out. Three launches
// (float32: five, the weights' split first), X's padded-slab formulation:
//   (a) ln_bias_slab<T>: t32 dense [n*h*w, c], and t = T(t32) into the
//       padded slab [n, h+2, w+2, c] with a zero ring (in float32 t is t32);
//   (b) conv_up as one tg::gemm over the padded raster, a shifted row box of
//       the slab per tap (SlabLoader), the weights [m, 3, 3, c] a 3D tensor
//       map {c, 9, m}; the epilogue (UpSlabEpilogue) writes T(gelu(acc +
//       bu)) into a second padded slab [n, h+2, w+2, m], zeros on its ring
//       rows, so that conv_out reads a zero ring without a memset;
//   (c) conv_out the same way over the hidden slab; the epilogue
//       (OutSlabEpilogue) stages acc + bo in float32 and stores T(t32 + (acc
//       + bo)) for the rows inside their frame only, dense [n, h, w, c].
// bf16 (conv3x3_bf16_tma): bf16 x bf16 -> f32 on 128 x 256 tiles. float32
// (conv3x3_tf32x3_tma): tg::Tf32x3 on 128 x 128 tiles, each operand v =
// tf32(v) + tf32(v - tf32(v)) and three TF32 products, each stage's sum
// added to a second accumulator in IEEE float32, which holds the port's
// 1e-4 at conv_out's K of 9 * 1024 (PERF.md section 6). tg::split_weights
// splits each conv's weights into a [2, cout, 9, cin] scratch first (big
// rows, then small); the B map {cin, 9, 2 cout} puts the small half of a
// tile's columns n0 .. at row n0 + cout (Tf32x3::b_row). A is split in
// registers from the swizzled slab box.
// Bound: operations, two 3x3 products of 2 * 9 * 256 * 1024 operations per
// pixel, 8.49 T at [250, 60, 60]: 8.6 ms at the bf16 peak, 51.5 ms in
// float32 (three TF32 products at 495 TFLOP/s); the hidden's round trip
// (1.97 GB in the bf16 slab, 3.94 GB in float32) is 0.6 and 1.2 ms more. The
// ring rows are computed and dropped, as X's: 6.8% more work at 60x60, 13%
// at 32x32. conv_up has 36 K steps a tile in bf16 (9 taps x 4), 72 in
// float32 (9 x 8), so its GELU epilogue weighs little beside the products;
// the persistent CTAs walk N fastest, so conv_up's N tiles of the weights
// (bf16: four of 1.2 MB; float32: eight of 2.4 MB, split) and conv_out's
// (one of 4.7 MB; two of 9.4 MB) stay in L2 (50 MB).
// (fused_extra_convs.fp_padded_slab emulates this indexing in float64, and
// with terms="tf32x3" the float32 arithmetic.)

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

// 16 consecutive values (64- or 32-byte aligned) as floats, in 16-byte loads.
__device__ __forceinline__ void load16(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
}
__device__ __forceinline__ void load16(const bf16* p, float* v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 q = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[8 * i + 2 * k] = f.x;
      v[8 * i + 2 * k + 1] = f.y;
    }
  }
}

// amax_bits [n] zeroed by the caller; 16 values per thread and step
// (per_frame % 16 == 0, x 16-byte aligned); grid (blocks, n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    frame_amax(const T* __restrict__ x, int* __restrict__ amax_bits,
               long long per_frame) {
  __shared__ float partial[kThreads / 32];
  const T* src = x + static_cast<long long>(blockIdx.y) * per_frame;
  float m = 0.f;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       g < per_frame / 16; g += static_cast<long long>(gridDim.x) * kThreads) {
    float v[16];
    load16(src + g * 16, v);
#pragma unroll
    for (int k = 0; k < 16; ++k) m = fmaxf(m, fabsf(v[k]));
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

// Writes the padded frames xq [n, h+2, w+2, c] (c % 16 == 0, x 16-byte
// aligned): the quantized frame inside a ring of zeros, 16 values per thread
// and step; grid (blocks, n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_frames(const T* __restrict__ x, const int* __restrict__ amax_bits,
                    int8_t* __restrict__ q, float* __restrict__ scale, int h,
                    int w, int c) {
  const float s = q8::scale_div(__int_as_float(amax_bits[blockIdx.y]));
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[blockIdx.y] = s;
  const int wp = w + 2, groups_per_pixel = c / 16;
  const long long padded = static_cast<long long>(h + 2) * wp * c;
  const T* src_frame = x + static_cast<long long>(blockIdx.y) * h * w * c;
  int8_t* dst_frame = q + static_cast<long long>(blockIdx.y) * padded;
  const long long groups = padded / 16;
  for (long long gi = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       gi < groups; gi += static_cast<long long>(gridDim.x) * kThreads) {
    const int pixel = static_cast<int>(gi / groups_per_pixel);
    const int ch = static_cast<int>(gi - static_cast<long long>(pixel) * groups_per_pixel) * 16;
    const int py = pixel / wp, px = pixel - py * wp;
    uint32_t words[4] = {0u, 0u, 0u, 0u};
    if (py >= 1 && py <= h && px >= 1 && px <= w) {
      float v[16];
      load16(src_frame + (static_cast<long long>(py - 1) * w + (px - 1)) * c + ch, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        words[k] = pack4(q8::quantize_div(v[4 * k], s), q8::quantize_div(v[4 * k + 1], s),
                         q8::quantize_div(v[4 * k + 2], s), q8::quantize_div(v[4 * k + 3], s));
      }
    }
    *reinterpret_cast<uint4*>(dst_frame + gi * 16) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
}

// ------------------------------------------------------ X on tma_gemm.cuh

// K step kk of a convolution over padded frames (X, K6f in bf16) is tap kk /
// per_tap, channels (kk % per_tap) * step .. (step: the values of tg::kBK
// bytes); the A box of a tile at padded row m0 starts at row m0 + dy (w+2) +
// dx of the padded frames [rows, c_in], the B box at {channel, tap, column}
// of the weights [c_out, 9, c_in].
struct SlabLoader {
  static constexpr int kBDims = 3;
  int per_tap, wp, step;
  __device__ __forceinline__ void a(int kk, int m0, int& c0, int& c1) const {
    const int tap = kk / per_tap;
    c0 = (kk - tap * per_tap) * step;
    c1 = m0 + (tap / 3 - 1) * wp + (tap % 3 - 1);
  }
  __device__ __forceinline__ void b(int kk, int n, int& c0, int& c1, int& c2) const {
    const int tap = kk / per_tap;
    c0 = (kk - tap * per_tap) * step;
    c1 = tap;
    c2 = n;
  }
};

// Row r of padded frames [n, h+2, w+2, .]: its frame and its pixel's row and
// column in the frame (-1, h or w on the ring).
struct PaddedRow {
  int frame, y, x;
  __device__ __forceinline__ PaddedRow(int r, int h, int w) {
    const int wp = w + 2, plane = (h + 2) * wp;
    frame = r / plane;
    const int rem = r - frame * plane;
    y = rem / wp - 1;
    x = rem - (y + 1) * wp - 1;
  }
  __device__ __forceinline__ bool inside(int h, int w) const {
    return y >= 0 && y < h && x >= 0 && x < w;
  }
  // The pixel's index in dense frames [n, h, w, .].
  __device__ __forceinline__ size_t pixel(int h, int w) const {
    return (static_cast<size_t>(frame) * h + y) * w + x;
  }
};

// y = T(acc * (xs[frame] * ws[col]) + b[col]) for the padded rows inside
// their frame, into out [n, h, w, c_out].
template <typename T>
struct FrameEpilogue {
  using Out = T;
  const float* xs;
  const float* ws;
  const float* bias;
  T* out;
  int h, w, cout;
  struct Row {
    bool ok;
    float scale;
    T* dst;
  };
  __device__ __forceinline__ Row row(int r) const {
    const PaddedRow p(r, h, w);
    if (!p.inside(h, w)) return Row{false, 0.f, nullptr};
    return Row{true, xs[p.frame], out + p.pixel(h, w) * cout};
  }
  __device__ __forceinline__ float value(const Row& r, int col, int s) const {
    return __fadd_rn(__fmul_rn(__int2float_rn(s), __fmul_rn(r.scale, ws[col])), bias[col]);
  }
  __device__ __forceinline__ void store(const Row& r, int col, uint4 v) const {
    *reinterpret_cast<uint4*>(r.dst + col) = v;
  }
};

template <typename T>
__global__ void __launch_bounds__(tg::kThreads, 1)
    conv3x3_q8_tma(const __grid_constant__ CUtensorMap xq_map,
                   const __grid_constant__ CUtensorMap w_map, tg::Problem pb,
                   SlabLoader ld, FrameEpilogue<T> ep) {
  extern __shared__ __align__(16) int8_t smem_raw[];
  tg::gemm<tg::S8>(smem_raw, &xq_map, &w_map, pb, ld, ep);
}

// ------------------------------------------------------- LayerNorm, scales

// One warp's LayerNorm of a pixel's c values: t32 = (x - mu) * rsqrt(var +
// eps) * g + b with var = mean(x^2) - mu^2, into dst32, and T(t32) into t
// where it is not null. Returns the row's max |t32| (in every lane).
template <typename T>
__device__ __forceinline__ float ln_row(const T* __restrict__ src,
                                        const float* __restrict__ g,
                                        const float* __restrict__ b,
                                        float* __restrict__ dst32,
                                        T* __restrict__ t, int c, int lane) {
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
  float m = 0.f;
  for (int k = lane; k < c; k += 32) {
    const float v = __fadd_rn(__fmul_rn(__fmul_rn(to_f(src[k]) - mu, rs), g[k]), b[k]);
    dst32[k] = v;
    if (t != nullptr) t[k] = from_f<T>(v);
    m = fmaxf(m, fabsf(v));
  }
  return warp_max(m);
}

// (a) One warp per pixel: t32 and, where amax is not null, amax[p] = max
// |t32| (K6; K6f in fp32 passes null).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bias_rows(const T* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, float* __restrict__ t32,
                 float* __restrict__ amax, int rows, int c) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float m = ln_row<T>(x + static_cast<size_t>(row) * c, g, b,
                            t32 + static_cast<size_t>(row) * c, nullptr, c, lane);
  if (lane == 0 && amax != nullptr) amax[row] = m;
}

// (a) of K6f: one warp per row of the padded slab t [n, h+2, w+2, c] in the
// model dtype T: zeros on the ring; inside, the pixel's t32 (dense [n*h*w,
// c]) and T(t32) in the slab row (in float32 the same values).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bias_slab(const T* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, float* __restrict__ t32,
                 T* __restrict__ t, int padded_rows, int h, int w, int c) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= padded_rows) return;
  T* dst = t + static_cast<size_t>(row) * c;
  const PaddedRow p(row, h, w);
  if (!p.inside(h, w)) {
    for (int k = lane; k < c; k += 32) dst[k] = from_f<T>(0.f);
    return;
  }
  const size_t pix = p.pixel(h, w) * c;
  ln_row<T>(x + pix, g, b, t32 + pix, dst, c, lane);
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
  cs[p] = q8::scale_div(m);
}

// Pixel coordinates of `count` rows from m0; past the last pixel -4, so that
// every tap lands outside the frame.
__device__ __forceinline__ void tile_rows(int* s_y, int* s_x, int m0, int count,
                                          int rows, int h, int w) {
  const int hw = h * w;
  for (int r = threadIdx.x; r < count; r += blockDim.x) {
    const int pix = m0 + r;
    s_y[r] = pix < rows ? (pix % hw) / w : -4;
    s_x[r] = pix < rows ? (pix % hw) % w : -4;
  }
}

// Where the operand at K index k (in values) of tile row r (pixel m0 + r)
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

// ------------------------------------------------------ K6f on tma_gemm

// conv_up's epilogue: the hidden slab [n, h+2, w+2, m] in the model dtype T
// gets T(gelu(acc + bu)) on the rows inside their frame and zeros on its
// ring rows (every row of the GEMM is stored), so that conv_out reads a zero
// ring without a memset.
template <typename T>
struct UpSlabEpilogue {
  using Out = T;
  const float* bias;
  T* hidden;
  int h, w, m;
  struct Row {
    bool ok;
    bool inside;
    T* dst;
  };
  __device__ __forceinline__ Row row(int r) const {
    return Row{true, PaddedRow(r, h, w).inside(h, w),
               hidden + static_cast<size_t>(r) * m};
  }
  __device__ __forceinline__ float value(const Row&, int col, float s) const {
    return gelu_tanh(__fadd_rn(s, bias[col]));
  }
  __device__ __forceinline__ void store(const Row& r, int col, uint4 v) const {
    *reinterpret_cast<uint4*>(r.dst + col) = r.inside ? v : make_uint4(0u, 0u, 0u, 0u);
  }
};

// Four float32 values stored as T: one 16-byte float4, or four bf16 rounded
// to nearest.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 o;
  o.x = *reinterpret_cast<const uint32_t*>(&lo);
  o.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = o;
}

// conv_out's epilogue: it stages acc + bo in float32, and stores T(t32 +
// (acc + bo)) for the rows inside their frame into out [n, h, w, c], reading
// t32 (dense [n*h*w, c]) beside it as 16-byte pieces.
template <typename T>
struct OutSlabEpilogue {
  using Out = float;
  const float* bias;
  const float* t32;
  T* out;
  int h, w, c;
  struct Row {
    bool ok;
    size_t base;
  };
  __device__ __forceinline__ Row row(int r) const {
    const PaddedRow p(r, h, w);
    if (!p.inside(h, w)) return Row{false, 0};
    return Row{true, p.pixel(h, w) * c};
  }
  __device__ __forceinline__ float value(const Row&, int col, float s) const {
    return __fadd_rn(s, bias[col]);
  }
  __device__ __forceinline__ void store(const Row& r, int col, uint4 v) const {
    const float4 t = *reinterpret_cast<const float4*>(t32 + r.base + col);
    const float y[4] = {__fadd_rn(t.x, __uint_as_float(v.x)),
                        __fadd_rn(t.y, __uint_as_float(v.y)),
                        __fadd_rn(t.z, __uint_as_float(v.z)),
                        __fadd_rn(t.w, __uint_as_float(v.w))};
    store4(out + r.base + col, y);
  }
};

template <typename Epi>
__global__ void __launch_bounds__(tg::kThreads, 1)
    conv3x3_bf16_tma(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap w_map, tg::Problem pb,
                     SlabLoader ld, Epi ep) {
  extern __shared__ __align__(16) int8_t smem_raw[];
  tg::gemm<tg::Bf16>(smem_raw, &a_map, &w_map, pb, ld, ep);
}

template <typename Epi>
__global__ void __launch_bounds__(tg::kThreads, 1)
    conv3x3_tf32x3_tma(const __grid_constant__ CUtensorMap a_map,
                       const __grid_constant__ CUtensorMap w_map, tg::Problem pb,
                       SlabLoader ld, Epi ep) {
  extern __shared__ __align__(16) int8_t smem_raw[];
  tg::gemm<tg::Tf32x3>(smem_raw, &a_map, &w_map, pb, ld, ep);
}

// One 3x3 convolution of padded frames a [rows, cin] (rows = n (h+2) (w+2))
// with the weights wt [cout, 3, 3, cin] (Tf32x3: split, [2 cout, 3, 3, cin]),
// in Op's operand type, as one GEMM over the padded raster on `kernel` (a
// __global__ that calls tg::gemm<Op>): K = 9 taps of whole tg::kBK-byte
// steps of channels (zeros past cin).
template <typename Op, typename Kernel, typename Epi>
cudaError_t conv3x3_slab(Kernel kernel, const void* a, const void* wt, int rows,
                         int cin, int cout, int w, const Epi& ep, cudaStream_t s) {
  CUtensorMap a_map, w_map;
  const uint64_t row_bytes = static_cast<uint64_t>(cin) * Op::kElem;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(cin), static_cast<uint64_t>(rows)};
  const uint64_t a_strides[1] = {row_bytes};
  cudaError_t err = tg::make_map(&a_map, Op::kType, Op::kElem, 2, a, a_dims, a_strides);
  if (err != cudaSuccess) return err;
  const uint64_t w_rows =
      static_cast<uint64_t>(cout) * (std::is_same<Op, tg::Tf32x3>::value ? 2 : 1);
  const uint64_t w_dims[3] = {static_cast<uint64_t>(cin), 9, w_rows};
  const uint64_t w_strides[2] = {row_bytes, 9 * row_bytes};
  err = tg::make_map(&w_map, Op::kType, Op::kElem, 3, wt, w_dims, w_strides);
  if (err != cudaSuccess) return err;
  const int per_tap = static_cast<int>((row_bytes + tg::kBK - 1) / tg::kBK);
  const tg::Problem pb = tg::problem<Op>(rows, cout, 9LL * per_tap * tg::kBK);
  const SlabLoader ld{per_tap, w + 2, tg::kBK / Op::kElem};
  return tg::launch(kernel, pb, s, a_map, w_map, pb, ld, ep);
}

// One of K6f's products in the model dtype T: bf16 on tg::Bf16, float32 on
// tg::Tf32x3 (wt split).
template <typename T, typename Epi>
cudaError_t fp_conv(const void* a, const void* wt, int rows, int cin, int cout, int w,
                    const Epi& ep, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    return conv3x3_slab<tg::Tf32x3>(conv3x3_tf32x3_tma<Epi>, a, wt, rows, cin, cout, w,
                                    ep, s);
  } else {
    return conv3x3_slab<tg::Bf16>(conv3x3_bf16_tma<Epi>, a, wt, rows, cin, cout, w, ep,
                                  s);
  }
}

// ------------------------------------------------- K6 on the q8 tile loop

// conv_up: 64 output pixels per CTA, the patch resident, all M columns in
// steps of kUpCols = 128, alternate steps to each warpgroup (m64n128), whose
// weights stream through a ring of its own, kUpStages stages of one panel
// [128 rows][64 bytes]. conv_out: 128 x 128 tiles (two warpgroups of
// m64n128), both operands through kOutStages stages of one A and one B
// panel. fused_extra_convs.q8_launch_plan mirrors these numbers.
constexpr int kUpRows = 64, kUpCols = 128, kUpStages = 5;
constexpr int kOutRows = 128, kOutCols = 128, kOutStages = 6;

// Dynamic shared memory of each, with the slack of q8::aligned_smem:
// conv_up's patch panels, ring, patch scales, the two warpgroups' amax
// partials and pixel coordinates; conv_out's ring and pixel coordinates.
size_t up_smem_bytes(int c) {
  const size_t panels = (9 * static_cast<size_t>(c) + q8::kPanel - 1) / q8::kPanel;
  return q8::kSmemAlign + panels * kUpRows * q8::kPanel +
         2 * kUpStages * kUpCols * q8::kPanel + kUpRows * sizeof(float) * (1 + 2) +
         kUpRows * sizeof(int) * 2;
}
size_t out_smem_bytes() {
  return q8::kSmemAlign + kOutStages * (kOutRows + kOutCols) * q8::kPanel +
         kOutRows * sizeof(int) * 2;
}

struct UpParams {
  const float* t32;   // [P, c]
  const float* cs;    // [P] patch scales
  const int8_t* wuq;  // [m, 9c]
  const float* su;    // [m]
  const float* bu;    // [m]
  int8_t* hq;         // [P, m]
  float* hs;          // [P]
  float* hidden;      // [P, m] float32, or null (the main path)
  int n, h, w, c, m;
};

// (c) conv_up, quantizing each patch value once and the hidden on chip. The
// two warpgroups share the patch and nothing else until the passes meet:
// warpgroup wg takes the 128-column steps s with s % 2 == wg, streams their
// weights through a ring of its own and waits on its own named barrier
// (1 + wg), and warpgroup 1 walks K from the middle, so that one's epilogue
// (GELU, division, stores) runs while the other loads and multiplies. They
// meet once, between the passes, to combine each row's amax (barriers 3, 4).
__global__ void __launch_bounds__(q8::kThreads, 1) k6_conv_up(UpParams p) {
  extern __shared__ __align__(16) int8_t smem_raw[];
  int8_t* smem = q8::aligned_smem(smem_raw);
  constexpr int S = kUpStages;
  constexpr int kWg = q8::kThreads / 2;                // threads of a warpgroup
  constexpr int kStage = kUpCols * q8::kPanel;         // bytes of a stage
  const int rows = p.n * p.h * p.w;
  const int K = 9 * p.c;
  const int kp = (K + q8::kPanel - 1) / q8::kPanel;    // panels of the patch
  int8_t* patch = smem;
  float* s_cs = reinterpret_cast<float*>(patch + kp * kUpRows * q8::kPanel +
                                         2 * S * kStage);
  float* s_part = s_cs + kUpRows;  // [2][kUpRows]
  int* s_y = reinterpret_cast<int*>(s_part + 2 * kUpRows);
  int* s_x = s_y + kUpRows;
  const int m0 = blockIdx.x * kUpRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wtid = tid & (kWg - 1);
  int8_t* ring = patch + kp * kUpRows * q8::kPanel + wg * S * kStage;
  const int steps = ((p.m + kUpCols - 1) / kUpCols + 1 - wg) / 2;  // this wg's
  const int koff = wg * (kp / 2);                       // its first K panel
  const int tiles = 2 * steps * kp;                     // both passes

  // Tile t: column step 2 * ((t / kp) % steps) + wg, K panel (t + koff) % kp.
  // Every call commits a group, empty past the end.
  auto issue = [&](int t) {
    if (t < tiles) {
      q8::copy_panels<kUpCols, 1, kWg>(
          ring + (t % S) * kStage, p.wuq, p.m, K,
          (2 * ((t / kp) % steps) + wg) * kUpCols,
          ((t + koff) % kp) * q8::kPanel, wtid);
    }
    q8::cp_async_commit();
  };
  for (int t = 0; t < S - 2; ++t) issue(t);

  tile_rows(s_y, s_x, m0, kUpRows, rows, p.h, p.w);
  for (int r = tid; r < kUpRows; r += q8::kThreads) {
    s_cs[r] = m0 + r < rows ? p.cs[m0 + r] : 1.f;
  }
  __syncthreads();

  // The patch: 16 values (one unit) per step, each divided once by its
  // row's patch scale. Neighbouring threads read neighbouring 64 bytes of
  // a shifted pixel's t32 row.
  const int units = kp * 4;
#pragma unroll 4
  for (int idx = tid; idx < kUpRows * units; idx += q8::kThreads) {
    const int r = idx / units, u = idx - r * units;
    const long long src = a_source(s_y, s_x, m0, r, u * 16, K, p.c, p.h, p.w);
    uint32_t words[4] = {0u, 0u, 0u, 0u};
    if (src >= 0) {
      const float s = s_cs[r];
      const float4* v = reinterpret_cast<const float4*>(p.t32 + src);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 f = v[j];
        words[j] = pack4(q8::quantize_div(f.x, s), q8::quantize_div(f.y, s),
                         q8::quantize_div(f.z, s), q8::quantize_div(f.w, s));
      }
    }
    *reinterpret_cast<uint4*>(patch + (u >> 2) * kUpRows * q8::kPanel +
                              q8::panel_offset(r, u & 3)) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
  q8::fence_proxy_async();
  __syncthreads();

  // This thread holds rows r0 and r0 + 8 of the block.
  const int r0 = (warp & 3) * 16 + (lane >> 2), tq = lane & 3;
  int acc[kUpCols / 2];
  float amax[2] = {0.f, 0.f};
  int t = 0;

  // One code site for both passes' epilogue (the loops are not unrolled),
  // so the value a pass-2 quantizer sees is the one pass 1 took the amax of.
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      // Each warpgroup's row amax, shared: arrive with ours, wait for theirs.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float a = amax[half];
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
        if (tq == 0) s_part[wg * kUpRows + r0 + half * 8] = a;
      }
      q8::bar_arrive(3 + wg, q8::kThreads);
      q8::bar_sync(4 - wg, q8::kThreads);
    }
#pragma unroll 1
    for (int step = 0; step < steps; ++step) {
#pragma unroll 1
      for (int kk = 0; kk < kp; ++kk, ++t) {
        q8::ring_wait<S>(1 + wg, kWg);
        issue(t + S - 2);
        q8::fence_regs<kUpCols / 2>(acc);
        q8::wgmma_fence();
        q8::wg_panel<kUpCols>(acc, patch + ((kk + koff) % kp) * kUpRows * q8::kPanel,
                              ring + (t % S) * kStage, kk != 0);
        q8::wgmma_commit();
        q8::wgmma_wait<1>();
      }
      q8::wgmma_wait<0>();
      q8::fence_regs<kUpCols / 2>(acc);

      const int col0 = (2 * step + wg) * kUpCols;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + half * 8;
        const int row = m0 + r;
        const float rs = s_cs[r];
        float hs = 0.f;
        if (pass == 1) {
          hs = q8::scale_div(fmaxf(s_part[r], s_part[kUpRows + r]));
          if (step == 0 && wg == 0 && tq == 0 && row < rows) p.hs[row] = hs;
        }
#pragma unroll
        for (int j = 0; j < kUpCols / 8; ++j) {
          const int col = col0 + j * 8 + tq * 2;
          if (row >= rows || col >= p.m) continue;  // m % 64 == 0: pairs whole
          float hv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + e]),
                          __fmul_rn(rs, p.su[col + e])),
                p.bu[col + e]);
            hv[e] = q8::gelu_rn(v);
          }
          const size_t o = static_cast<size_t>(row) * p.m + col;
          if (pass == 0) {
            amax[half] = fmaxf(amax[half], fmaxf(fabsf(hv[0]), fabsf(hv[1])));
          } else {
            *reinterpret_cast<uint16_t*>(p.hq + o) =
                q8::pack2(q8::quantize_div(hv[0], hs), q8::quantize_div(hv[1], hs));
            if (p.hidden != nullptr) {
              *reinterpret_cast<float2*>(p.hidden + o) = make_float2(hv[0], hv[1]);
            }
          }
        }
      }
    }
  }
}

struct OutParams {
  const int8_t* hq;   // [P, m]
  const float* hs;    // [P]
  const int8_t* woq;  // [c, 9m]
  const float* so;    // [c]
  const float* bo;    // [c]
  const float* t32;   // [P, c]
  void* out;          // [P, c] in the model dtype
  int n, h, w, c, m;
};

// (d) conv_out with per-tap dequantization (m % 64 == 0: a panel of K lies
// within one tap).
template <typename T>
__global__ void __launch_bounds__(q8::kThreads, 1) k6_conv_out(OutParams p) {
  extern __shared__ __align__(16) int8_t smem_raw[];
  int8_t* smem = q8::aligned_smem(smem_raw);
  constexpr int S = kOutStages;
  constexpr int kStage = (kOutRows + kOutCols) * q8::kPanel;
  const int hw = p.h * p.w;
  const int rows = p.n * hw;
  const int K = 9 * p.m;
  const int kp = K / q8::kPanel;
  const int per_tap = p.m / q8::kPanel;
  const int ncol = (p.c + kOutCols - 1) / kOutCols;
  const int m0 = (blockIdx.x / ncol) * kOutRows;
  const int n0 = (blockIdx.x % ncol) * kOutCols;
  const int tid = threadIdx.x;
  int* s_y = reinterpret_cast<int*>(smem + S * kStage);
  int* s_x = s_y + kOutRows;
  tile_rows(s_y, s_x, m0, kOutRows, rows, p.h, p.w);
  __syncthreads();

  // Tile t: K panel t of the shifted pixels' int8 hidden (A) and of the
  // weights (B).
  auto issue = [&](int t) {
    if (t < kp) {
      int8_t* a_dst = smem + (t % S) * kStage;
      constexpr int kPieces = kOutRows * 4 / q8::kThreads;
#pragma unroll
      for (int i = 0; i < kPieces; ++i) {
        const int piece = tid + i * q8::kThreads;
        const int r = piece >> 2, u = piece & 3;
        const long long src =
            a_source(s_y, s_x, m0, r, t * q8::kPanel + u * 16, K, p.m, p.h, p.w);
        q8::cp_async16(a_dst + q8::panel_offset(r, u), src >= 0 ? p.hq + src : p.hq,
                       src >= 0);
      }
      q8::copy_panels<kOutCols, 1>(a_dst + kOutRows * q8::kPanel, p.woq, p.c, K,
                                   n0, t * q8::kPanel);
    }
    q8::cp_async_commit();
  };
  for (int t = 0; t < S - 2; ++t) issue(t);

  // Warpgroup wg takes rows wg*64 .. +63 of the tile; its thread holds rows
  // r0 and r0 + 8 of those, columns 8 j + 2 tq + e.
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2), tq = lane & 3;
  float cscale[kOutCols / 8][2];
#pragma unroll
  for (int j = 0; j < kOutCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + j * 8 + tq * 2 + e;
      cscale[j][e] = col < p.c ? p.so[col] : 0.f;
    }
  int acc[kOutCols / 2];
  float facc[kOutCols / 2];
#pragma unroll
  for (int i = 0; i < kOutCols / 2; ++i) facc[i] = 0.f;

#pragma unroll 1
  for (int t = 0; t < kp; ++t) {
    q8::ring_wait<S>();
    issue(t + S - 2);
    const int8_t* stage = smem + (t % S) * kStage;
    q8::fence_regs<kOutCols / 2>(acc);
    q8::wgmma_fence();
    q8::wg_panel<kOutCols>(acc, stage + wg * 64 * q8::kPanel,
                           stage + kOutRows * q8::kPanel, t % per_tap != 0);
    q8::wgmma_commit();
    if ((t + 1) % per_tap != 0) {
      q8::wgmma_wait<1>();
      continue;
    }
    q8::wgmma_wait<0>();
    q8::fence_regs<kOutCols / 2>(acc);
    // The tap's int32 partial, scaled by the scale of the pixel it read,
    // joins the float32 sum (the next tap's first wgmma starts from zero).
    const int tap = t / per_tap;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
      const int y = s_y[r] + dy, x = s_x[r] + dx;
      const float vs = (y >= 0 && y < p.h && x >= 0 && x < p.w)
                           ? p.hs[m0 + r + dy * p.w + dx]
                           : 0.f;
#pragma unroll
      for (int j = 0; j < kOutCols / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * half + e;
          const float part = __int2float_rn(acc[idx]);
          facc[idx] = __fadd_rn(facc[idx], __fmul_rn(part, __fmul_rn(vs, cscale[j][e])));
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + r0 + half * 8;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < kOutCols / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + tq * 2 + e;
        if (col >= p.c) continue;
        const size_t o = static_cast<size_t>(row) * p.c + col;
        const float y = __fadd_rn(facc[4 * j + 2 * half + e], p.bo[col]);
        static_cast<T*>(p.out)[o] = from_f<T>(__fadd_rn(p.t32[o], y));
      }
    }
  }
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
  const long long rows = static_cast<long long>(n) * (h + 2) * (w + 2);
  if (rows + tg::kBM + w + 3 > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(int) * n, s);
  if (err != cudaSuccess) return err;
  dim3 amax_grid(grid_for(per_frame, kThreads * 16), n);
  frame_amax<T><<<amax_grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                               static_cast<int*>(amax), per_frame);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 q_grid(grid_for(rows / n * cin / 16, kThreads * 4), n);
  quantize_frames<T><<<q_grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(amax),
      static_cast<int8_t*>(xq), static_cast<float*>(xs), h, w, cin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const FrameEpilogue<T> ep{static_cast<const float*>(xs), static_cast<const float*>(ws),
                            static_cast<const float*>(bias), static_cast<T*>(out), h, w,
                            cout};
  return conv3x3_slab<tg::S8>(conv3x3_q8_tma<T>, xq, wq, static_cast<int>(rows), cin,
                              cout, w, ep, s);
}

// Raises the kernel's dynamic shared-memory limit to `bytes` where that is
// over the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_pixel(const void* x, const void* g, const void* bln, const void* wuq,
                 const void* su, const void* bu, const void* woq, const void* so,
                 const void* bo, void* t32, void* pixel_amax, void* cs,
                 void* hidden, void* hq, void* hs, void* out, int n, int h,
                 int w, int c, int m, cudaStream_t s) {
  const int rows = n * h * w;
  const int warp_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  ln_bias_rows<T><<<warp_blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(bln), static_cast<float*>(t32),
      static_cast<float*>(pixel_amax), rows, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  patch_scale<<<(rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(pixel_amax), static_cast<float*>(cs), rows, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t up_smem = up_smem_bytes(c);
  err = allow_smem(k6_conv_up, up_smem);
  if (err != cudaSuccess) return err;
  UpParams up{static_cast<const float*>(t32), static_cast<const float*>(cs),
              static_cast<const int8_t*>(wuq), static_cast<const float*>(su),
              static_cast<const float*>(bu), static_cast<int8_t*>(hq),
              static_cast<float*>(hs), static_cast<float*>(hidden), n, h, w, c, m};
  k6_conv_up<<<(rows + kUpRows - 1) / kUpRows, q8::kThreads, up_smem, s>>>(up);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t out_smem = out_smem_bytes();
  err = allow_smem(k6_conv_out<T>, out_smem);
  if (err != cudaSuccess) return err;
  OutParams down{static_cast<const int8_t*>(hq), static_cast<const float*>(hs),
                 static_cast<const int8_t*>(woq), static_cast<const float*>(so),
                 static_cast<const float*>(bo), static_cast<const float*>(t32),
                 out, n, h, w, c, m};
  const long long blocks = static_cast<long long>((rows + kOutRows - 1) / kOutRows) *
                           ((c + kOutCols - 1) / kOutCols);
  k6_conv_out<T><<<static_cast<unsigned>(blocks), q8::kThreads, out_smem, s>>>(down);
  return cudaGetLastError();
}

// K6f: LN into the padded slab t, then conv_up into the padded hidden slab
// and conv_out into out, each one GEMM on tma_gemm.cuh; in float32 each
// conv's weights are first split into their TF32 parts in wsplit.
template <typename T>
int launch_fp(const void* x, const void* g, const void* bln, const void* wu,
              const void* bu, const void* wo, const void* bo, void* t32, void* t,
              void* hidden, void* wsplit, void* out, int n, int h, int w, int c,
              int m, cudaStream_t s) {
  const long long rows = static_cast<long long>(n) * (h + 2) * (w + 2);
  if (rows + tg::kBM + w + 3 > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int padded = static_cast<int>(rows);
  const void* wu_op = wu;
  const void* wo_op = wo;
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    // [2, m, 9, c] for conv_up, then [2, c, 9, m] for conv_out.
    const long long count = 9LL * m * c;
    float* split = static_cast<float*>(wsplit);
    err = tg::split_weights(static_cast<const float*>(wu), split, count, s);
    if (err != cudaSuccess) return err;
    err = tg::split_weights(static_cast<const float*>(wo), split + 2 * count, count, s);
    if (err != cudaSuccess) return err;
    wu_op = split;
    wo_op = split + 2 * count;
  }
  ln_bias_slab<T><<<(padded + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const float*>(bln), static_cast<float*>(t32), static_cast<T*>(t),
      padded, h, w, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const UpSlabEpilogue<T> up{static_cast<const float*>(bu), static_cast<T*>(hidden), h,
                             w, m};
  err = fp_conv<T>(t, wu_op, padded, c, m, w, up, s);
  if (err != cudaSuccess) return err;
  const OutSlabEpilogue<T> down{static_cast<const float*>(bo),
                                static_cast<const float*>(t32), static_cast<T*>(out),
                                h, w, c};
  return fp_conv<T>(hidden, wo_op, padded, m, c, w, down, s);
}

}  // namespace

extern "C" {

// Per-frame int8 SAME 3x3 convolution. x [n, h, w, cin] (NHWC) in the model
// dtype (0: float32, 1: bfloat16); wq int8 [cout, 3, 3, cin] with float32
// scales ws [cout]; bias float32 [cout]; scratch amax int32 [n], xq int8
// [n, h+2, w+2, cin] (the padded frames), xs float32 [n]; out [n, h, w,
// cout] in the model dtype; every pointer 16-byte aligned. cin and cout
// multiples of 16. gemm_smem: the GEMM's dynamic shared memory as the
// caller's launch plan gives it; a plan that disagrees is refused. Returns
// the first failing cudaError_t.
int conv3x3_q8_frame_forward(const void* x, const void* wq, const void* ws,
                             const void* bias, void* amax, void* xq, void* xs,
                             void* out, int n, int h, int w, int cin, int cout,
                             int gemm_smem, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin % 16 != 0 ||
      cout % 16 != 0 || gemm_smem != tg::kSmemBytes) {
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
// scratch t32 float32 [rows, c], pixel_amax and cs float32 [rows], hq int8
// [rows, m], hs float32 [rows] (rows = n*h*w); hidden: null, or float32
// [rows, m] to receive the hidden that conv_up quantizes; out [n, h, w, c]
// in the model dtype. c % 16 == 0, m % 64 == 0. up_smem and out_smem: the
// dynamic shared memory of conv_up and conv_out as the caller's launch plan
// gives it; a plan that disagrees with the kernels' is refused.
int extra_convs_q8_pixel_forward(const void* x, const void* g, const void* bln,
                                 const void* wuq, const void* su, const void* bu,
                                 const void* woq, const void* so, const void* bo,
                                 void* t32, void* pixel_amax, void* cs,
                                 void* hidden, void* hq, void* hs, void* out,
                                 int n, int h, int w, int c, int m, int up_smem,
                                 int out_smem, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || m <= 0 || c % 16 != 0 ||
      m % q8::kPanel != 0 || static_cast<size_t>(up_smem) != up_smem_bytes(c) ||
      static_cast<size_t>(out_smem) != out_smem_bytes()) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_pixel<float>(x, g, bln, wuq, su, bu, woq, so, bo, t32,
                               pixel_amax, cs, hidden, hq, hs, out, n, h, w, c,
                               m, s);
  }
  if (dtype == 1) {
    return launch_pixel<bf16>(x, g, bln, wuq, su, bu, woq, so, bo, t32,
                              pixel_amax, cs, hidden, hq, hs, out, n, h, w, c,
                              m, s);
  }
  return cudaErrorInvalidValue;
}

// K6f: one ExtraConvs layer in full precision. x [n, h, w, c] (NHWC) in the
// model dtype (0: float32, 1: bfloat16); g, bln [c], bu [m], bo [c] float32;
// wu [m, 3, 3, c] and wo [c, 3, 3, m] in the model dtype (OHWI); scratch t32
// float32 [n*h*w, c], t [n, h+2, w+2, c] and hidden [n, h+2, w+2, m] in the
// model dtype (the padded slabs), and for float32 wsplit [4 * 9 * m * c]
// (the weights' TF32 parts; null for bf16); out [n, h, w, c] in the model
// dtype; every pointer 16-byte aligned. c and m multiples of 16. gemm_smem:
// the GEMMs' dynamic shared memory as the caller's launch plan gives it
// (tg::kSmemBytes); a plan that disagrees is refused.
int extra_convs_fp_forward(const void* x, const void* g, const void* bln,
                           const void* wu, const void* bu, const void* wo,
                           const void* bo, void* t32, void* t, void* hidden,
                           void* wsplit, void* out, int n, int h, int w, int c,
                           int m, int gemm_smem, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || m <= 0 || c % 16 != 0 ||
      m % 16 != 0 || gemm_smem != tg::kSmemBytes || (dtype == 0 && wsplit == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_fp<float>(x, g, bln, wu, bu, wo, bo, t32, t, hidden, wsplit, out, n,
                            h, w, c, m, s);
  }
  if (dtype == 1) {
    return launch_fp<bf16>(x, g, bln, wu, bu, wo, bo, t32, t, hidden, nullptr, out, n,
                           h, w, c, m, s);
  }
  return cudaErrorInvalidValue;
}

const char* tapnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

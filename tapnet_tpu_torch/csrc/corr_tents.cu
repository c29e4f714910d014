// Local correlation + bilinear-tent patches, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tapnet_tpu/ops/corr_tents.py::_kernel
// (launched by _pallas_forward), full-precision path (fp32 and bf16).
//
// What it computes, for every frame bt and query n: the p x p patch
//   out[bt, i, j, n] = sum_{y, x} wy_i(y) * wx_j(x) * corr(y, x),
//   corr(y, x) = <grid[bt, y, x, :], query[bt, n, :]>  (zero outside the grid)
// with separable tents w_d(i) = relu(1 - |c + d - half - i|) around the
// centre (cy, cx) in grid index space.
//
// Design. The TPU kernel computes the whole [H, W, N] correlation of a frame
// on the MXU and collapses it with tent matmuls, because a TPU gathers
// badly. The patch is linear in the correlation and every one of the p*p taps
// shares the same fractional offset, so a patch needs the correlation only on
// the (p+1) x (p+1) integer window around the centre. This kernel computes
// just those 64 dot products per query (float32 accumulation, shuffle
// reductions), rounds them to the compute dtype as the TPU kernel does, and
// mixes them with the tents: y-tents in the compute dtype, x-tents and all
// sums in float32. It reads the window rows the queries touch, never the
// whole frame. The grid is [query blocks, frames], so that the blocks at work
// at one time cover a few frames, whose window rows stay in L2 (with the
// frames fastest, as both kernels' grids had them before, every frame of
// the video was in flight at once). A block of 8 warps takes 8 queries of a
// frame, one warp each, or 4, 2 or 1 queries whose 2, 4 or 8 warps split
// the window's 8 rows (corr_tents.float_launch_plan chooses): where 8 would
// give the card fewer than 528 blocks (an online step, 1 frame x 64
// queries: 64 blocks in place of 8, 512 warps busy instead of 64), or where
// the frames under way would hold more than 32 MB of grid (the served
// 120x120 and 60x60 grids). Outputs are staged in shared memory and written
// as [p*p, queries] rows (32-byte sectors for 8).
// Two inner loops, chosen by C and alignment (float_rows_ok):
//   * row-wise, where C * sizeof(T) is a power-of-two number L >= 4 of
//     16-byte pieces (L <= 128) and both bases are 16-byte aligned: the
//     model's widths (C = 128 and 256 in either dtype) and the test
//     configurations' 32 (and 16 in float32). A window row is (p+1) * C
//     contiguous values (2 KB at the hires level in bf16, 8 KB at C = 256
//     in fp32); the warp reads it 16 bytes a lane, min(L, 32) lanes a
//     position (L / 32 pieces a lane beyond), all of a lane's loads of a row
//     at once, with the query's pieces in registers, and reduces the row's 8
//     positions together by a transposing butterfly: 8x fewer load
//     instructions than value by value, one memory latency a row instead of
//     one a position, and V + 1 shuffles instead of 5 a position.
//   * scalar, for every other C (L no power of two: 40, 48, 80 ...; L < 4:
//     bf16 C = 16) or a base off 16 bytes: lanes split C value by value,
//     the query in shared memory, and every position is reduced over the
//     whole warp.
//
// The int8 kernel (corr_tents_q8_kernel) replaces the same TPU kernel on its
// int8 paths: `frame_scale` given (K2: grid quantized once per video, one
// scale per frame) and `quantized=True` (K2b, _kernel_quantized: one grid
// scale per position). Same design as the float kernel: the grid is [query
// blocks, frames] and a block takes 8, 4, 2 or 1 queries of a frame
// (corr_tents.q8_launch_plan: at least 528 blocks, at most 32 MB of int8
// grid in flight). The dot over C is __dp4a with an int accumulator, which
// is exact. The query arrives in the compute dtype and each warp quantizes
// its own in the prologue with q8::scale_div and q8::quantize_div, as
// quantize_rows does: the int8 values and the scale are bit-equal to
// _quantize_lastdim's, and no launch, int8 copy or scale product sits
// between the model and the kernel. In per-frame mode the kernel forms the
// output scale qs * fs itself. Two inner loops, chosen by the width C:
//   * row-wise, for the model's full widths (C = 16 * 2^k with 64 <= C <=
//     512 and both bases 16-byte aligned: 128 and 256 in BootsTAPIR). A
//     window row is 8 * C contiguous bytes; C / 16 lanes take a position, 16
//     bytes each, so a lane has C / 64 positions of a row (2 at C = 128, 4
//     at C = 256). It issues all its loads of a row before its first
//     __dp4a, a position off the grid from a clamped address under a zero
//     mask, and the next row's loads before this row's products; one
//     transposing butterfly reduces the row's 8 positions together, and
//     K2b loads the scale of the position a lane's sum ends on beside the
//     row. (The design before it put frames fastest in the grid, so every
//     frame of the video was in flight, and loaded one 16-byte chunk per
//     pass under a branch per position, then reduced that pass before the
//     next load: four dependent passes a row at C = 256.)
//   * word-wise, for every other C % 4 == 0: the narrow widths of the small
//     test configurations (16 and 32) and widths that are no power of two.
//     The warp quantizes its query into shared memory, C is split over the
//     32 lanes word by word, and every position is reduced over the whole
//     warp.
// Both give the same bits. The roundings after the dot are those of the
// einsum mirror of the TPU kernel: the int32 correlation goes to float32 (exact,
// below 2^24), is multiplied by the position's grid scale where there is one,
// and is rounded to bfloat16; tent weights are bfloat16 whatever the model's
// dtype; the y-stage is summed in float32 and rounded to bfloat16; the
// x-stage is summed in float32; the per-(frame, query) scale multiplies the
// float32 output. Products of two bfloat16 values are exact in float32 and
// each stage adds two of them, so every step is reproducible bit for bit.
// Bound: the grid's bytes at 1 byte per value (a quarter of the float32
// kernel's, half of the bfloat16 one's) against 2*64*C integer operations per
// query: memory, as below.
//
// Bound on the H100: memory. Per query it moves 64*C grid values against
// 2*64*C flops, far below the ~295 flop/byte the tensor cores need; the
// roofline time is the bytes of the grid positions the windows touch over
// 3.35 TB/s. A frame's window rows are shared between its queries and read
// again through L2 (32 KB a query at C = 256 in bf16), so the design keeps
// the frames under way within L2 and many 16-byte loads in flight: a row's
// loads are issued together, one memory latency a row. PERF.md section 6
// has what each kernel reaches.
//
// quantize_rows: the int8 modes' quantizer of the grid per position, which
// the JAX package leaves to XLA (tapnet_tpu/ops/corr_tents.py::
// _quantize_lastdim): for each row of [R, C] in float32 or bfloat16, s =
// max(amax |row|, 1e-8) * (1/127) and q = clip(rint(v / s), +-127) (IEEE
// division, round half to even), int8 [R, C] and float32 s [R], bit-equal
// to the port's plain _quantize_lastdim. A warp reads a contiguous run of
// rows in 16-byte pieces, 512 bytes an instruction and four pieces a lane in
// flight, and reduces each row's amax over the lanes that hold it: 8 rows a
// warp on the hires grid (bf16 C = 128), where one warp a row left half the
// warp idle; a row stays in registers between its amax and its quantizing
// pass. Bound: memory, each value read once and written once as int8 (at
// the served hires grid, [250 * 120 * 120, 128] bf16, 0.92 + 0.46 GB: 0.41
// ms at 3.35 TB/s). The per-position grid is quantized once per video
// (models/tapir.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "q8_tile.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Most queries a block takes: one per warp (the launch plans take 8, 4, 2
// or 1); a tile of 8 writes its output rows as 32-byte sectors.
constexpr int kTileN = kWarps;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float tent(float centre, int cell) {
  return fmaxf(0.f, 1.f - fabsf(centre - static_cast<float>(cell)));
}

// 16 bytes as 4 float32 or 8 bfloat16 values (the pointer type selects).
__device__ __forceinline__ void unpack_piece(const uint4& q, const float*, float* v) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack_piece(const uint4& q, const __nv_bfloat16*,
                                             float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
// 16 bytes a lane reads in one piece: 4 float32 or 8 bfloat16 values.
template <typename T>
__device__ __forceinline__ void load_piece(const T* p, float* v) {
  unpack_piece(*reinterpret_cast<const uint4*>(p), p, v);
}

// The row-wise loop reads a position's C values as L = C * sizeof(T) / 16
// pieces of 16 bytes, at most kMaxLanePieces of them a lane (L <= 128).
constexpr int kMaxLanePieces = 4;

// Whether the float kernel's row-wise loop takes width c of T at these
// bases: C * sizeof(T) a power-of-two number L of 16-byte pieces, 4 <= L <=
// 32 * kMaxLanePieces, and both bases 16-byte aligned.
template <typename T>
bool float_rows_ok(const void* grid, const void* query, int c) {
  const long long bytes = static_cast<long long>(c) * sizeof(T);
  const long long pieces = bytes / 16;
  return bytes % 16 == 0 && pieces >= 4 && pieces <= 32 * kMaxLanePieces &&
         (pieces & (pieces - 1)) == 0 &&
         reinterpret_cast<uintptr_t>(grid) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(query) % 16 == 0;
}

// grid [bt, h, w, c] and query [bt, n, c] in T; cy, cx [bt, n]; out [bt, P,
// P, n]. A block of kWarps warps takes `qpb` queries of one frame (1, 2, 4
// or 8), each with kWarps / qpb warps that split its window rows. LC > 0:
// the row-wise loop with LC = min(L, 32) lanes a position and PL = L / LC
// pieces of a position a lane (float_rows_ok); LC = 0: the scalar loop.
template <typename T, int P, int LC, int PL>
__global__ void __launch_bounds__(kThreads)
    corr_tents_kernel(const T* __restrict__ grid, const T* __restrict__ query,
                      const float* __restrict__ cy,
                      const float* __restrict__ cx, float* __restrict__ out,
                      int h, int w, int c, int n, int qpb) {
  constexpr int kWin = P + 1;
  constexpr int kHalf = (P - 1) / 2;
  constexpr int kVec = 16 / sizeof(T);  // values of a 16-byte piece
  __shared__ float corr_s[kTileN][kWin * kWin];
  __shared__ float out_s[P * P * kTileN];
  extern __shared__ float q_s[];  // scalar loop: [qpb, c]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wpq = kWarps / qpb;  // warps of a query
  const int qi = warp / wpq;
  const int bt = blockIdx.y;
  const int n0 = blockIdx.x * qpb;
  const int nq = n0 + qi;
  const T* g = grid + static_cast<size_t>(bt) * h * w * c;

  if (LC == 0) {
    for (int e = threadIdx.x; e < qpb * c; e += kThreads) {
      const int q = e / c;
      q_s[e] = n0 + q < n ? to_f(query[(static_cast<size_t>(bt) * n + n0 + q) * c + e % c])
                          : 0.f;
    }
    __syncthreads();
  }

  if (nq < n) {  // warp-uniform
    const size_t qoff = static_cast<size_t>(bt) * n + nq;
    const int y0 = static_cast<int>(floorf(cy[qoff])) - kHalf;
    const int x0 = static_cast<int>(floorf(cx[qoff])) - kHalf;
    float* corr = corr_s[qi];
    // Correlation on the integer window, rounded to the compute dtype; the
    // query's warps take its rows in turn. Positions outside the grid stay 0.
    if constexpr (LC > 0) {
      // A lane takes pieces kk + LC i (i < PL) of the row's positions s =
      // j * span + lane / LC, j < V. It issues all its V * PL loads of a row
      // before it uses any (a position off the grid loads the query's own
      // piece, a valid address, and counts 0), so a row costs one memory
      // latency, not one a position: the warp issues in order, and a load
      // under a branch per position would wait for the previous position's
      // sums. The query's pieces stay in registers. Then one transposing
      // reduction: at each xor offset from LC / 2 down to 4 a lane hands
      // half of its V sums to its partner and adds the other half, so after
      // offsets 2 and 1 lane l holds the sum of position ((l % LC) >> 2) *
      // span + l / LC: V + 1 shuffles a row, where a reduction per position
      // takes 5 each.
      constexpr int V = LC / 4;       // positions (partial sums) a lane
      constexpr int span = 32 / LC;   // positions side by side in a warp
      const int kk = lane % LC;
      const T* qrow = query + qoff * c;
      float qv[PL][kVec];
#pragma unroll
      for (int i = 0; i < PL; ++i) load_piece(qrow + (kk + LC * i) * kVec, qv[i]);
      for (int r = warp % wpq; r < kWin; r += wpq) {
        const int iy = y0 + r;
        const bool row_ok = iy >= 0 && iy < h;
        const T* row = g + (static_cast<ptrdiff_t>(iy) * w + x0) * c;
        uint4 raw[V][PL];
        bool ok[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int s = j * span + lane / LC;
          const int ix = x0 + s;
          ok[j] = row_ok && ix >= 0 && ix < w;
          const T* src = ok[j] ? row + s * c : qrow;
#pragma unroll
          for (int i = 0; i < PL; ++i) {
            raw[j][i] = *reinterpret_cast<const uint4*>(src + (kk + LC * i) * kVec);
          }
        }
        float acc[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < PL; ++i) {
            float v[kVec];
            unpack_piece(raw[j][i], static_cast<const T*>(nullptr), v);
#pragma unroll
            for (int e = 0; e < kVec; ++e) sum = fmaf(v[e], qv[i][e], sum);
          }
          acc[j] = ok[j] ? sum : 0.f;
        }
        int nv = V;
#pragma unroll
        for (int o = LC / 2; o >= 4; o >>= 1) {
          const bool upper = (lane & o) != 0;
          nv /= 2;
#pragma unroll
          for (int j = 0; j < V / 2; ++j) {
            if (j < nv) {
              const float lo = acc[j], hi = acc[j + nv];
              const float got = __shfl_xor_sync(0xffffffffu, upper ? lo : hi, o);
              acc[j] = (upper ? hi : lo) + got;
            }
          }
        }
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 2);
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
        if (lane % 4 == 0) {
          corr[r * kWin + ((lane % LC) >> 2) * span + lane / LC] = round_to<T>(acc[0]);
        }
      }
    } else {
      // Lanes split C value by value; each keeps one partial sum per
      // position of the row, reduced over the whole warp.
      const float* qv = q_s + qi * c;
      for (int r = warp % wpq; r < kWin; r += wpq) {
        const int iy = y0 + r;
        float acc[kWin];
#pragma unroll
        for (int s = 0; s < kWin; ++s) acc[s] = 0.f;
        if (iy >= 0 && iy < h) {  // warp-uniform
          const T* row = g + (static_cast<ptrdiff_t>(iy) * w + x0) * c;
          for (int k = lane; k < c; k += 32) {
            const float qk = qv[k];
#pragma unroll
            for (int s = 0; s < kWin; ++s) {
              const int ix = x0 + s;
              if (ix >= 0 && ix < w) acc[s] = fmaf(to_f(row[s * c + k]), qk, acc[s]);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < kWin; ++s) {
          const float v = warp_sum(acc[s]);
          if (lane == 0) corr[r * kWin + s] = round_to<T>(v);
        }
      }
    }
  }
  __syncthreads();

  // Tap (i, j) of a query is centred at (y + i - half, x + j - half); its
  // tents are non-zero only on window rows i, i+1 and columns j, j+1.
  for (int e = threadIdx.x; e < qpb * P * P; e += kThreads) {
    const int q = e / (P * P);
    const int tap = e % (P * P);
    if (n0 + q >= n) continue;
    const size_t qoff = static_cast<size_t>(bt) * n + n0 + q;
    const float y = cy[qoff];
    const float x = cx[qoff];
    const int y0 = static_cast<int>(floorf(y)) - kHalf;
    const int x0 = static_cast<int>(floorf(x)) - kHalf;
    const int i = tap / P;
    const int j = tap % P;
    const float cyi = y + static_cast<float>(i - kHalf);
    const float cxj = x + static_cast<float>(j - kHalf);
    const float wy0 = round_to<T>(tent(cyi, y0 + i));
    const float wy1 = round_to<T>(tent(cyi, y0 + i + 1));
    const float wx0 = tent(cxj, x0 + j);
    const float wx1 = tent(cxj, x0 + j + 1);
    const float* c0 = corr_s[q] + i * kWin + j;
    const float ya = wy0 * c0[0] + wy1 * c0[kWin];
    const float yb = wy0 * c0[1] + wy1 * c0[kWin + 1];
    out_s[tap * qpb + q] = wx0 * ya + wx1 * yb;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < P * P * qpb; e += kThreads) {
    const int tap = e / qpb;
    const int q = e % qpb;
    if (n0 + q < n) {
      out[(static_cast<size_t>(bt) * P * P + tap) * n + n0 + q] = out_s[e];
    }
  }
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four values quantized with scale s (q8::quantize_div, as _quantize_lastdim
// rounds them), packed little-endian into one word of int8.
__device__ __forceinline__ uint32_t pack4_q8(const float* v, float s) {
  uint32_t word = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    word |= (static_cast<uint32_t>(q8::quantize_div(v[e], s)) & 0xffu) << (8 * e);
  }
  return word;
}

// Widths of the int8 kernel's row-wise loop: C = 16 * 2^k from
// kQ8MinRowWidth to kQ8MaxRowWidth, C / 16 lanes (4 to 32) a position.
constexpr int kQ8MinRowWidth = 64;
constexpr int kQ8MaxRowWidth = 512;

bool q8_rows_ok(const void* grid, const void* query, int c) {
  return c % 16 == 0 && c >= kQ8MinRowWidth && c <= kQ8MaxRowWidth &&
         ((c / 16) & (c / 16 - 1)) == 0 &&
         reinterpret_cast<uintptr_t>(grid) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(query) % 16 == 0;
}

// The int8 row-wise loop's loads of window row iy: a lane's V = LC / 4
// chunks of 16 bytes (chunk kk = lane % LC of positions j * span + lane /
// LC), each from a clamped address (the frame's first position) with a
// clear bit in the returned mask where the position lies off the grid, so
// that no load waits behind a branch; and, for K2b, the grid scale of the
// position the lane's sum ends on (0 off the grid).
template <int LC>
__device__ __forceinline__ unsigned load_q8_row(const int8_t* g, const float* gs,
                                                int h, int w, int c, int iy,
                                                int x0, int lane, int4* raw,
                                                float* gsv) {
  constexpr int V = LC / 4;
  constexpr int span = 32 / LC;
  const int kk = lane % LC;
  const bool row_ok = iy >= 0 && iy < h;
  unsigned ok = 0u;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ix = x0 + j * span + lane / LC;
    const bool in = row_ok && ix >= 0 && ix < w;
    ok |= static_cast<unsigned>(in) << j;
    const ptrdiff_t pos = in ? static_cast<ptrdiff_t>(iy) * w + ix : 0;
    raw[j] = __ldg(reinterpret_cast<const int4*>(g + pos * c) + kk);
  }
  if (gs != nullptr) {
    const int ix = x0 + (kk >> 2) * span + lane / LC;
    const bool in = row_ok && ix >= 0 && ix < w;
    const float v = __ldg(gs + (in ? static_cast<ptrdiff_t>(iy) * w + ix : 0));
    *gsv = in ? v : 0.f;
  }
  return ok;
}

// The row's exact int32 correlations: a lane's V partial dot products
// (__dp4a over its 16-byte chunk), zero where the mask bit is clear, then
// one transposing butterfly over the row's 8 positions (as the float
// kernel's): at each xor offset from LC / 2 down to 4 a lane hands half of
// its sums to its partner and adds the other half; after offsets 2 and 1
// lane l holds the sum of position ((l % LC) >> 2) * span + l / LC.
template <int LC>
__device__ __forceinline__ int dot_q8_row(const int4* raw, unsigned ok,
                                          const int4& q, int lane) {
  constexpr int V = LC / 4;
  int acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    int a = __dp4a(raw[j].x, q.x, 0);
    a = __dp4a(raw[j].y, q.y, a);
    a = __dp4a(raw[j].z, q.z, a);
    a = __dp4a(raw[j].w, q.w, a);
    acc[j] = (ok >> j) & 1u ? a : 0;
  }
  int nv = V;
#pragma unroll
  for (int o = LC / 2; o >= 4; o >>= 1) {
    const bool upper = (lane & o) != 0;
    nv /= 2;
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      if (j < nv) {
        const int lo = acc[j], hi = acc[j + nv];
        const int got = __shfl_xor_sync(0xffffffffu, upper ? lo : hi, o);
        acc[j] = (upper ? hi : lo) + got;
      }
    }
  }
  acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 2);
  acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
  return acc[0];
}

// K2 and K2b. grid [bt, h, w, c] int8 (c % 4 == 0, 4-byte aligned); query
// [bt, n, c] in the compute dtype T; exactly one of pos_scale [bt, h, w]
// (K2b) and frame_scale [bt] (K2); cy, cx [bt, n]; out [bt, P, P, n]. A
// block of kWarps warps takes qpb queries (1, 2, 4 or 8) of frame
// blockIdx.y, each with kWarps / qpb warps that split its window rows
// (corr_tents.q8_launch_plan). Each warp first quantizes its query as
// _quantize_lastdim does (the same q8::scale_div and q8::quantize_div as
// quantize_rows), so the int8 values and the scale are bit-equal to the
// plain version's and the query makes no round trip through memory. LC > 0:
// the row-wise loop with LC = C / 16 lanes a position (q8_rows_ok); LC = 0:
// the word-wise loop.
template <typename T, int P, int LC>
__global__ void __launch_bounds__(kThreads)
    corr_tents_q8_kernel(const int8_t* __restrict__ grid,
                         const T* __restrict__ query,
                         const float* __restrict__ pos_scale,
                         const float* __restrict__ frame_scale,
                         const float* __restrict__ cy,
                         const float* __restrict__ cx, float* __restrict__ out,
                         int h, int w, int c, int n, int qpb) {
  constexpr int kWin = P + 1;
  constexpr int kHalf = (P - 1) / 2;
  __shared__ float corr_s[kTileN][kWin * kWin];
  __shared__ float out_s[P * P * kTileN];
  __shared__ float scale_s[kTileN];  // a query's output scale
  extern __shared__ int qw_s[];      // word-wise loop: [kWarps, c / 4] int8 words
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wpq = kWarps / qpb;  // warps of a query
  const int qi = warp / wpq;
  const int bt = blockIdx.y;
  const int n0 = blockIdx.x * qpb;
  const int nq = n0 + qi;
  const int8_t* g = grid + static_cast<size_t>(bt) * h * w * c;
  const float* gs =
      pos_scale ? pos_scale + static_cast<size_t>(bt) * h * w : nullptr;

  if (nq < n) {  // warp-uniform
    const size_t qoff = static_cast<size_t>(bt) * n + nq;
    const T* qrow = query + qoff * c;
    const int y0 = static_cast<int>(floorf(cy[qoff])) - kHalf;
    const int x0 = static_cast<int>(floorf(cx[qoff])) - kHalf;
    float* corr = corr_s[qi];
    float qscale;
    if constexpr (LC > 0) {
      // A lane's chunk kk of every position is query values [16 kk, 16 kk
      // + 16): it loads those in T with its first row, and the LC lanes of a
      // position, which hold the whole query, reduce its amax. Each row's
      // loads go out before the previous row's products (two rows in
      // registers), so a warp waits about one memory latency, not one a row.
      constexpr int V = LC / 4;
      constexpr int span = 32 / LC;
      constexpr int kVec = 16 / sizeof(T);
      const int kk = lane % LC;
      const int sf = (kk >> 2) * span + lane / LC;  // where the lane's sum ends
      float qv[16];
#pragma unroll
      for (int i = 0; i < 16 / kVec; ++i) load_piece(qrow + kk * 16 + i * kVec, qv + i * kVec);
      int4 raw[V], ahead[V];
      float gsv = 0.f, gs_next = 0.f;
      int r = warp % wpq;
      unsigned ok = load_q8_row<LC>(g, gs, h, w, c, y0 + r, x0, lane, raw, &gsv);
      float m = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) m = fmaxf(m, fabsf(qv[e]));
#pragma unroll
      for (int o = LC / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      qscale = q8::scale_div(m);
      const int4 q = make_int4(
          static_cast<int>(pack4_q8(qv, qscale)), static_cast<int>(pack4_q8(qv + 4, qscale)),
          static_cast<int>(pack4_q8(qv + 8, qscale)), static_cast<int>(pack4_q8(qv + 12, qscale)));
      for (; r < kWin; r += wpq) {
        unsigned ok_next = 0u;
        if (r + wpq < kWin) {  // warp-uniform
          ok_next = load_q8_row<LC>(g, gs, h, w, c, y0 + r + wpq, x0, lane, ahead, &gs_next);
        }
        const int sum = dot_q8_row<LC>(raw, ok, q, lane);
        if (lane % 4 == 0) {
          float f = static_cast<float>(sum);  // exact: |sum| < 2^24
          if (gs != nullptr) f = __fmul_rn(f, gsv);
          corr[r * kWin + sf] = round_bf16(f);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) raw[j] = ahead[j];
        ok = ok_next;
        gsv = gs_next;
      }
    } else {
      // Word-wise: the warp quantizes its query into shared memory, then
      // lanes split C word by word and every position is reduced over the
      // whole warp.
      const int c4 = c / 4;
      int* qw = qw_s + warp * c4;
      float m = 0.f;
      for (int k = lane; k < c; k += 32) m = fmaxf(m, fabsf(to_f(qrow[k])));
      qscale = q8::scale_div(warp_max(m));
      for (int k = lane; k < c4; k += 32) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = to_f(qrow[4 * k + e]);
        qw[k] = static_cast<int>(pack4_q8(v, qscale));
      }
      __syncwarp();
      const int* g4 = reinterpret_cast<const int*>(g);
      for (int r = warp % wpq; r < kWin; r += wpq) {
        const int iy = y0 + r;
        const bool row_ok = iy >= 0 && iy < h;  // warp-uniform
        int acc[kWin];
#pragma unroll
        for (int s = 0; s < kWin; ++s) acc[s] = 0;
        if (row_ok) {
          const int* row = g4 + (static_cast<ptrdiff_t>(iy) * w + x0) * c4;
          for (int k = lane; k < c4; k += 32) {
            const int qk = qw[k];
#pragma unroll
            for (int s = 0; s < kWin; ++s) {
              const int ix = x0 + s;
              if (ix >= 0 && ix < w) acc[s] = __dp4a(row[s * c4 + k], qk, acc[s]);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < kWin; ++s) {
          const int v = warp_sum_int(acc[s]);
          if (lane == 0) {
            float f = static_cast<float>(v);
            const int ix = x0 + s;
            if (gs != nullptr && row_ok && ix >= 0 && ix < w) {
              f = __fmul_rn(f, gs[iy * w + ix]);
            }
            corr[r * kWin + s] = round_bf16(f);
          }
        }
      }
    }
    if (warp % wpq == 0 && lane == 0) {
      scale_s[qi] = frame_scale != nullptr ? __fmul_rn(qscale, frame_scale[bt]) : qscale;
    }
  }
  __syncthreads();

  // Tap (i, j) of a query is centred at (y + i - half, x + j - half); its
  // tents are non-zero only on window rows i, i+1 and columns j, j+1.
  for (int e = threadIdx.x; e < qpb * P * P; e += kThreads) {
    const int q = e / (P * P);
    const int tap = e % (P * P);
    if (n0 + q >= n) continue;
    const size_t qoff = static_cast<size_t>(bt) * n + n0 + q;
    const float y = cy[qoff];
    const float x = cx[qoff];
    const int y0 = static_cast<int>(floorf(y)) - kHalf;
    const int x0 = static_cast<int>(floorf(x)) - kHalf;
    const int i = tap / P;
    const int j = tap % P;
    const float cyi = y + static_cast<float>(i - kHalf);
    const float cxj = x + static_cast<float>(j - kHalf);
    const float wy0 = round_bf16(tent(cyi, y0 + i));
    const float wy1 = round_bf16(tent(cyi, y0 + i + 1));
    const float wx0 = round_bf16(tent(cxj, x0 + j));
    const float wx1 = round_bf16(tent(cxj, x0 + j + 1));
    const float* c0 = corr_s[q] + i * kWin + j;
    const float ya = round_bf16(wy0 * c0[0] + wy1 * c0[kWin]);
    const float yb = round_bf16(wy0 * c0[1] + wy1 * c0[kWin + 1]);
    out_s[tap * qpb + q] = __fmul_rn(wx0 * ya + wx1 * yb, scale_s[q]);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < P * P * qpb; e += kThreads) {
    const int tap = e / qpb;
    const int q = e % qpb;
    if (n0 + q < n) {
      out[(static_cast<size_t>(bt) * P * P + tap) * n + n0 + q] = out_s[e];
    }
  }
}

// quantize_rows on 16-byte pieces. A row is P = C * sizeof(T) / 16 pieces,
// P a power of two; a warp takes a contiguous run of K * 32 pieces and reads
// it in K steps, lane l taking piece 32 k + l at step k, so every load
// instruction reads 512 contiguous bytes and a lane has K pieces (64 bytes
// at K = 4) in flight. Where P <= 32 a step holds 32 / P whole rows (the
// hires grid, bf16 C = 128: 2 rows a step, 8 a warp), and a row's amax is a
// segmented shuffle over its P lanes; where P > 32 a row spans P / 32 steps
// and its amax is a shuffle over the warp. A row's pieces stay in registers
// from the amax to the quantizing pass (each value is read once), and each
// step stores a piece's int8 values (8 bytes bf16, 4 float32), consecutive
// lanes on consecutive bytes. (One warp a row, the design before it, left
// half the warp idle on the hires grid.)
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    corr_quantize_rows(const T* __restrict__ v, int8_t* __restrict__ q,
                       float* __restrict__ scale, long long rows, int pieces) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) * K * 32 + lane;
  const long long total = rows * pieces;
  const int shift = __ffs(pieces) - 1;  // log2(pieces), no 64-bit division
  uint4 raw[K];
  float m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long p = first + 32 * k;
    raw[k] = p < total ? __ldg(reinterpret_cast<const uint4*>(v) + p)
                       : make_uint4(0u, 0u, 0u, 0u);
    float f[kVec];
    unpack_piece(raw[k], static_cast<const T*>(nullptr), f);
    m[k] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) m[k] = fmaxf(m[k], fabsf(f[e]));
  }
  if (pieces >= 32) {  // a row spans pieces / 32 whole steps
    const int steps = pieces / 32;
    for (int k0 = 0; k0 < K; k0 += steps) {
      float mm = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k >= k0 && k < k0 + steps) mm = fmaxf(mm, m[k]);
      }
      mm = warp_max(mm);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k >= k0 && k < k0 + steps) m[k] = mm;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      for (int o = pieces / 2; o > 0; o >>= 1) {
        m[k] = fmaxf(m[k], __shfl_xor_sync(0xffffffffu, m[k], o));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long p = first + 32 * k;
    if (p >= total) continue;
    const float s = q8::scale_div(m[k]);
    if ((p & (pieces - 1)) == 0) scale[p >> shift] = s;  // a row's first piece
    float f[kVec];
    unpack_piece(raw[k], static_cast<const T*>(nullptr), f);
    if constexpr (kVec == 8) {
      reinterpret_cast<uint2*>(q)[p] = make_uint2(pack4_q8(f, s), pack4_q8(f + 4, s));
    } else {
      reinterpret_cast<uint32_t*>(q)[p] = pack4_q8(f, s);
    }
  }
}

// quantize_rows for any other width or base: one warp per row, one value a
// lane at a time, two passes over the row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    corr_quantize_rows_scalar(const T* __restrict__ v, int8_t* __restrict__ q,
                              float* __restrict__ scale, long long rows, int c) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // warp-uniform
  const T* src = v + row * c;
  float m = 0.f;
  for (int k = lane; k < c; k += 32) m = fmaxf(m, fabsf(to_f(src[k])));
  const float s = q8::scale_div(warp_max(m));
  if (lane == 0) scale[row] = s;
  for (int k = lane; k < c; k += 32) {
    q[row * c + k] = static_cast<int8_t>(q8::quantize_div(to_f(src[k]), s));
  }
}

// Pieces of a row that corr_quantize_rows takes (a power of two up to
// 32 * kQuantizeSteps: bf16 C <= 2048, float32 C <= 1024); its steps a warp.
constexpr int kQuantizeSteps = 8;

template <typename T>
int launch_quantize(const void* v, void* q, void* scale, long long rows, int c,
                    cudaStream_t stream) {
  const long long bytes = static_cast<long long>(c) * sizeof(T);
  const long long pieces = bytes / 16;
  const bool fits = bytes % 16 == 0 && pieces <= 32 * kQuantizeSteps &&
                    (pieces & (pieces - 1)) == 0 &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (!fits) {
    const long long blocks = (rows + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    corr_quantize_rows_scalar<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(v), static_cast<int8_t*>(q), static_cast<float*>(scale),
        rows, c);
    return cudaGetLastError();
  }
  // 4 steps a warp (64 bytes a lane in flight), 8 where a row spans more.
  const int steps = pieces > 128 ? kQuantizeSteps : 4;
  const long long per_block = static_cast<long long>(kWarps) * steps * 32;
  const long long blocks = (rows * pieces + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = steps == 4 ? corr_quantize_rows<T, 4> : corr_quantize_rows<T, kQuantizeSteps>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(v), static_cast<int8_t*>(q), static_cast<float*>(scale),
      rows, static_cast<int>(pieces));
  return cudaGetLastError();
}

template <typename T>
int launch_q8(const void* grid, const void* query, const void* pos_scale,
              const void* frame_scale, const void* cy, const void* cx, void* out,
              int bt, int h, int w, int c, int n, int qpb, int rows,
              cudaStream_t stream) {
  constexpr int P = 7;
  if (rows != static_cast<int>(q8_rows_ok(grid, query, c))) {
    return cudaErrorInvalidValue;
  }
  const int lanes = rows ? c / 16 : 0;
  auto kernel = lanes == 4    ? corr_tents_q8_kernel<T, P, 4>
                : lanes == 8  ? corr_tents_q8_kernel<T, P, 8>
                : lanes == 16 ? corr_tents_q8_kernel<T, P, 16>
                : lanes == 32 ? corr_tents_q8_kernel<T, P, 32>
                              : corr_tents_q8_kernel<T, P, 0>;
  const size_t smem = rows ? 0 : sizeof(int) * kWarps * (c / 4);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // Query-major, as the float kernel: a frame's query blocks are neighbours
  // in launch order.
  dim3 blocks((n + qpb - 1) / qpb, bt);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(grid), static_cast<const T*>(query),
      static_cast<const float*>(pos_scale), static_cast<const float*>(frame_scale),
      static_cast<const float*>(cy), static_cast<const float*>(cx),
      static_cast<float*>(out), h, w, c, n, qpb);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* grid, const void* query, const void* cy,
           const void* cx, void* out, int bt, int h, int w, int c, int n,
           int qpb, int rows, cudaStream_t stream) {
  constexpr int P = 7;
  if (rows != static_cast<int>(float_rows_ok<T>(grid, query, c))) {
    return cudaErrorInvalidValue;
  }
  const int pieces = rows ? static_cast<int>(c * sizeof(T) / 16) : 0;
  auto kernel = pieces == 4     ? corr_tents_kernel<T, P, 4, 1>
                : pieces == 8   ? corr_tents_kernel<T, P, 8, 1>
                : pieces == 16  ? corr_tents_kernel<T, P, 16, 1>
                : pieces == 32  ? corr_tents_kernel<T, P, 32, 1>
                : pieces == 64  ? corr_tents_kernel<T, P, 32, 2>
                : pieces == 128 ? corr_tents_kernel<T, P, 32, 4>
                                : corr_tents_kernel<T, P, 0, 1>;
  const size_t smem = rows ? 0 : sizeof(float) * qpb * c;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // The query blocks of a frame are neighbours in launch order, so the
  // blocks at work share a few frames' window rows in L2.
  dim3 blocks((n + qpb - 1) / qpb, bt);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(grid), static_cast<const T*>(query),
      static_cast<const float*>(cy), static_cast<const float*>(cx),
      static_cast<float*>(out), h, w, c, n, qpb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// grid [bt, h, w, c] and query [bt, n, c] in the compute dtype (dtype 0:
// float32, 1: bfloat16); cy, cx [bt, n] float32; out [bt, p, p, n] float32.
// qpb (queries a block: 1, 2, 4 or 8) and rows (1: the row-wise loop) as the
// caller's launch plan gives them (corr_tents.float_launch_plan); a loop
// that disagrees with float_rows_ok is refused. Only p == 7 is
// instantiated. Returns the launch's cudaError_t.
int corr_tents_forward(const void* grid, const void* query, const void* cy,
                       const void* cx, void* out, int bt, int h, int w, int c,
                       int n, int p, int qpb, int rows, int dtype, void* stream) {
  if (p != 7 || bt <= 0 || n <= 0 || c <= 0 || bt > 65535) {
    return cudaErrorInvalidValue;
  }
  if (qpb != 1 && qpb != 2 && qpb != 4 && qpb != 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(grid, query, cy, cx, out, bt, h, w, c, n, qpb, rows, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(grid, query, cy, cx, out, bt, h, w, c, n, qpb,
                                 rows, s);
  }
  return cudaErrorInvalidValue;
}

// grid [bt, h, w, c] int8 with c % 4 == 0 and a 4-byte aligned base; query
// [bt, n, c] in the compute dtype (dtype 0: float32, 1: bfloat16), quantized
// per row inside the kernel; exactly one of pos_scale [bt, h, w] (per
// position) and frame_scale [bt] (per frame) float32, the other null; cy, cx
// [bt, n] float32; out [bt, p, p, n] float32. qpb (queries a block: 1, 2, 4
// or 8) and rows (1: the row-wise loop) as the caller's launch plan gives
// them (corr_tents.q8_launch_plan); a loop that disagrees with q8_rows_ok is
// refused. Only p == 7 is instantiated. Returns the launch's cudaError_t.
int corr_tents_q8_forward(const void* grid, const void* query,
                          const void* pos_scale, const void* frame_scale,
                          const void* cy, const void* cx, void* out, int bt,
                          int h, int w, int c, int n, int p, int qpb, int rows,
                          int dtype, void* stream) {
  if (p != 7 || bt <= 0 || n <= 0 || c <= 0 || c % 4 != 0 || bt > 65535 ||
      reinterpret_cast<uintptr_t>(grid) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  if ((pos_scale == nullptr) == (frame_scale == nullptr)) return cudaErrorInvalidValue;
  if (qpb != 1 && qpb != 2 && qpb != 4 && qpb != 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_q8<float>(grid, query, pos_scale, frame_scale, cy, cx, out, bt, h,
                            w, c, n, qpb, rows, s);
  }
  if (dtype == 1) {
    return launch_q8<__nv_bfloat16>(grid, query, pos_scale, frame_scale, cy, cx, out,
                                    bt, h, w, c, n, qpb, rows, s);
  }
  return cudaErrorInvalidValue;
}

// Symmetric per-row int8 quantization: v [rows, c] (dtype 0: float32, 1:
// bfloat16) -> q int8 [rows, c] and scale float32 [rows] (see
// corr_quantize_rows and corr_quantize_rows_scalar). Returns the launch's
// cudaError_t.
int quantize_rows(const void* v, void* q, void* scale, long long rows, int c,
                  int dtype, void* stream) {
  if (rows <= 0 || c <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_quantize<float>(v, q, scale, rows, c, s);
  if (dtype == 1) return launch_quantize<__nv_bfloat16>(v, q, scale, rows, c, s);
  return cudaErrorInvalidValue;
}

const char* tapnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

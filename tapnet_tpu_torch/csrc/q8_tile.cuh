// The int8 tile loop shared by K4 (csrc/fused_mixer_block.cu) and K6
// (csrc/extra_convs.cu), for Hopper (sm_90a).
//
// Operands live in shared memory as panels: [rows][64 bytes of K], the
// 16-byte unit u of row r stored at unit u ^ ((r >> 1) & 3). That is the
// K-major layout with Hopper's 64-byte swizzle (CUTLASS's Swizzle<2,4,3>),
// which wgmma reads through a shared-memory descriptor, and it keeps a
// 64-row, 2304-byte patch in 147,456 bytes with no padding.
//
// The pieces:
//   cp_async16 / cp_async_commit / cp_async_wait: 16-byte copies from device
//     memory into shared memory that bypass L1 (the weight ring; a piece
//     outside the operand is filled with zeros);
//   copy_panels: one tile of a row-major [rows, k] int8 matrix into panels;
//   wg_panel, fence_regs: one warpgroup's wgmma m64nNk32 s8 x s8 -> s32 over
//     one panel (two instructions of 32 bytes of K), A 64 rows and B N rows
//     of panels; accumulator element 4 j + e of a thread is row
//     16 (warp % 4) + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2;
//   the ring's barrier discipline (ring_wait): tile t is copied into stage
//     t % S two iterations after stage t % S was last read (prefetch distance
//     S - 2), so a warpgroup may leave one tile's wgmma in flight
//     (wgmma_wait<1>) while the next is issued; each iteration waits until
//     at most S - 3 copy groups are pending, makes this thread's copies
//     visible to wgmma's async proxy, and a barrier (the CTA's, or a
//     warpgroup's own named barrier where it has a ring of its own) makes
//     the tile visible to all who read it;
//   gelu_rn, gelu_bound, quantize_div, quantize_mul: the epilogue arithmetic,
//     rounded at the plain versions' points with no contraction, so that a
//     value computed twice (K4's and K6's two passes) is the same float both
//     times.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace q8 {

constexpr int kThreads = 256;  // 8 warps: K6's CTAs (K4's MLP has 16)
constexpr int kPanel = 64;     // bytes of K per panel row
constexpr float kAmaxFloor = 1e-8f;
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

// Byte offset of 16-byte unit `unit` (0..3) of panel row `row`.
__device__ __forceinline__ int panel_offset(int row, int unit) {
  return row * kPanel + ((unit ^ ((row >> 1) & 3)) << 4);
}

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

// Copies rows r0 .. r0+ROWS-1 and K bytes k0 .. k0+64*PANELS-1 of the
// row-major int8 matrix src [src_rows, src_k] (src_k % 16 == 0) into PANELS
// consecutive panels of ROWS rows at dst; outside the matrix, zeros. THREADS
// threads take part (tid: this one's index among them); neighbouring threads
// copy neighbouring 16-byte pieces of a row.
template <int ROWS, int PANELS, int THREADS = kThreads>
__device__ __forceinline__ void copy_panels(int8_t* dst, const int8_t* src,
                                            int src_rows, int src_k, int r0,
                                            int k0, int tid = threadIdx.x) {
  constexpr int kUnits = PANELS * 4;
  static_assert(ROWS * kUnits % THREADS == 0, "whole pieces per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kUnits / THREADS; ++i) {
    const int piece = tid + i * THREADS;
    const int r = piece / kUnits, u = piece % kUnits;
    const int k = k0 + u * 16;
    const bool pred = r0 + r < src_rows && k < src_k;
    const int8_t* g = pred ? src + static_cast<size_t>(r0 + r) * src_k + k : src;
    cp_async16(dst + (u >> 2) * ROWS * kPanel + panel_offset(r, u & 3), g, pred);
  }
}

// The kernels' dynamic shared memory from its first 1024-byte boundary: the
// 64-byte swizzle repeats every 512 bytes of address, and wgmma applies it
// to the address itself, so the panels must start on such a boundary. The
// array is declared with the runtime's own 16-byte alignment (declaring more
// lets the compiler assume what the runtime does not give), and each kernel
// asks for kSmemAlign bytes more than it lays out.
constexpr int kSmemAlign = 1024;
__device__ __forceinline__ int8_t* aligned_smem(int8_t* raw) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(raw));
  return raw + ((kSmemAlign - (a & (kSmemAlign - 1))) & (kSmemAlign - 1));
}

// This thread's shared-memory writes (st.shared, cp.async), made visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers: bar_sync waits until `count` threads of the CTA have
// arrived at barrier `id` (0 is __syncthreads'); bar_arrive arrives without
// waiting.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The ring's wait before consuming a tile, with S stages (see above), among
// the `count` threads that share barrier `id` (the CTA, or one warpgroup
// with a ring of its own).
template <int S>
__device__ __forceinline__ void ring_wait(int id = 0, int count = kThreads) {
  static_assert(S >= 3, "prefetch distance S - 2");
  cp_async_wait<S - 3>();
  fence_proxy_async();
  bar_sync(id, count);
}

// The shared-memory descriptor of a K-major panel with the 64-byte swizzle:
// start address, leading byte offset 1 (unused: 32 bytes of K never cross
// the 64-byte swizzle), stride byte offset 512 (8 rows of 64 bytes),
// swizzle mode 2. `p` is a panel's row 0, 512-byte aligned; adding 2 to the
// descriptor moves its start 32 bytes along K.
__device__ __forceinline__ uint64_t desc_sw64(const int8_t* p) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((addr >> 4) & 0x3FFF) | (uint64_t(1) << 16) | (uint64_t(512 >> 4) << 32) |
         (uint64_t(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins N accumulator registers at this point of the program: the compiler
// may not move their reads (the epilogue's) above a wgmma_wait, nor their
// last writes below a wgmma_fence, which it would otherwise do, since the
// waits name no registers.
template <int N>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (N / 2 registers) = A[64 rows, 32 bytes] . B[N rows, 32 bytes]^T (+ d if
// `accumulate`), the operands given by descriptors.
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One warpgroup's product over one panel: d += (or, without `accumulate`,
// =) A . B^T over the panel's 64 bytes of K, A the 64 rows at `a`, B the N
// rows at `b` (both panel rows, 512-byte aligned).
template <int N>
__device__ __forceinline__ void wg_panel(int* d, const int8_t* a, const int8_t* b,
                                         int accumulate) {
  const uint64_t da = desc_sw64(a), db = desc_sw64(b);
  wgmma_s8<N>(d, da, db, accumulate);
  wgmma_s8<N>(d, da + 2, db + 2, 1);
}

// GELU, tanh form, in the order of PyTorch's: 0.5 v (1 + tanh(sqrt(2/pi)
// (v + 0.044715 v^3))), each operation rounded on its own.
__device__ __forceinline__ float gelu_rn(float v) {
  const float cube = __fmul_rn(__fmul_rn(v, v), v);
  const float inner =
      __fmul_rn(0.7978845608028654f, __fadd_rn(v, __fmul_rn(0.044715f, cube)));
  return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.f, tanhf(inner)));
}

// A bound on |gelu_rn(v)|, exact in float32: 0.5 v is exact, 1 + tanh(.)
// lies in [1, 2] for v >= 0 and in [0, 1] for v < 0, and rounding is
// monotone, so gelu_rn(v) <= v and |gelu_rn(v)| <= 0.5 |v| (subnormal v
// aside, far under the quantizers' amax floor of 1e-8). A row's amax needs
// gelu_rn only of the values whose bound exceeds the amax so far: the others
// cannot raise it, and the maximum taken is the same.
__device__ __forceinline__ float gelu_bound(float v) {
  return v >= 0.f ? v : __fmul_rn(-0.5f, v);
}

// The ExtraConvs' quantizer: clip(rint(v / s), +-127), s the row's scale
// max(amax, 1e-8) * (1 / 127) (fused_extra_convs._q_rows).
__device__ __forceinline__ float scale_div(float amax) {
  return __fmul_rn(fmaxf(amax, kAmaxFloor), kInv127);
}
__device__ __forceinline__ int quantize_div(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}

// The mixer's quantizer: clip(rint(v * inv), +-127), inv = 127 / max(amax,
// 1e-8) (mixer_math.quantize_rows).
__device__ __forceinline__ int quantize_mul(float v, float inv) {
  return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f));
}

__device__ __forceinline__ uint16_t pack2(int a, int b) {
  return static_cast<uint16_t>((static_cast<uint32_t>(a) & 0xffu) |
                               ((static_cast<uint32_t>(b) & 0xffu) << 8));
}

}  // namespace q8

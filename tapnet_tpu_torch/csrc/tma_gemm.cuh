// A warp-specialised GEMM loop for Hopper (sm_90a): TMA loads into a ring of
// shared-memory stages, wgmma products, and an epilogue the caller supplies.
// Three operand types (the Op traits below) instantiate it:
//   * S8: X, the per-frame int8 3x3 convolution (csrc/extra_convs.cu), s8 x
//     s8 -> s32;
//   * Bf16: K3's two channel-MLP products in bf16 (csrc/fused_mixer_block.cu)
//     and K6f's conv_up and conv_out in bf16 (csrc/extra_convs.cu), bf16 x
//     bf16 -> f32;
//   * Tf32x3: K3's two products and K6f's conv_up and conv_out in float32
//     (csrc/fused_mixer_block.cu, csrc/extra_convs.cu), as error-compensated
//     TF32 (three tensor-core products of the operands' big and small TF32
//     parts).
//
// C[M, N] = A[M, K] . B[N, K]^T, both operands K-major. A CTA owns a 128 x
// Op::kBN output tile (256 columns for S8 and Bf16, 128 for Tf32x3); K goes
// in steps of 128 bytes (kBK: 128 int8, 64 bf16 or 32 float32 values), one
// 128-byte swizzle row.
//
//   * Operands: 2D (or, for B, 3D) TMA boxes of 128 bytes of K by 128 rows,
//     with the 128-byte swizzle (16-byte unit u of row r at u ^ (r % 8)),
//     the layout wgmma reads through a shared-memory descriptor of swizzle
//     mode 1: stride byte offset 1024 (8 rows of 128 bytes), leading byte
//     offset 1 (unused: a wgmma's 32 bytes of K never cross the swizzle
//     row), each step of 32 bytes of K 2 more on the descriptor's start
//     address. TMA fills a box's part outside the tensor with zeros, so a
//     ragged M, N or K needs no code: the epilogue skips rows >= M and
//     columns >= N.
//   * The ring: kStages stages of one A box (128 rows) and two B boxes (128
//     rows each), 48 KB a stage, each with a `full` mbarrier (the producer's
//     arrival with the stage's bytes, completed by TMA) and an `empty` one
//     (one arrival per consumer warp). S8 and Bf16 read the two B boxes as
//     the tile's 256 columns; Tf32x3 as the big and the small parts of its
//     128 columns (B given pre-split, [2, N, K]).
//   * Warp specialisation: warpgroups 0 and 1 consume (rows 64 w .. 64 w + 63
//     of the tile; wgmma m64n256 k32 for s8 and k16 for bf16, 128
//     accumulator registers a thread; m64n128k8 for tf32, 64), warpgroup 2
//     produces (one thread issues the TMA loads). setmaxnreg moves registers
//     from the producer (40) to the consumers (232); the launcher refuses a
//     build whose register count at launch (168 at 384 threads) would not
//     cover that.
//   * S8 and Bf16 read A through a descriptor, and a consumer keeps one
//     wgmma group in flight: it releases stage s when the group after the
//     one that read it has been issued. Tf32x3 reads A into registers
//     (wgmma's register-A form), splits each value there, and waits for its
//     stage's group before the registers are written again; the two
//     consumer warpgroups overlap each other's splits. Its stage's products
//     start from zero and are added to a second set of 64 registers in IEEE
//     float32 (the tensor cores' float32 accumulation truncates: summed in
//     them alone, K = 2048 values of the mixer's second product drifted by
//     2.7e-4 at |y| ~ 10 on the card, over the 1e-4 limit).
//   * Persistent CTAs: one per SM, walking the tiles with N fastest, so the
//     CTAs at work share their weight tiles in L2 and one tile's epilogue
//     overlaps the loads of the next (the producer runs up to kStages steps
//     ahead).
//   * The epilogue stages each consumer warp's values (16 rows by 128 bytes
//     of columns at a time) in shared memory and stores them as 16-byte
//     pieces, a row's 128 contiguous bytes to eight lanes, instead of the
//     accumulator layout's 4- or 8-byte pieces.
//
// The caller supplies two functors (see the Loader and Epilogue concepts
// below) and a kernel of its own that calls tg::gemm, so that the profiler
// names the kernel after its layer. mbarrier waits trap after about 8 s
// instead of hanging the card.
//
// Bound and design: a 128 x 256 tile reads 48 KB a K step for 8.4 M int8
// operations (4.2 M bf16 flops), 175 operations a byte from L2; the weights
// of X and K3 (2-2.4 MB) stay in L2. Tf32x3's 128 x 128 tile does 3.1 M
// TF32 flops (1.05 M float32-accurate ones) on its 48 KB, 64 a byte. The
// float32-accurate product costs three TF32 products, so its bound is 3x
// the operations over the 495 TFLOP/s TF32 peak. PERF.md section 6 has what
// this design reaches.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace tg {

constexpr int kBM = 128;    // rows of a tile: two consumer warpgroups of 64
constexpr int kBN = 256;    // columns of an S8 or Bf16 tile: wgmma n256
constexpr int kBNTf32 = 128;  // columns of a Tf32x3 tile: wgmma n128
constexpr int kBK = 128;    // bytes of K a stage: one 128-byte swizzle row
constexpr int kBoxRows = 128;  // rows of a TMA box (A: one, B: two a stage)
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kBK;
constexpr int kBBytes = 2 * kBoxRows * kBK;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmemAlign = 1024;  // the 128-byte swizzle repeats every 1024
// The epilogue's staging: per consumer warp, its 16 rows by kChunkBytes of
// columns at a time (a row padded by 16 bytes against bank conflicts).
constexpr int kChunkBytes = 128;
constexpr int kStagingPitch = kChunkBytes + 16;
constexpr int kStagingBytes = 16 * kStagingPitch;
constexpr int kSmemBytes = kSmemAlign + kStages * kStageBytes + 2 * kStages * 8 +
                           kConsumers * 4 * kStagingBytes;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// Registers a thread must have at launch for the consumers' setmaxnreg.inc.
constexpr int kLaunchRegs =
    (kConsumers * kConsumerRegs + kProducerRegs) / (kConsumers + 1);

// ------------------------------------------------------------ device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed; traps
// (an error at the next synchronisation, not a hung card) after about 8 s.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = -1;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) {
      start = now;
    } else if (now - start > (1LL << 34)) {
      __trap();
    }
  }
}

// TMA loads of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_2d(const CUtensorMap* map, void* dst, uint64_t* bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(const CUtensorMap* map, void* dst, uint64_t* bar,
                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// The shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: start address (1024-byte aligned), leading byte offset 1,
// stride byte offset 1024, swizzle mode 1. Adding 2 moves the start 32
// bytes along K.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr >> 4) & 0x3FFF) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
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

// Pins the accumulators at this point of the program: the compiler may not
// move their reads above a wgmma_wait, nor their writes below a
// wgmma_fence, which it would otherwise do, since the waits name no
// registers.
template <int N>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (128 registers) = A[64 rows, 32 bytes of K] . B[256 rows, 32 bytes]^T
// (+ d if `accumulate`). Accumulator element 4 j + e of a thread is row
// 16 (warp % 4) + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2.
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same for bf16 operands: 16 values (32 bytes) of K, float32 sums.
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 registers) = A[64 rows, 8 values of K] . B[128 rows, 8 values]^T
// (+ d if `accumulate`) in TF32, A from registers: a[i] of a thread holds
// A[16 (warp % 4) + lane / 4 + 8 (i % 2), lane % 4 + 4 (i / 2)] (pinned on
// the card by a probe kernel). Accumulator element 4 j + e as above, j < 16.
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// A float32 value rounded to TF32 (10 mantissa bits, to nearest, ties away
// from zero), as float32 bits whose low 13 bits are zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// Writes two values into the epilogue's staging buffer as the output type
// (the last argument selects it): float2, or two bf16 rounded to nearest.
__device__ __forceinline__ void stage_pair(int8_t* p, float a, float b, float*) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void stage_pair(int8_t* p, float a, float b, __nv_bfloat16*) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The operand types. Each gives its accumulator type, TMA element type and
// size, its tile's columns (kBN), where B box `half` of a stage starts for
// tile column n0 of a problem with n columns (b_row), whether a consumer
// keeps one wgmma group in flight across stages (kInFlight: A read through
// a descriptor; not when A sits in registers), and one stage of products of
// a consumer warpgroup (stage): `a` is its 64 rows of the stage's A box,
// `b` the stage's two B boxes, `first` the tile's first K step.
template <typename Self, int BN>
struct DescOp {
  static constexpr int kBN = BN;
  static constexpr bool kInFlight = true;
  static __device__ __forceinline__ int b_row(int n0, int half, int) {
    return n0 + half * kBoxRows;
  }
  template <typename Acc>
  static __device__ __forceinline__ void stage(Acc* acc, const int8_t* a,
                                               const int8_t* b, bool first) {
    const uint64_t da = desc_sw128(a), db = desc_sw128(b);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      Self::mma(acc, da + 2 * ks, db + 2 * ks, !first || ks > 0);
    }
  }
};
struct S8 : DescOp<S8, kBN> {
  using Acc = int;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int kElem = 1;
  static __device__ __forceinline__ void mma(Acc* d, uint64_t a, uint64_t b, int acc) {
    wgmma_s8(d, a, b, acc);
  }
};
struct Bf16 : DescOp<Bf16, kBN> {
  using Acc = float;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kElem = 2;
  static __device__ __forceinline__ void mma(Acc* d, uint64_t a, uint64_t b, int acc) {
    wgmma_bf16(d, a, b, acc);
  }
};
// float32 operands, error-compensated TF32 ("3xTF32"): v = big + small with
// big = tf32(v) and small = tf32(v - big) (v - big is exact in float32), and
// A.B ~ As.Bb + Ab.Bs + Ab.Bb into one float32 accumulator; the dropped
// As.Bs and the rounding of small are about 2^-22 of a product. B arrives
// split, [2, n, K] (big rows, then small rows: split_tf32 below); A is split
// in registers as it is read from the stage. A consumer thread reads its 16
// values of a stage (wgmma's register-A layout) from the swizzled box: row
// 16 warp + g (+8) has swizzle phase g = lane / 4, so the 32 lanes of a load
// hit 32 banks.
struct Tf32x3 {
  using Acc = float;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr int kElem = 4;
  static constexpr int kBN = kBNTf32;
  static constexpr bool kInFlight = false;
  static __device__ __forceinline__ int b_row(int n0, int half, int n) {
    return n0 + half * n;
  }
  static __device__ __forceinline__ void stage(float* acc, const int8_t* a,
                                               const int8_t* b, bool first) {
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int g = lane / 4, t = lane % 4;
    constexpr int kSteps = kBK / 32;  // k8 steps of 8 float32 values
    uint32_t big[kSteps][4], small[kSteps][4];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * warp + g + 8 * (i % 2);
        const int unit = 2 * ks + i / 2;
        const float v = *reinterpret_cast<const float*>(
            a + row * kBK + ((unit ^ g) * 16) + t * 4);
        big[ks][i] = tf32_rna(v);
        small[ks][i] = tf32_rna(v - __uint_as_float(big[ks][i]));
      }
    }
    const uint64_t db_big = desc_sw128(b);
    const uint64_t db_small = desc_sw128(b + kBoxRows * kBK);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      wgmma_tf32(acc, small[ks], db_big + 2 * ks, !first || ks > 0);
      wgmma_tf32(acc, big[ks], db_small + 2 * ks, 1);
      wgmma_tf32(acc, big[ks], db_big + 2 * ks, 1);
    }
  }
};

// B's split for Tf32x3: out[i] = tf32(w[i]), out[count + i] = tf32(w[i] -
// out[i]), for w [n, K] (count = n K values) into out [2, n, K].
__global__ void split_tf32(const float* __restrict__ w, float* __restrict__ out,
                           long long count) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float v = w[i];
    const uint32_t big = tf32_rna(v);
    out[i] = __uint_as_float(big);
    out[count + i] = __uint_as_float(tf32_rna(v - __uint_as_float(big)));
  }
}

// Launches split_tf32 on w [count values] into out [2 * count] on stream s.
inline cudaError_t split_weights(const float* w, float* out, long long count,
                                 cudaStream_t s) {
  const long long blocks = (count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096;
  split_tf32<<<static_cast<unsigned>(blocks > 0 ? blocks : 1), 256, 0, s>>>(w, out, count);
  return cudaGetLastError();
}

// The problem: C [m, n], K in nk steps of kBK bytes, tiles_m x tiles_n
// tiles.
struct Problem {
  int m, n, nk, tiles_m, tiles_n;
};

// Loader concept:
//   static constexpr int kBDims;   // 2 or 3: the rank of B's tensor map
//   // K step kk of the tile at row m0: A's box coordinates {k, row} ...
//   __device__ void a(int kk, int m0, int& c0, int& c1) const;
//   // ... and B's box of 128 rows from row n (Op::b_row): {k, row} or
//   // {k, mid, row}.
//   __device__ void b(int kk, int n, int& c0, int& c1, int& c2) const;
// Epilogue concept (Acc: int or float; Out: the output's float or bf16):
//   using Out = ...;
//   struct Row { bool ok; ... };              // ok: the row is stored
//   __device__ Row row(int r) const;          // r < m
//   // The value at (row, col < n) from its sum, rounded to Out when staged.
//   __device__ float value(const Row&, int col, Acc s) const;
//   // Stores 16 bytes of staged values, columns col .. (< n), of a row.
//   __device__ void store(const Row&, int col, uint4 v) const;
// A consumer warp computes the values of its 16 rows of the tile into its
// staging buffer 128 bytes of columns at a time, then stores them as
// 16-byte pieces, eight lanes to a row's 128 contiguous bytes (n must be a
// multiple of 16 bytes of Out).
//
// smem_raw: the kernel's dynamic shared memory (kSmemBytes).
template <typename Op, typename Loader, typename Epilogue>
__device__ __forceinline__ void gemm(int8_t* smem_raw, const CUtensorMap* ma,
                                     const CUtensorMap* mb, const Problem& pb,
                                     const Loader& ld, const Epilogue& ep) {
  using Acc = typename Op::Acc;
  constexpr int BN = Op::kBN;
  constexpr int kAcc = BN / 2;  // accumulator registers a thread: m64 x BN
  const uint32_t raw = smem_u32(smem_raw);
  int8_t* smem = smem_raw + ((kSmemAlign - (raw & (kSmemAlign - 1))) & (kSmemAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  int8_t* staging = reinterpret_cast<int8_t*>(empty + kStages) +
                    (threadIdx.x / 32) * kStagingBytes;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int tiles = pb.tiles_m * pb.tiles_n;

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x % 128 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
        const int m0 = (u / pb.tiles_n) * kBM;
        const int n0 = (u % pb.tiles_n) * BN;
        for (int kk = 0; kk < pb.nk; ++kk) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint64_t* bar = &full[stage];
          int8_t* sa = smem + stage * kStageBytes;
          int8_t* sb = sa + kABytes;
          mbar_expect_tx(bar, kStageBytes);
          int c0, c1, c2;
          ld.a(kk, m0, c0, c1);
          tma_2d(ma, sa, bar, c0, c1);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            ld.b(kk, Op::b_row(n0, half, pb.n), c0, c1, c2);
            int8_t* dst = sb + half * kBoxRows * kBK;
            if constexpr (Loader::kBDims == 3) {
              tma_3d(mb, dst, bar, c0, c1, c2);
            } else {
              tma_2d(mb, dst, bar, c0, c1);
            }
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    Acc acc[kAcc];
    // Without a group in flight, each stage's products start from zero and
    // are added to `sums` in IEEE float32: the tensor cores' float32
    // accumulation truncates, and a K of 2048 summed in them alone drifts by
    // about 2^-14 of the sum.
    Acc sums[Op::kInFlight ? 1 : kAcc];
    int stage = 0;
    uint32_t phase = 0;
    // A consumer warp's release of a stage: one arrival on its empty barrier.
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
      const int m0 = (u / pb.tiles_n) * kBM;
      const int n0 = (u % pb.tiles_n) * BN;
      int prev = -1;
      for (int kk = 0; kk < pb.nk; ++kk) {
        mbar_wait(&full[stage], phase);
        const int8_t* sa = smem + stage * kStageBytes;
        fence_regs<kAcc>(acc);
        Op::stage(acc, sa + wg * 64 * kBK, sa + kABytes, kk == 0 || !Op::kInFlight);
        wgmma_commit();
        if constexpr (Op::kInFlight) {
          wgmma_wait<1>();
          if (prev >= 0) release(prev);
          prev = stage;
        } else {
          wgmma_wait<0>();
          fence_regs<kAcc>(acc);
          release(stage);
#pragma unroll
          for (int i = 0; i < kAcc; ++i) sums[i] = kk == 0 ? acc[i] : sums[i] + acc[i];
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<kAcc>(acc);
      if (prev >= 0) release(prev);
      auto total = [&](int i) -> Acc {
        if constexpr (Op::kInFlight) {
          return acc[i];
        } else {
          return sums[i];
        }
      };

      // Rows of this thread: in the sums (lane / 4, + 8) and in the stores
      // (lane / 8 + 4 i), of the warp's 16 from w0.
      using Row = typename Epilogue::Row;
      using Out = typename Epilogue::Out;
      const int w0 = m0 + wg * 64 + warp * 16;
      Row sum_rows[2], store_rows[4];
      bool stored[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = w0 + lane / 4 + 8 * h;
        sum_rows[h] = ep.row(r < pb.m ? r : pb.m - 1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = w0 + lane / 8 + 4 * i;
        store_rows[i] = ep.row(r < pb.m ? r : pb.m - 1);
        stored[i] = r < pb.m && store_rows[i].ok;
      }
      constexpr int kChunkCols = kChunkBytes / static_cast<int>(sizeof(Out));
      constexpr int kUnit = 16 / static_cast<int>(sizeof(Out));  // values a store
#pragma unroll
      for (int c0 = 0; c0 < BN; c0 += kChunkCols) {
        if (n0 + c0 >= pb.n) break;
#pragma unroll
        for (int jj = 0; jj < kChunkCols / 8; ++jj) {
          const int j = c0 / 8 + jj;
          const int cc = 8 * jj + 2 * (lane % 4);
          const int col = n0 + c0 + cc;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = 0.f, v1 = 0.f;
            if (col < pb.n) {
              v0 = ep.value(sum_rows[h], col, total(4 * j + 2 * h));
              v1 = ep.value(sum_rows[h], col + 1, total(4 * j + 2 * h + 1));
            }
            stage_pair(staging + (lane / 4 + 8 * h) * kStagingPitch + cc * sizeof(Out),
                       v0, v1, static_cast<Out*>(nullptr));
          }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n0 + c0 + (lane % 8) * kUnit;
          const uint4 v = *reinterpret_cast<const uint4*>(
              staging + (lane / 8 + 4 * i) * kStagingPitch + (lane % 8) * 16);
          if (stored[i] && col < pb.n) ep.store(store_rows[i], col, v);
        }
        __syncwarp();
      }
    }
  }
}

// -------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` (2 or 3) dimensions, innermost first: dims in
// elements, strides in bytes of dimensions 1.. (multiples of 16); boxes of
// kBK bytes of the innermost dimension, 1 of the middle one (rank 3) and
// kBoxRows of the outermost, with the 128-byte swizzle; zeros outside.
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                            int rank, const void* base, const uint64_t* dims,
                            const uint64_t* strides) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  cuuint64_t d[3], st[2];
  cuuint32_t box[3], unit[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) d[i] = dims[i];
  for (int i = 0; i + 1 < rank; ++i) st[i] = strides[i];
  box[0] = kBK / elem_bytes;
  box[rank - 1] = kBoxRows;
  if (rank == 3) box[1] = 1;
  const CUresult res = encode(map, type, static_cast<cuuint32_t>(rank),
                              const_cast<void*>(base), d, st, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The problem of C [m, n] with k_bytes bytes of K per row, in Op's tiles.
template <typename Op>
inline Problem problem(int m, int n, long long k_bytes) {
  return Problem{m, n, static_cast<int>((k_bytes + kBK - 1) / kBK), (m + kBM - 1) / kBM,
                 (n + Op::kBN - 1) / Op::kBN};
}

// Launches `kernel` (a __global__ that calls tg::gemm) on a persistent
// grid: one CTA per SM, at most one per tile. Refuses a kernel whose
// register count at launch would not leave the consumers their
// kConsumerRegs.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), const Problem& pb, cudaStream_t s,
                   Args&&... args) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < kLaunchRegs) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(pb.tiles_m) * pb.tiles_n;
  if (tiles <= 0 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles < sms ? tiles : sms));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace tg

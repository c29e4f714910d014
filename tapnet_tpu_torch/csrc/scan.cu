// Diagonal linear recurrence (the RG-LRU scan of TAPNext), hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tapnet_tpu/ops/scan.py::_scan_kernel
// (launched by _scan_pallas; public entry linear_scan).
//
// What it computes, for every row b and channel c:
//   h = h0[b, c];  for t in 0..T-1:  h = a[b, t, c] * h + x[b, t, c];
//                                    y[b, t, c] = h  (rounded to x's dtype)
//   h_last[b, c] = h
// with the carry in float32 whatever the I/O dtype (float32 or bfloat16).
//
// Design. The TPU kernel walks a (batch, channel, time-chunk) grid in order
// and carries h in a VMEM scratch from one time chunk to the next. Here the
// rows and channels are independent and time is the only sequential axis, so
// one thread owns one row and 4 neighbouring channels and walks all T steps
// with the carry in registers: no state crosses threads or blocks, h0 is read
// once and h_last written once. Neighbouring threads own neighbouring
// channels, so each step of a warp reads and writes 512 contiguous bytes of x,
// a and y (16 bytes a lane as float4 in float32, 8 bytes as 4 bfloat16).
// Widths that are no multiple of 4 (or unaligned bases) take the same loop
// with scalar, bounds-checked loads. Loads of later steps do not depend on
// the carry, and the pointers are __restrict__, so the unrolled loop keeps
// several steps' loads in flight.
//
// Rounding. The step is __fmul_rn then __fadd_rn: two roundings, as the plain
// PyTorch version's separate multiply and add, so nvcc cannot contract it
// into an FMA and the kernel equals the plain version bit for bit. y is
// rounded to bfloat16 to nearest even, as PyTorch's cast.
//
// Bound on the H100: memory. Per element it reads x and a and writes y (12
// bytes in float32) against 2 flops; at [1280, 50, 768] float32 that is
// 590 MB, 0.176 ms at 3.35 TB/s.
//
// K5b, the backward (linear_scan_backward): replaces the reverse-time launch
// of the same Pallas kernel in tapnet_tpu/ops/scan.py::_scan_bwd. With the
// output cotangent dy (and dh_last, the cotangent of h_last, folded into the
// last step) it computes, for every row and channel,
//   g[T-1] = dy[T-1] + dh_last;  g[t] = a[t+1] * g[t+1] + dy[t]
//   dx[t] = g[t];  da[t] = g[t] * h[t-1];  dh0 = a[0] * g[0]
// where h[t-1] is y[t-1], or h0 rounded to y's dtype at t = 0. The TPU code
// flips dy and a in memory, shifts the decay by one step with a column of
// ones and runs the forward kernel over that; here one thread owns one row
// and 4 channels, as in the forward, and walks t = T-1 ... 0 with the
// float32 carry g in registers. The decay a[t+1] of a step is the one the
// thread loaded in the step before, so each of dy, a and y is read once and
// nothing is flipped or copied. dx[t] and da[t] are written in the same
// pass (da reads y[t-1], or h0 at t = 0) and dh0 once per row at the end.
// The same two roundings per step (__fmul_rn, __fadd_rn), a product rounded
// once for da and casts to nearest even make it equal to the plain version
// (ops/scan.py::linear_scan_backward_reference) bit for bit.
//
// Bound: memory. Per element it reads dy, a, y and writes dx, da (20 bytes
// in float32); at [9216, 24, 768] float32 that is 3.4 GB, 1.01 ms at
// 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // channels per thread

struct Vec4 {
  float v[kVec];
};

template <typename T, bool kVector>
__device__ __forceinline__ Vec4 load4(const T* __restrict__ p, int valid);

template <>
__device__ __forceinline__ Vec4 load4<float, true>(const float* __restrict__ p,
                                                   int) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  return Vec4{{q.x, q.y, q.z, q.w}};
}

template <>
__device__ __forceinline__ Vec4 load4<__nv_bfloat16, true>(
    const __nv_bfloat16* __restrict__ p, int) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return Vec4{{lo.x, lo.y, hi.x, hi.y}};
}

template <>
__device__ __forceinline__ Vec4 load4<float, false>(const float* __restrict__ p,
                                                    int valid) {
  Vec4 r{{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < valid) r.v[i] = p[i];
  }
  return r;
}

template <>
__device__ __forceinline__ Vec4 load4<__nv_bfloat16, false>(
    const __nv_bfloat16* __restrict__ p, int valid) {
  Vec4 r{{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < valid) r.v[i] = __bfloat162float(p[i]);
  }
  return r;
}

template <typename T, bool kVector>
__device__ __forceinline__ void store4(T* __restrict__ p, const float* h,
                                       int valid);

template <>
__device__ __forceinline__ void store4<float, true>(float* __restrict__ p,
                                                    const float* h, int) {
  *reinterpret_cast<float4*>(p) = make_float4(h[0], h[1], h[2], h[3]);
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16, true>(
    __nv_bfloat16* __restrict__ p, const float* h, int) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(h[0], h[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(h[2], h[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&lo);
  q.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

template <>
__device__ __forceinline__ void store4<float, false>(float* __restrict__ p,
                                                     const float* h, int valid) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < valid) p[i] = h[i];
  }
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16, false>(
    __nv_bfloat16* __restrict__ p, const float* h, int valid) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < valid) p[i] = __float2bfloat16_rn(h[i]);
  }
}

// x, a, y: [rows, steps, width] in T; h0, h_last: [rows, width] float32.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
    linear_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                       const float* __restrict__ h0, T* __restrict__ y,
                       float* __restrict__ h_last, int rows, int steps,
                       int width) {
  const int groups = (width + kVec - 1) / kVec;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * groups) return;
  const int row = static_cast<int>(idx / groups);
  const int c0 = static_cast<int>(idx % groups) * kVec;
  const int valid = min(kVec, width - c0);

  float h[kVec];
  const float* h0_row = h0 + static_cast<size_t>(row) * width + c0;
#pragma unroll
  for (int i = 0; i < kVec; ++i) h[i] = i < valid ? h0_row[i] : 0.f;

  const size_t base = static_cast<size_t>(row) * steps * width + c0;
  const T* xp = x + base;
  const T* ap = a + base;
  T* yp = y + base;
#pragma unroll 4
  for (int t = 0; t < steps; ++t) {
    const size_t off = static_cast<size_t>(t) * width;
    const Vec4 xv = load4<T, kVector>(xp + off, valid);
    const Vec4 av = load4<T, kVector>(ap + off, valid);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      h[i] = __fadd_rn(__fmul_rn(av.v[i], h[i]), xv.v[i]);
    }
    store4<T, kVector>(yp + off, h, valid);
  }
  float* hl = h_last + static_cast<size_t>(row) * width + c0;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < valid) hl[i] = h[i];
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* h0, void* y, void* h_last,
           int rows, int steps, int width, cudaStream_t stream) {
  const long long groups = (width + kVec - 1) / kVec;
  const long long threads = static_cast<long long>(rows) * groups;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // Vector loads need every row and step to start on a whole vector: width a
  // multiple of 4 and the bases aligned to 4 elements.
  const uintptr_t align = kVec * sizeof(T);
  const bool vector = width % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(x) % align == 0 &&
                      reinterpret_cast<uintptr_t>(a) % align == 0 &&
                      reinterpret_cast<uintptr_t>(y) % align == 0;
  auto kernel = vector ? linear_scan_kernel<T, true>
                       : linear_scan_kernel<T, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), rows, steps, width);
  return cudaGetLastError();
}

// dy, a, y, dx, da: [rows, steps, width] in T; h0, dh_last, dh0: [rows,
// width] float32; dh_last may be null (no cotangent for h_last).
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
    linear_scan_backward_kernel(const T* __restrict__ dy,
                                const T* __restrict__ a,
                                const T* __restrict__ y,
                                const float* __restrict__ h0,
                                const float* __restrict__ dh_last,
                                T* __restrict__ dx, T* __restrict__ da,
                                float* __restrict__ dh0, int rows, int steps,
                                int width) {
  const int groups = (width + kVec - 1) / kVec;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * groups) return;
  const int row = static_cast<int>(idx / groups);
  const int c0 = static_cast<int>(idx % groups) * kVec;
  const int valid = min(kVec, width - c0);
  const size_t state = static_cast<size_t>(row) * width + c0;

  const size_t base = static_cast<size_t>(row) * steps * width + c0;
  const T* dyp = dy + base;
  const T* ap = a + base;
  const T* yp = y + base;
  T* dxp = dx + base;
  T* dap = da + base;

  // The last step: g = dy[T-1] (+ dh_last).
  const size_t last = static_cast<size_t>(steps - 1) * width;
  float g[kVec];
  {
    const Vec4 dyv = load4<T, kVector>(dyp + last, valid);
#pragma unroll
    for (int i = 0; i < kVec; ++i) g[i] = dyv.v[i];
    if (dh_last != nullptr) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (i < valid) g[i] = __fadd_rn(g[i], dh_last[state + i]);
      }
    }
  }
  // h[t-1] at t = 0: h0 rounded to y's dtype, as the plain version.
  float h_first[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) h_first[i] = i < valid ? h0[state + i] : 0.f;
  {
    T rounded[kVec];
    store4<T, false>(rounded, h_first, kVec);
    const Vec4 back = load4<T, false>(rounded, kVec);
#pragma unroll
    for (int i = 0; i < kVec; ++i) h_first[i] = back.v[i];
  }

  Vec4 a_next = load4<T, kVector>(ap + last, valid);
  for (int t = steps - 1; t >= 0; --t) {
    const size_t off = static_cast<size_t>(t) * width;
    if (t != steps - 1) {
      const Vec4 dyv = load4<T, kVector>(dyp + off, valid);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        g[i] = __fadd_rn(__fmul_rn(a_next.v[i], g[i]), dyv.v[i]);
      }
      a_next = load4<T, kVector>(ap + off, valid);
    }
    store4<T, kVector>(dxp + off, g, valid);
    float prod[kVec];
    if (t > 0) {
      const Vec4 hv = load4<T, kVector>(yp + off - width, valid);
#pragma unroll
      for (int i = 0; i < kVec; ++i) prod[i] = __fmul_rn(g[i], hv.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) prod[i] = __fmul_rn(g[i], h_first[i]);
    }
    store4<T, kVector>(dap + off, prod, valid);
  }
  // a_next now holds a[0].
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < valid) dh0[state + i] = __fmul_rn(a_next.v[i], g[i]);
  }
}

template <typename T>
int launch_backward(const void* dy, const void* a, const void* y,
                    const void* h0, const void* dh_last, void* dx, void* da,
                    void* dh0, int rows, int steps, int width,
                    cudaStream_t stream) {
  const long long groups = (width + kVec - 1) / kVec;
  const long long threads = static_cast<long long>(rows) * groups;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const uintptr_t align = kVec * sizeof(T);
  const bool vector = width % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(dy) % align == 0 &&
                      reinterpret_cast<uintptr_t>(a) % align == 0 &&
                      reinterpret_cast<uintptr_t>(y) % align == 0 &&
                      reinterpret_cast<uintptr_t>(dx) % align == 0 &&
                      reinterpret_cast<uintptr_t>(da) % align == 0;
  auto kernel = vector ? linear_scan_backward_kernel<T, true>
                       : linear_scan_backward_kernel<T, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(a),
      static_cast<const T*>(y), static_cast<const float*>(h0),
      static_cast<const float*>(dh_last), static_cast<T*>(dx),
      static_cast<T*>(da), static_cast<float*>(dh0), rows, steps, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, a [rows, steps, width] and y [rows, steps, width] in float32 (dtype 0)
// or bfloat16 (dtype 1); h0 and h_last [rows, width] float32; all contiguous.
// Returns the launch's cudaError_t.
int linear_scan_forward(const void* x, const void* a, const void* h0, void* y,
                        void* h_last, int rows, int steps, int width, int dtype,
                        void* stream) {
  if (rows <= 0 || steps <= 0 || width <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, a, h0, y, h_last, rows, steps, width, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, a, h0, y, h_last, rows, steps, width, s);
  }
  return cudaErrorInvalidValue;
}

// dy, a, y, dx, da [rows, steps, width] in float32 (dtype 0) or bfloat16
// (dtype 1); h0, dh0 [rows, width] float32; dh_last [rows, width] float32 or
// null; all contiguous. Returns the launch's cudaError_t.
int linear_scan_backward(const void* dy, const void* a, const void* y,
                         const void* h0, const void* dh_last, void* dx,
                         void* da, void* dh0, int rows, int steps, int width,
                         int dtype, void* stream) {
  if (rows <= 0 || steps <= 0 || width <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_backward<float>(dy, a, y, h0, dh_last, dx, da, dh0, rows,
                                  steps, width, s);
  }
  if (dtype == 1) {
    return launch_backward<__nv_bfloat16>(dy, a, y, h0, dh_last, dx, da, dh0,
                                          rows, steps, width, s);
  }
  return cudaErrorInvalidValue;
}

const char* tapnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// rmsnorm_fwd for Hopper: y = x * rsqrt(mean(x^2) + eps) * scale, row by row.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_fwd
// (_rms_fwd_kernel; pallas_call at rmsnorm.py:41).  Math in f32, output
// in x's storage type (f32 or bf16), scale read as f32.
//
// What bounds it on the H100: bytes.  It does ~4 flops per element, far
// below the ~295 flops/byte the card needs before compute matters, so the
// least time is (N*D*2*sizeof(x) + D*4) / 3.35 TB/s.  On the serve path N
// is the number of decode lanes (8), so a call moves ~30 KB and its time is
// launch latency, not bandwidth.
//
// What the design does about it: one CTA of 128 threads per row reads the
// row from device memory with 16-byte vector loads (8 bf16 or 4 f32 a
// load) when D allows it, reduces the sum of squares with warp shuffles,
// reads its own entries of the row again for the second pass (they are
// in L1/L2 by then, so device memory sees the row once) and writes the
// row once.  Nothing of the row is kept in shared memory, so D has no
// upper limit.  D need not be a power of two (qwen2-0.5b: 896,
// smollm-360m: 960) and any N >= 1 is taken: the grid is N rows, so there
// is no 256-row block and no tail to mask, unlike the TPU kernel whose
// wrapper asserts N % 256 == 0.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  constexpr int kV = 16 / sizeof(T);        // elements per 16-byte load
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * d;
  T* yr = y + static_cast<int64_t>(blockIdx.x) * d;

  float ss = 0.f;
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / kV; i += kThreads) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float f = to_f32<T>(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float f = to_f32<T>(xr[i]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += partial[w];
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);

  // Second pass: each thread reads again the entries it read above.
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < d / kV; i += kThreads) {
      const uint4 in = xv[i];
      const T* a = reinterpret_cast<const T*>(&in);
      uint4 out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        e[j] = from_f32<T>(to_f32<T>(a[j]) * inv * scale[i * kV + j]);
      }
      yv[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      yr[i] = from_f32<T>(to_f32<T>(xr[i]) * inv * scale[i]);
    }
  }
}

template <typename T>
void launch(const void* x, const float* scale, void* y, int n, int d,
            float eps, int vec, cudaStream_t stream) {
  if (vec) {
    rmsnorm_fwd_kernel<T, true><<<n, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(y), d, eps);
  } else {
    rmsnorm_fwd_kernel<T, false><<<n, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(y), d, eps);
  }
}

}  // namespace
}  // namespace repro_torch

// x, y: [n, d] contiguous, storage type `dtype`; scale: [d] f32.
// `vec` != 0 selects 16-byte loads (the caller checked d and alignment).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* scale, void* y,
                                 int n, int d, float eps, int dtype, int vec,
                                 void* stream) {
  using namespace repro_torch;
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  switch (dtype) {
    case kF32: launch<float>(x, sc, y, n, d, eps, vec, s); break;
    case kBF16: launch<__nv_bfloat16>(x, sc, y, n, d, eps, vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// rmsnorm_fwd and rmsnorm_bwd for Hopper.
//
// rmsnorm_fwd: y = x * rsqrt(mean(x^2) + eps) * scale, row by row.
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
//
// rmsnorm_bwd: with inv = rsqrt(mean(x^2) + eps) and xhat = x * inv,
// dx = inv * (g*s - xhat * mean(g*s*xhat)) in x's storage type, and
// sum over the rows of g*xhat as dscale.  Replaces the TPU kernel
// src/repro/kernels/rmsnorm.py::rmsnorm_bwd (_rms_bwd_kernel; pallas_call
// at rmsnorm.py:61), which writes one f32 dscale partial per block of
// rows; so does this one, one row of partials per CTA of kBwdRows rows,
// and the caller sums them (kernels/ops.py, as the JAX ops.py does).  No
// atomics: the result does not depend on the order CTAs run in.
//
// What bounds it on the H100: bytes.  It reads x and g and writes dx,
// ~12 flops per element; at the training shape [8192, 960] bf16 that is
// 47 MB, ~14 us at 3.35 TB/s.
//
// What the design does about it: each CTA first gives one warp per row
// (16-byte loads, warp-shuffle sums) and keeps the row's inv and
// mean(g*s*xhat) in shared memory; then each thread owns 16 bytes of
// columns and walks the CTA's rows, so the loads of x and g are
// coalesced along a row (their second read hits L2), dx is written once,
// and the thread's dscale partial stays in registers until one store.
// Any N >= 1 (the last CTA takes the ragged rest) and any D.
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

constexpr int kBwdThreads = 128;
constexpr int kBwdRows = 32;     // rows per CTA (kernels/rmsnorm.py: BWD_BLOCK_ROWS)

template <typename T, bool kVec>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ part, int n, int d, float eps) {
  __shared__ float inv_s[kBwdRows];
  __shared__ float mean_s[kBwdRows];     // mean(g*s*xhat) of the row
  constexpr int kV = 16 / sizeof(T);
  constexpr int kWarps = kBwdThreads / 32;
  const int row0 = blockIdx.x * kBwdRows;
  const int rows = min(kBwdRows, n - row0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // Phase 1: one warp per row.
  for (int r = warp; r < rows; r += kWarps) {
    const T* xr = x + static_cast<int64_t>(row0 + r) * d;
    const T* gr = g + static_cast<int64_t>(row0 + r) * d;
    float ss = 0.f, gsx = 0.f;
    if (kVec) {
      for (int i = lane; i < d / kV; i += 32) {
        const uint4 xraw = reinterpret_cast<const uint4*>(xr)[i];
        const uint4 graw = reinterpret_cast<const uint4*>(gr)[i];
        const T* xe = reinterpret_cast<const T*>(&xraw);
        const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const float xf = to_f32<T>(xe[j]);
          ss += xf * xf;
          gsx += to_f32<T>(ge[j]) * scale[i * kV + j] * xf;
        }
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float xf = to_f32<T>(xr[i]);
        ss += xf * xf;
        gsx += to_f32<T>(gr[i]) * scale[i] * xf;
      }
    }
    ss = warp_sum(ss);
    gsx = warp_sum(gsx);
    if (lane == 0) {
      const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
      inv_s[r] = inv;
      mean_s[r] = inv * gsx / static_cast<float>(d);
    }
  }
  __syncthreads();

  // Phase 2: each thread owns a run of columns and walks the rows.
  float* pr = part + static_cast<int64_t>(blockIdx.x) * d;
  if (kVec) {
    for (int c = threadIdx.x; c < d / kV; c += kBwdThreads) {
      float acc[kV], sc[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        acc[j] = 0.f;
        sc[j] = scale[c * kV + j];
      }
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const int64_t off = static_cast<int64_t>(row0 + r) * d + c * kV;
        const uint4 xraw = *reinterpret_cast<const uint4*>(x + off);
        const uint4 graw = *reinterpret_cast<const uint4*>(g + off);
        const T* xe = reinterpret_cast<const T*>(&xraw);
        const T* ge = reinterpret_cast<const T*>(&graw);
        const float inv = inv_s[r], mean = mean_s[r];
        uint4 out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const float xh = to_f32<T>(xe[j]) * inv;
          const float gf = to_f32<T>(ge[j]);
          oe[j] = from_f32<T>(inv * (gf * sc[j] - xh * mean));
          acc[j] += gf * xh;
        }
        *reinterpret_cast<uint4*>(dx + off) = out;
      }
#pragma unroll
      for (int j = 0; j < kV; j += 4) {
        *reinterpret_cast<float4*>(pr + c * kV + j) =
            make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
      }
    }
  } else {
    for (int c = threadIdx.x; c < d; c += kBwdThreads) {
      const float sc = scale[c];
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) {
        const int64_t off = static_cast<int64_t>(row0 + r) * d + c;
        const float xh = to_f32<T>(x[off]) * inv_s[r];
        const float gf = to_f32<T>(g[off]);
        dx[off] = from_f32<T>(inv_s[r] * (gf * sc - xh * mean_s[r]));
        acc += gf * xh;
      }
      pr[c] = acc;
    }
  }
}

template <typename T>
void launch_bwd(const void* x, const float* scale, const void* g, void* dx,
                float* part, int n, int d, float eps, int vec,
                cudaStream_t stream) {
  const int nb = (n + kBwdRows - 1) / kBwdRows;
  auto kernel = vec ? rmsnorm_bwd_kernel<T, true> : rmsnorm_bwd_kernel<T, false>;
  kernel<<<nb, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(g),
      static_cast<T*>(dx), part, n, d, eps);
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

// x, g, dx: [n, d] contiguous, storage type `dtype`; scale: [d] f32;
// part: [ceil(n / rows_per_block), d] f32, one row per CTA.
// `rows_per_block` must equal kBwdRows (the caller's BWD_BLOCK_ROWS).
// `vec` != 0 selects 16-byte loads (the caller checked d and alignment).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* g, void* dx, void* part, int n,
                                 int d, int rows_per_block, float eps,
                                 int dtype, int vec, void* stream) {
  using namespace repro_torch;
  if (n < 1 || d < 1 || rows_per_block != kBwdRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case kF32: launch_bwd<float>(x, sc, g, dx, p, n, d, eps, vec, s); break;
    case kBF16: launch_bwd<__nv_bfloat16>(x, sc, g, dx, p, n, d, eps, vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// What the design does about it: keep as many bytes in flight as the row
// allows and read each byte once.  Two paths of one kernel, chosen by D
// and the storage type alone (kernels/rmsnorm.py::rmsnorm_fwd_path):
//   - rows (D a multiple of 16 bytes, at most 256 bytes of the row a
//     lane: D <= 4096 in bf16, 2048 in f32): at large N one warp per row,
//     eight rows a CTA, the sum of squares taken with shuffles alone (no
//     barrier); at small N (the serve path's 8 rows) one row a CTA of four
//     warps, each thread's scale entries loaded with its row chunks and
//     one shared-memory add across the warps.  Each thread issues all its
//     16-byte loads of the row before it uses any, so the row is in flight
//     at once, and keeps them in registers: the output is formed from the
//     registers (no second read of the row), with scale read as float4s.
//     Threads past the row's last 16-byte chunk (D = 896 and 960 do not
//     fill every lane's last load) are masked;
//   - CTA (wider rows, or D not a multiple of 16 bytes): one CTA of 128
//     threads per row reads the row with 16-byte loads where D allows,
//     reduces through shared memory, and reads its own entries again for
//     the second pass (from L1/L2).  D has no upper limit.
// Any N >= 1 (the last CTA of the rows path masks its missing rows), and
// D need not be a power of two (qwen2-0.5b: 896, smollm-360m: 960), unlike
// the TPU kernel whose wrapper asserts N % 256 == 0.
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
// What the design does about it: read x and g once, and keep enough of
// them in flight.  On the rows path (D a whole number of 16-byte chunks,
// at most 4 chunks a lane over 8 warps: D <= 8192 in bf16, 4096 in f32) a
// CTA of 8 warps takes 32 rows, and a group of P warps (the fewest that
// hold a row in 4 chunks a lane: one warp at D = 960 bf16, two at 2048)
// owns one row at a time: all its 16-byte loads of x and g are issued
// before any is used, the row's two sums are taken with shuffles (and one
// shared-memory exchange between a group's warps), and dx is formed from
// the registers and written once.  A thread's columns are the same for
// every row it takes, so its part of g*xhat stays in registers across its
// rows; the groups' sums are added in shared memory in a fixed order at
// the end.  Scale is read once per CTA, as float4s, into shared memory.
// The general path (any other D or alignment) takes two passes: a warp per
// row for the row's sums, then column-owning threads walk the rows again
// (from L2).
// Any N >= 1 (the last CTA takes the ragged rest).
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kRowWarps = 8;        // rows a CTA of the rows path takes at large N
constexpr int kSmallWarps = 4;      // warps a row takes at small N
constexpr int kMaxRowChunks = 16;   // 16-byte chunks of the row a lane holds at large N
constexpr int kSms = 132;           // the H100's SMs

// the rows path: the row in registers.  Large N: one warp per row, eight
// rows a CTA.  Small N (kSmall): one row a CTA of kSmallWarps warps, and
// each thread's scale entries are loaded with its row chunks, before the
// reduction: a lone row's bytes come from device memory (the serve path's
// scale rows are cold there), and four warps keep more of them in flight
// than one, and wait for one round trip, not two.
template <typename T, int NCH, bool kSmall>
__global__ void __launch_bounds__(kRowWarps * 32)
rmsnorm_fwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        T* __restrict__ y, int n, int d, float eps) {
  constexpr int kV = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int kS4 = kV / 4;               // float4s of scale per chunk
  constexpr int kT = kSmall ? 32 * kSmallWarps : 32;   // threads per row
  const int r = threadIdx.x % kT;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kT) + threadIdx.x / kT;
  if (row >= n) return;
  const int nch = d / kV;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
  const float4* sv = reinterpret_cast<const float4*>(scale);
  uint4 raw[NCH];
  float4 sc[kSmall ? NCH * kS4 : 1];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int c = r + kT * k;
    raw[k] = c < nch ? xv[c] : make_uint4(0u, 0u, 0u, 0u);
  }
  if constexpr (kSmall) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = r + kT * k;
#pragma unroll
      for (int q = 0; q < kS4; ++q)
        sc[k * kS4 + q] = c < nch ? sv[c * kS4 + q] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const T* e = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const float f = to_f32<T>(e[j]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  if constexpr (kSmall) {
    __shared__ float partial[kSmallWarps];
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < kSmallWarps; ++w) ss += partial[w];
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  uint4* yv = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int c = r + kT * k;
    if (c < nch) {
      const T* a = reinterpret_cast<const T*>(&raw[k]);
      uint4 out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int q = 0; q < kS4; ++q) {
        const float4 s4 = kSmall ? sc[k * kS4 + q] : sv[c * kS4 + q];
        e[4 * q] = from_f32<T>(to_f32<T>(a[4 * q]) * inv * s4.x);
        e[4 * q + 1] = from_f32<T>(to_f32<T>(a[4 * q + 1]) * inv * s4.y);
        e[4 * q + 2] = from_f32<T>(to_f32<T>(a[4 * q + 2]) * inv * s4.z);
        e[4 * q + 3] = from_f32<T>(to_f32<T>(a[4 * q + 3]) * inv * s4.w);
      }
      yv[c] = out;
    }
  }
}

// The rows path's launch: small N (fewer rows than two large-N CTAs a SM)
// takes a CTA a row, large N eight rows a CTA; NCH covers the row's chunks.
template <typename T, bool kSmall>
void launch_rows(const T* x, const float* scale, T* y, int n, int d, float eps,
                 cudaStream_t stream) {
  constexpr int kT = kSmall ? 32 * kSmallWarps : 32;
  const int per = (d / (16 / static_cast<int>(sizeof(T))) + kT - 1) / kT;
  const int threads = kSmall ? kT : kRowWarps * 32;
  const int blocks = kSmall ? n : (n + kRowWarps - 1) / kRowWarps;
  if (per <= 1) {
    rmsnorm_fwd_rows_kernel<T, 1, kSmall><<<blocks, threads, 0, stream>>>(x, scale, y, n, d, eps);
  } else if (per <= 2) {
    rmsnorm_fwd_rows_kernel<T, 2, kSmall><<<blocks, threads, 0, stream>>>(x, scale, y, n, d, eps);
  } else if (per <= 4) {
    rmsnorm_fwd_rows_kernel<T, 4, kSmall><<<blocks, threads, 0, stream>>>(x, scale, y, n, d, eps);
  } else if constexpr (!kSmall) {  // a small-N row is at most 4 chunks a thread
    if (per <= 8)
      rmsnorm_fwd_rows_kernel<T, 8, false><<<blocks, threads, 0, stream>>>(x, scale, y, n, d, eps);
    else
      rmsnorm_fwd_rows_kernel<T, 16, false><<<blocks, threads, 0, stream>>>(x, scale, y, n, d, eps);
  }
}

// the CTA path: one CTA per row, any D
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

// path: 1 = rows (the caller checked that d fits it), 0 = CTA
template <typename T>
int launch(const void* x, const float* scale, void* y, int n, int d, float eps, int path,
           cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (path == 1) {
    if (d % kV != 0 || d / kV > 32 * kMaxRowChunks) return static_cast<int>(cudaErrorInvalidValue);
    if (n >= 2 * kSms * kRowWarps)
      launch_rows<T, false>(xt, scale, yt, n, d, eps, stream);
    else
      launch_rows<T, true>(xt, scale, yt, n, d, eps, stream);
  } else if (d % kV == 0) {
    rmsnorm_fwd_kernel<T, true><<<n, kThreads, 0, stream>>>(xt, scale, yt, d, eps);
  } else {
    rmsnorm_fwd_kernel<T, false><<<n, kThreads, 0, stream>>>(xt, scale, yt, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBwdRows = 32;        // rows per CTA (kernels/rmsnorm.py: BWD_BLOCK_ROWS)
constexpr int kBwdThreads = 256;    // the rows path's CTA: 8 warps
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdChunks = 4;       // 16-byte chunks of a row a lane holds, at most
constexpr int kBwdMaxGroup = 8;     // warps a row takes, at most

// Named barrier `id` (1..15) over the `count` threads of one group.
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// The rows path: groups of P warps, G = 8 / P groups a CTA, each group
// owning one row at a time (rows grp, grp + G, ... of the CTA's kBwdRows).
// A thread t of a group owns the row's 16-byte chunks t + 32P*k, k < NCH,
// the same columns for every row it takes.  Every x and g load of the row
// is issued before any is used; the sums of x^2 and g*s*x are taken with
// shuffles and, for P > 1, one exchange through shared memory on the
// group's named barrier; dx is formed from the registers and written once,
// and g*xhat is added into registers that stay with the thread across its
// rows.  At the end the
// groups' sums are added in shared memory in group order (no atomics) and
// written as the CTA's row of partials.  Scale is read once per CTA into
// shared memory, as float4s.  Dynamic shared memory: G * d floats, the
// scale row first, then the groups' partials over it once every row is
// done (at most 32 KB: d <= 32P * kBwdChunks * kV).
template <typename T, int NCH, int P>
__global__ void __launch_bounds__(kBwdThreads, 2)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const T* __restrict__ g, T* __restrict__ dx,
                        float* __restrict__ part, int n, int d, float eps) {
  extern __shared__ float4 smem4[];           // scale [d], then partials [G][d]
  __shared__ float xch[2][kBwdWarps][2];      // P > 1: each warp's two sums
  constexpr int kV = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int kS4 = kV / 4;                 // float4s of scale per chunk
  constexpr int G = kBwdWarps / P;
  constexpr int kT = 32 * P;                  // threads per row
  const int warp = threadIdx.x >> 5;
  const int grp = warp / P;
  const int t = threadIdx.x % kT;
  const int row0 = blockIdx.x * kBwdRows;
  const int rows = min(kBwdRows, n - row0);
  const int nch = d / kV;
  const float inv_d = 1.f / static_cast<float>(d);

  const float4* sv = reinterpret_cast<const float4*>(scale);
  for (int i = threadIdx.x; i < d / 4; i += kBwdThreads) smem4[i] = sv[i];

  float acc[NCH * kV];
#pragma unroll
  for (int j = 0; j < NCH * kV; ++j) acc[j] = 0.f;
  __syncthreads();                            // the scale row is in

  int it = 0;
  for (int r = grp; r < rows; r += G, ++it) {
    const int64_t off = static_cast<int64_t>(row0 + r) * nch;
    const uint4* xv = reinterpret_cast<const uint4*>(x) + off;
    const uint4* gv = reinterpret_cast<const uint4*>(g) + off;
    uint4 xr[NCH], gr[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = t + kT * k;
      xr[k] = c < nch ? xv[c] : make_uint4(0u, 0u, 0u, 0u);
      gr[k] = c < nch ? gv[c] : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f, gsx = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = min(t + kT * k, nch - 1);   // masked chunks hold zeros
      const T* xe = reinterpret_cast<const T*>(&xr[k]);
      const T* ge = reinterpret_cast<const T*>(&gr[k]);
#pragma unroll
      for (int q = 0; q < kS4; ++q) {
        const float4 s4 = smem4[c * kS4 + q];
        const float sq[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xf = to_f32<T>(xe[4 * q + j]);
          ss += xf * xf;
          gsx += to_f32<T>(ge[4 * q + j]) * sq[j] * xf;
        }
      }
    }
    ss = warp_sum(ss);
    gsx = warp_sum(gsx);
    if constexpr (P > 1) {
      // slot it & 1: a warp writes slot s again only after the group's
      // next barrier, which every warp reaches after reading slot s
      float(*slot)[2] = xch[it & 1];
      if ((threadIdx.x & 31) == 0) {
        slot[warp][0] = ss;
        slot[warp][1] = gsx;
      }
      group_sync(1 + grp, kT);
      ss = 0.f;
      gsx = 0.f;
#pragma unroll
      for (int w = 0; w < P; ++w) {
        ss += slot[grp * P + w][0];
        gsx += slot[grp * P + w][1];
      }
    }
    const float inv = rsqrtf(ss * inv_d + eps);
    const float mean = inv * gsx * inv_d;       // mean(g*s*xhat)
    uint4* dv = reinterpret_cast<uint4*>(dx) + off;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = t + kT * k;
      if (c < nch) {
        const T* xe = reinterpret_cast<const T*>(&xr[k]);
        const T* ge = reinterpret_cast<const T*>(&gr[k]);
        uint4 out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int q = 0; q < kS4; ++q) {
          const float4 s4 = smem4[c * kS4 + q];
          const float sq[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = 4 * q + j;
            const float xh = to_f32<T>(xe[e]) * inv;
            const float gf = to_f32<T>(ge[e]);
            oe[e] = from_f32<T>(inv * (gf * sq[j] - xh * mean));
            acc[k * kV + e] += gf * xh;
          }
        }
        dv[c] = out;
      }
    }
  }

  // the CTA's row of dscale partials: the groups' sums in group order
  float4* pv = reinterpret_cast<float4*>(part + static_cast<int64_t>(blockIdx.x) * d);
  if constexpr (G == 1) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = t + kT * k;
      if (c < nch) {
#pragma unroll
        for (int q = 0; q < kS4; ++q) {
          const float* a = acc + k * kV + 4 * q;
          pv[c * kS4 + q] = make_float4(a[0], a[1], a[2], a[3]);
        }
      }
    }
  } else {
    __syncthreads();                          // the scale row is done with
    float4* red = smem4 + static_cast<int64_t>(grp) * (d / 4);
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = t + kT * k;
      if (c < nch) {
#pragma unroll
        for (int q = 0; q < kS4; ++q) {
          const float* a = acc + k * kV + 4 * q;
          red[c * kS4 + q] = make_float4(a[0], a[1], a[2], a[3]);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < d / 4; i += kBwdThreads) {
      float4 sum = smem4[i];
#pragma unroll
      for (int w = 1; w < G; ++w) {
        const float4 v = smem4[w * (d / 4) + i];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      pv[i] = sum;
    }
  }
}

// The general path: any d, and rows too wide for the rows path.  One CTA
// of kBwdGenThreads per kBwdRows rows: a warp per row forms the row's inv
// and mean(g*s*xhat) into shared memory, then each thread owns a run of
// columns and walks the rows (x and g read again, from L2), writing dx and
// one partial per column.
constexpr int kBwdGenThreads = 128;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kBwdGenThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ part, int n, int d, float eps) {
  __shared__ float inv_s[kBwdRows];
  __shared__ float mean_s[kBwdRows];     // mean(g*s*xhat) of the row
  constexpr int kV = 16 / sizeof(T);
  constexpr int kWarps = kBwdGenThreads / 32;
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
    for (int c = threadIdx.x; c < d / kV; c += kBwdGenThreads) {
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
    for (int c = threadIdx.x; c < d; c += kBwdGenThreads) {
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

// The rows path's launch for group width P: NCH covers the row's chunks.
template <typename T, int P>
void launch_bwd_rows(const T* x, const float* scale, const T* g, T* dx, float* part,
                     int n, int d, float eps, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int per = (d / kV + 32 * P - 1) / (32 * P);
  const int nb = (n + kBwdRows - 1) / kBwdRows;
  const size_t smem = static_cast<size_t>(kBwdWarps / P) * d * sizeof(float);
  if (per <= 1)
    rmsnorm_bwd_rows_kernel<T, 1, P><<<nb, kBwdThreads, smem, stream>>>(
        x, scale, g, dx, part, n, d, eps);
  else if (per <= 2)
    rmsnorm_bwd_rows_kernel<T, 2, P><<<nb, kBwdThreads, smem, stream>>>(
        x, scale, g, dx, part, n, d, eps);
  else
    rmsnorm_bwd_rows_kernel<T, kBwdChunks, P><<<nb, kBwdThreads, smem, stream>>>(
        x, scale, g, dx, part, n, d, eps);
}

// Warps a row takes on the rows path: the fewest that hold the row in
// kBwdChunks chunks a lane; 0 when even kBwdMaxGroup warps do not.
int bwd_group(int nch) {
  for (int p = 1; p <= kBwdMaxGroup; p *= 2)
    if (nch <= 32 * p * kBwdChunks) return p;
  return 0;
}

template <typename T>
void launch_bwd(const void* xp, const float* scale, const void* gp, void* dxp,
                float* part, int n, int d, float eps, int vec, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xp);
  const T* g = static_cast<const T*>(gp);
  T* dx = static_cast<T*>(dxp);
  const int p = vec && d % kV == 0 ? bwd_group(d / kV) : 0;
  switch (p) {
    case 1: launch_bwd_rows<T, 1>(x, scale, g, dx, part, n, d, eps, stream); return;
    case 2: launch_bwd_rows<T, 2>(x, scale, g, dx, part, n, d, eps, stream); return;
    case 4: launch_bwd_rows<T, 4>(x, scale, g, dx, part, n, d, eps, stream); return;
    case 8: launch_bwd_rows<T, 8>(x, scale, g, dx, part, n, d, eps, stream); return;
    default: break;
  }
  const int nb = (n + kBwdRows - 1) / kBwdRows;
  auto kernel = vec && d % kV == 0 ? rmsnorm_bwd_kernel<T, true> : rmsnorm_bwd_kernel<T, false>;
  kernel<<<nb, kBwdGenThreads, 0, stream>>>(x, scale, g, dx, part, n, d, eps);
}

}  // namespace
}  // namespace repro_torch

// x, y: [n, d] contiguous, storage type `dtype`, 16-byte aligned; scale:
// [d] f32, 16-byte aligned.  `path`: 1 the rows path (d a multiple of 16
// bytes, at most kMaxRowChunks 16-byte chunks a lane), 0 the CTA path (any
// d): kernels/rmsnorm.py::rmsnorm_fwd_path.  Returns cudaGetLastError()
// after the launch.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* scale, void* y,
                                 int n, int d, float eps, int dtype, int path,
                                 void* stream) {
  using namespace repro_torch;
  if (n < 1 || d < 1 || (path != 0 && path != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  switch (dtype) {
    case kF32: return launch<float>(x, sc, y, n, d, eps, path, s);
    case kBF16: return launch<__nv_bfloat16>(x, sc, y, n, d, eps, path, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, g, dx: [n, d] contiguous, storage type `dtype`; scale: [d] f32;
// part: [ceil(n / rows_per_block), d] f32, one row per CTA.
// `rows_per_block` must equal kBwdRows (the caller's BWD_BLOCK_ROWS).
// `vec` != 0: x, g, dx, part and scale are 16-byte aligned, so a d that is
// a whole number of 16-byte chunks takes the rows path (up to kBwdMaxGroup
// warps a row of kBwdChunks chunks a lane) and any other d the general
// path's 16-byte loads where d allows.
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

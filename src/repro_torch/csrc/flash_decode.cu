// flash_decode for Hopper: one query token per sequence against a KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::flash_decode
// (_fd_kernel; pallas_call at decode_attention.py:80) and computes what
// _fd_kernel computes: q scaled by 1/sqrt(hd) in f32; f32 running max m,
// denominator l and accumulator; keys at positions >= length masked to
// -1e30; l floored at 1e-30; key blocks wholly past length skipped.
//
// What bounds it on the H100: bytes.  Per (sequence, KV head) it reads
// length*hd keys and values once and does 4*G*hd flops per key — with
// G=7, hd=64 and bf16 that is ~3.5 flops per byte, far under the ~295 the
// tensor cores need — so the least time is the K/V bytes of the valid
// positions over 3.35 TB/s.
//
// What the design does about it: the TPU grid (B, KVH, S/block_k) walks
// its last axis sequentially, carrying m/l/acc in VMEM scratch; here one
// CTA of 256 threads per (sequence, KV head) walks the keys in a loop
// inside the block, tiles of kBK keys at a time (16-byte loads, one memory
// round trip per tile), and carries m/l in shared memory and acc in
// registers.  All G query heads of the KV head
// share each K/V tile loaded into shared memory, so K/V are read once and
// never repeated per query head; G may be odd (qwen2-0.5b: G=7).  The loop
// stops at the last tile holding a valid key, so the bytes read follow
// each sequence's length, not S, and S need not be a multiple of the tile.
// Known limit of this first version: B*KVH CTAs (16 at 8 lanes of
// qwen2-0.5b) fill few of the 132 SMs; a split-S pass with a combine step
// is the planned fix.
#include <cmath>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;       // keys per tile: one key per lane in the softmax
constexpr int kAcc = 8;       // accumulators per thread: G*hd <= kThreads*kAcc
constexpr float kNegInf = -1e30f;

// Shared-memory layout, in floats.
__host__ __device__ inline int smem_floats(int G, int hd) {
  return G * hd                // qs: scaled q, [G][hd]
         + kBK * (hd + 1)      // ks: K tile, rows padded by one (no bank conflicts)
         + kBK * hd            // vs: V tile
         + G * kBK             // ps: scores, then probabilities
         + 3 * G;              // m, l, corr per query head
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int S, int H, int KVH, int hd,
                    float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* qs = smem;
  float* ks = qs + G * hd;
  float* vs = ks + kBK * (hd + 1);
  float* ps = vs + kBK * hd;
  float* m_s = ps + G * kBK;
  float* l_s = m_s + G;
  float* corr_s = l_s + G;

  int length = lengths[b];
  length = length < 0 ? 0 : (length > S ? S : length);

  // q rows of this KV head's group: head h = kvh*G + g (q.reshape(B,KVH,G,hd)).
  const T* qb = q + (static_cast<int64_t>(b) * H + static_cast<int64_t>(kvh) * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) qs[i] = to_f32<T>(qb[i]) * scale;
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
  __syncthreads();

  const int64_t row_stride = static_cast<int64_t>(KVH) * hd;  // between positions
  const T* kb = k + static_cast<int64_t>(b) * S * row_stride + static_cast<int64_t>(kvh) * hd;
  const T* vb = v + static_cast<int64_t>(b) * S * row_stride + static_cast<int64_t>(kvh) * hd;
  const int n_tiles = (length + kBK - 1) / kBK;   // skip tiles wholly past length

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // K/V tile -> shared memory (f32).  Rows past S are zero; rows past
    // length but inside S are loaded and masked below.  With kVec each
    // thread moves 16 bytes of K and of V per load (one load each per
    // tile for bf16 at hd=64), so a tile costs one memory round trip.
    if (kVec) {
      constexpr int kV = 16 / sizeof(T);
      const int vpr = hd / kV;                 // 16-byte vectors per row
      for (int i = tid; i < kBK * vpr; i += kThreads) {
        const int j = i / vpr, c = (i - j * vpr) * kV;
        const int pos = k0 + j;
        uint4 kraw = make_uint4(0u, 0u, 0u, 0u), vraw = kraw;
        if (pos < S) {
          kraw = *reinterpret_cast<const uint4*>(kb + pos * row_stride + c);
          vraw = *reinterpret_cast<const uint4*>(vb + pos * row_stride + c);
        }
        const T* ke = reinterpret_cast<const T*>(&kraw);
        const T* ve = reinterpret_cast<const T*>(&vraw);
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          ks[j * (hd + 1) + c + e] = to_f32<T>(ke[e]);
          vs[j * hd + c + e] = to_f32<T>(ve[e]);
        }
      }
    } else {
      for (int i = tid; i < kBK * hd; i += kThreads) {
        const int j = i / hd, c = i - j * hd;
        const int pos = k0 + j;
        float kv = 0.f, vv = 0.f;
        if (pos < S) {
          kv = to_f32<T>(kb[pos * row_stride + c]);
          vv = to_f32<T>(vb[pos * row_stride + c]);
        }
        ks[j * (hd + 1) + c] = kv;
        vs[j * hd + c] = vv;
      }
    }
    __syncthreads();

    // scores s[g][j] = q_g . k_j, masked past length
    for (int i = tid; i < G * kBK; i += kThreads) {
      const int g = i / kBK, j = i - g * kBK;
      const float* qg = qs + g * hd;
      const float* kj = ks + j * (hd + 1);
      float s = 0.f;
      for (int c = 0; c < hd; ++c) s = fmaf(qg[c], kj[c], s);
      ps[i] = (k0 + j < length) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query head, one key per lane
    for (int g = warp; g < G; g += kWarps) {
      const float s = ps[g * kBK + lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float psum = warp_sum(p);
      ps[g * kBK + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // acc[g][c] = acc[g][c]*corr[g] + sum_j p[g][j] * v[j][c]
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int o = tid + a * kThreads;
      if (o < G * hd) {
        const int g = o / hd, c = o - g * hd;
        const float* pg = ps + g * kBK;
        float r = acc[a] * corr_s[g];
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) r = fmaf(pg[j], vs[j * hd + c], r);
        acc[a] = r;
      }
    }
    __syncthreads();   // the next tile overwrites ks/vs/ps/corr
  }

  T* ob = out + (static_cast<int64_t>(b) * H + static_cast<int64_t>(kvh) * G) * hd;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int o = tid + a * kThreads;
    if (o < G * hd) {
      const int g = o / hd;
      ob[o] = from_f32<T>(acc[a] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* lengths,
            void* out, int B, int S, int H, int KVH, int hd, int vec,
            size_t smem, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  dim3 grid(KVH, B);
  auto kernel = vec ? flash_decode_kernel<T, true> : flash_decode_kernel<T, false>;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, H, KVH, hd,
      scale);
}

}  // namespace
}  // namespace repro_torch

// q: [B, H, hd]; k, v: [B, S, KVH, hd]; out: [B, H, hd], all contiguous and
// of storage type `dtype`; lengths: [B] int32 on the device.  `vec` != 0
// selects 16-byte K/V loads (the caller checked hd and alignment).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, int B, int S,
                                  int H, int KVH, int hd, int dtype, int vec,
                                  void* stream) {
  using namespace repro_torch;
  if (B < 1 || S < 1 || KVH < 1 || hd < 1 || H % KVH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = H / KVH;
  const size_t smem = static_cast<size_t>(smem_floats(G, hd)) * sizeof(float);
  if (G * hd > kThreads * kAcc || smem > 48 * 1024 || KVH > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  switch (dtype) {
    case kF32: launch<float>(q, k, v, len, out, B, S, H, KVH, hd, vec, smem, s); break;
    case kBF16:
      launch<__nv_bfloat16>(q, k, v, len, out, B, S, H, KVH, hd, vec, smem, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// flash_decode for Hopper: one query token per sequence against a KV cache,
// split over the keys.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::flash_decode
// (_fd_kernel; pallas_call at decode_attention.py:80) and computes what
// _fd_kernel computes: q scaled by 1/sqrt(hd) in f32; f32 max m,
// denominator l and accumulator; keys at positions >= length masked to
// -1e30; l floored at 1e-30; keys past length never read.  With a logit
// cap (grok-1; the JAX models' L.decode_attention applies it, the Pallas
// kernel has none) each valid score s becomes tanh(s/cap)*cap before the
// softmax; the cap is a template flag, so cap 0 runs the uncapped code.
//
// What bounds it on the H100: bytes.  Per (sequence, KV head) it reads
// length*hd keys and values once and does 4*G*hd flops per key; with G=7,
// hd=64 and bf16 that is ~3.5 flops per byte, far under the ~295 the
// tensor cores need, so the least time is the K/V bytes of the valid
// positions over 3.35 TB/s.  At the serve shape (8 sequences, 2 KV heads,
// ~4k valid keys) that is under a microsecond: in practice the floor is
// the launch and one round trip to memory.
//
// What the design does about it: the TPU grid (B, KVH, S/block_k) walks
// its last axis in order, carrying m/l/acc in VMEM.  Here the keys are
// split over CTAs instead, so that many round trips to memory are in
// flight at once: the grid is (splits, KVH, B), each CTA owns split_keys
// consecutive keys (the split count is a function of B, KVH and S alone,
// kernels/decode_attention.py::decode_split_keys, so no length is read on
// the host), and a CTA whose range starts at or past length writes an
// empty partial (m = -1e30, l = 0) and returns.  Inside a CTA the keys go
// in tiles of kBK: the tile's K and V rows stay in their storage type in
// shared memory, copied with 16-byte cp.async (each thread has several
// keys in flight); each thread dots one K row with up to four of the G
// query heads per pass (G <= 8 at one pass: each K row is read once for
// all of them); one warp per head runs the online softmax; the P.V sums
// go to registers.  The partials (f32 acc [B, KVH, splits, G, hd], m and
// l [B, KVH, splits, G]) go to scratch the wrapper allocates, and a second
// launch combines them, one thread per output entry: m = max over splits,
// acc and l weighted by exp(m_s - m), empty splits skipped (so they cannot
// turn into NaN), l floored at 1e-30; a sequence with no valid key gives zeros.  With one
// split the first launch writes the output itself.  Any S and any G
// (odd G included: qwen2-0.5b has G = 7).
#include <cmath>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;          // keys per tile: two per lane in the softmax
constexpr int kHeadsPerPass = 4; // query heads a thread dots with one K row
constexpr int kSlots = 16;       // accumulators per thread: G*hd <= kThreads*kSlots
constexpr float kNegInf = -1e30f;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Shared-memory layout in bytes: K and V tiles [kBK][ld] in the storage
// type, rows padded by 16 bytes (the score pass reads 16 bytes a thread
// from rows kBK apart without bank conflicts); scaled q [G][hd] f32;
// scores [G][kBK] f32; m, l and corr [G] f32.
struct Layout {
  int ld;
  size_t k, v, q, s, m, l, c, total;
};

template <typename T>
__host__ __device__ inline Layout layout_for(int G, int hd) {
  Layout L;
  L.ld = hd + 16 / static_cast<int>(sizeof(T));
  size_t off = 0;
  L.k = off; off = align16(off + sizeof(T) * kBK * L.ld);
  L.v = off; off = align16(off + sizeof(T) * kBK * L.ld);
  L.q = off; off = align16(off + sizeof(float) * G * hd);
  L.s = off; off = align16(off + sizeof(float) * G * kBK);
  L.m = off; off += sizeof(float) * G;
  L.l = off; off += sizeof(float) * G;
  L.c = off; off += sizeof(float) * G;
  L.total = align16(off);
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// 8 storage elements (16 bytes) of a row as f32
template <typename T>
__device__ __forceinline__ void widen16(const T* p, float* out);
template <>
__device__ __forceinline__ void widen16<float>(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(const __nv_bfloat16* p, float* out) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// One CTA per (split, KV head, sequence): m, l and the unnormalised acc of
// its keys' softmax for the G query heads, into the partials; or, with
// one split (part_acc == nullptr), the normalised output itself.
template <typename T, bool kVec, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ lengths,
                          T* __restrict__ out, float* __restrict__ part_acc,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          int S, int H, int KVH, int hd, int split_keys, float scale,
                          float cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int splits = gridDim.x;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Layout L = layout_for<T>(G, hd);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* c_s = reinterpret_cast<float*>(smem + L.c);

  int length = lengths[b];
  length = length < 0 ? 0 : (length > S ? S : length);
  const int k_begin = split * split_keys;
  const int k_end = min(length, k_begin + split_keys);
  const int64_t group = static_cast<int64_t>(b) * KVH + kvh;      // (b, kvh)
  const int64_t part = group * splits + split;                    // (b, kvh, split)
  T* ob = out + (static_cast<int64_t>(b) * H + static_cast<int64_t>(kvh) * G) * hd;

  if (k_begin >= k_end) {                    // no valid key in this range
    if (part_acc == nullptr) {
      for (int i = tid; i < G * hd; i += kThreads) ob[i] = from_f32<T>(0.f);
    } else {
      for (int g = tid; g < G; g += kThreads) {
        part_m[part * G + g] = kNegInf;
        part_l[part * G + g] = 0.f;
      }
    }
    return;
  }

  const int64_t row_stride = static_cast<int64_t>(KVH) * hd;   // between positions
  const T* kb = k + static_cast<int64_t>(b) * S * row_stride + static_cast<int64_t>(kvh) * hd;
  const T* vb = v + static_cast<int64_t>(b) * S * row_stride + static_cast<int64_t>(kvh) * hd;
  constexpr int kV = 16 / sizeof(T);       // storage elements in 16 bytes
  // K/V rows k0 .. k0+nv-1 -> shared memory, in the storage type (rows past
  // nv are neither read nor used); with kVec as cp.async copies that the
  // caller waits for
  auto load_kv = [&](int k0, int nv) {
    if constexpr (kVec) {
      const int vpr = hd / kV;
      for (int i = tid; i < nv * vpr; i += kThreads) {
        const int j = i / vpr, c = (i - j * vpr) * kV;
        const int64_t g_off = static_cast<int64_t>(k0 + j) * row_stride + c;
        cp_async16(ks + j * L.ld + c, kb + g_off);
        cp_async16(vs + j * L.ld + c, vb + g_off);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      for (int i = tid; i < nv * hd; i += kThreads) {
        const int j = i / hd, c = i - j * hd;
        const int64_t g_off = static_cast<int64_t>(k0 + j) * row_stride + c;
        ks[j * L.ld + c] = kb[g_off];
        vs[j * L.ld + c] = vb[g_off];
      }
    }
  };
  // the first tile's copies are in flight while q is read
  load_kv(k_begin, min(kBK, k_end - k_begin));

  // q rows of this KV head's group: head h = kvh*G + g (q.reshape(B,KVH,G,hd)).
  const T* qb = q + (static_cast<int64_t>(b) * H + static_cast<int64_t>(kvh) * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) qs[i] = to_f32<T>(qb[i]) * scale;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kSlots];
#pragma unroll
  for (int a = 0; a < kSlots; ++a) acc[a] = 0.f;

  // output items a thread owns: column pairs with kVec, single columns else
  constexpr int kPer = kVec ? 2 : 1;
  const int items = G * hd / kPer;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int nv = min(kBK, k_end - k0);   // valid keys of this tile
    if (k0 != k_begin) load_kv(k0, nv);
    if constexpr (kVec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // scores s[g][j] = q_g . k_j: thread (j = tid % kBK) dots K row j with
    // heads g = tid / kBK + 2n, kHeadsPerPass of them per pass
    {
      const int j = tid % kBK;
      const int g_first = tid / kBK;
      constexpr int kStep = kThreads / kBK;
      for (int g0 = g_first; g0 < G; g0 += kStep * kHeadsPerPass) {
        float dot[kHeadsPerPass];
#pragma unroll
        for (int n = 0; n < kHeadsPerPass; ++n) dot[n] = 0.f;
        if (j < nv) {
          const T* krow = ks + j * L.ld;
          if constexpr (kVec) {
#pragma unroll 4
            for (int c = 0; c < hd; c += kV) {
              float kf[kV];
              widen16<T>(krow + c, kf);
#pragma unroll
              for (int n = 0; n < kHeadsPerPass; ++n) {
                const int g = g0 + n * kStep;
                if (g < G) {
                  const float* qg = qs + g * hd + c;   // broadcast in the warp
#pragma unroll
                  for (int e = 0; e < kV; ++e) dot[n] = fmaf(qg[e], kf[e], dot[n]);
                }
              }
            }
          } else {
            for (int c = 0; c < hd; ++c) {
              const float kf = to_f32<T>(krow[c]);
#pragma unroll
              for (int n = 0; n < kHeadsPerPass; ++n) {
                const int g = g0 + n * kStep;
                if (g < G) dot[n] = fmaf(qs[g * hd + c], kf, dot[n]);
              }
            }
          }
        }
#pragma unroll
        for (int n = 0; n < kHeadsPerPass; ++n) {
          const int g = g0 + n * kStep;
          if constexpr (kCap) dot[n] = tanhf(dot[n] / cap) * cap;
          if (g < G) ss[g * kBK + j] = j < nv ? dot[n] : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, two keys per lane
    for (int g = warp; g < G; g += kWarps) {
      float* sg = ss + g * kBK;
      const float s0 = sg[lane], s1 = sg[lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      sg[lane] = p0;
      sg[lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc[g][c] = acc[g][c]*corr[g] + sum_j p[g][j] * v[j][c]
#pragma unroll
    for (int a = 0; a < kSlots / kPer; ++a) {
      const int it = tid + a * kThreads;
      if (it < items) {
        const int o = it * kPer;
        const int g = o / hd, c = o - g * hd;
        const float* pg = ss + g * kBK;
        const float corr = c_s[g];
        const T* vc = vs + c;
        if constexpr (kPer == 2) {
          float r0 = acc[2 * a] * corr, r1 = acc[2 * a + 1] * corr;
#pragma unroll 8
          for (int j = 0; j < nv; ++j) {
            const float p = pg[j];
            float2 vv;
            if constexpr (sizeof(T) == 2) {
              vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vc + j * L.ld));
            } else {
              vv = *reinterpret_cast<const float2*>(vc + j * L.ld);
            }
            r0 = fmaf(p, vv.x, r0);
            r1 = fmaf(p, vv.y, r1);
          }
          acc[2 * a] = r0;
          acc[2 * a + 1] = r1;
        } else {
          float r0 = acc[a] * corr;
          for (int j = 0; j < nv; ++j) r0 = fmaf(pg[j], to_f32<T>(vc[j * L.ld]), r0);
          acc[a] = r0;
        }
      }
    }
    __syncthreads();   // the next tile overwrites ks/vs/ss/corr
  }

#pragma unroll
  for (int a = 0; a < kSlots / kPer; ++a) {
    const int it = tid + a * kThreads;
    if (it < items) {
      const int o = it * kPer;
      const int g = o / hd;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (part_acc == nullptr) {
          ob[o + e] = from_f32<T>(acc[kPer * a + e] / fmaxf(l_s[g], 1e-30f));
        } else {
          part_acc[part * G * hd + o + e] = acc[kPer * a + e];
        }
      }
    }
  }
  if (part_acc != nullptr) {
    for (int g = tid; g < G; g += kThreads) {
      part_m[part * G + g] = m_s[g];
      part_l[part * G + g] = l_s[g];
    }
  }
}

// One thread per output entry (b, h, c): out = sum_s w_s acc_s / max(sum_s
// w_s l_s, 1e-30), w_s = exp(m_s - max_s m_s) over the splits that saw a
// key, in one online pass whose loads do not depend on each other.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_m,
                            const float* __restrict__ part_l, T* __restrict__ out,
                            int B, int H, int KVH, int hd, int splits) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * H * hd) return;
  const int G = H / KVH;
  const int64_t bh = idx / hd;                     // b * H + h
  const int c = static_cast<int>(idx - bh * hd);
  const int h = static_cast<int>(bh % H);
  const int64_t group = bh / H * KVH + h / G;      // b * KVH + kvh
  const int g = h % G;
  const float* pm = part_m + group * splits * G + g;
  const float* pl = part_l + group * splits * G + g;
  const float* pa = part_acc + group * splits * G * hd + static_cast<int64_t>(g) * hd + c;
  float m = kNegInf, num = 0.f, den = 0.f;
  constexpr int kBatch = 8;     // splits whose partials are loaded at once
  for (int s0 = 0; s0 < splits; s0 += kBatch) {
    float lv[kBatch], mv[kBatch], av[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = min(s0 + u, splits - 1);
      lv[u] = s0 + u < splits ? pl[s * G] : 0.f;
      mv[u] = pm[s * G];
      av[u] = pa[static_cast<int64_t>(s) * G * hd];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (lv[u] > 0.f) {        // an empty split adds nothing (its acc was never written)
        const float m_new = fmaxf(m, mv[u]);
        const float corr = expf(m - m_new), w = expf(mv[u] - m_new);
        den = fmaf(w, lv[u], den * corr);
        num = fmaf(w, av[u], num * corr);
        m = m_new;
      }
    }
  }
  out[idx] = from_f32<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, bool kCap>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* scratch, int B, int S, int H, int KVH, int hd,
           int split_keys, float cap, int vec, cudaStream_t stream) {
  const int G = H / KVH;
  const Layout L = layout_for<T>(G, hd);
  auto kernel = vec ? flash_decode_split_kernel<T, true, kCap>
                    : flash_decode_split_kernel<T, false, kCap>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const int splits = (S + split_keys - 1) / split_keys;
  const int64_t parts = static_cast<int64_t>(B) * KVH * splits * G;
  float* part_acc = splits > 1 ? scratch : nullptr;
  float* part_m = splits > 1 ? scratch + parts * hd : nullptr;
  float* part_l = splits > 1 ? part_m + parts : nullptr;
  kernel<<<dim3(splits, KVH, B), kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(out), part_acc, part_m, part_l, S, H, KVH, hd,
      split_keys, scale, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t outputs = static_cast<int64_t>(B) * H * hd;
  flash_decode_combine_kernel<T><<<static_cast<unsigned>((outputs + kThreads - 1) / kThreads),
                                   kThreads, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(out), B, H, KVH, hd, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q: [B, H, hd]; k, v: [B, S, KVH, hd]; out: [B, H, hd], all contiguous and
// of storage type `dtype`; lengths: [B] int32 on the device.  Keys go to
// ceil(S / split_keys) splits; with more than one, `scratch` holds
// B*KVH*splits*G*(hd + 2) floats of partials (uninitialised is fine).
// `logit_cap` > 0 caps the scaled scores at tanh(s/cap)*cap, 0 takes the
// uncapped kernel.  `vec` != 0 selects 16-byte K/V copies (the caller
// checked hd and alignment).  Returns cudaGetLastError() after the
// launches.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, void* scratch,
                                  int B, int S, int H, int KVH, int hd,
                                  int split_keys, float logit_cap, int dtype, int vec,
                                  void* stream) {
  using namespace repro_torch;
  if (B < 1 || S < 1 || KVH < 1 || hd < 1 || hd > 128 || H % KVH != 0 ||
      split_keys < 1 || KVH > 65535 || B > 65535 || !(logit_cap >= 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = H / KVH;
  const int splits = (S + split_keys - 1) / split_keys;
  if (G * hd > kThreads * kSlots || (splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* scr = static_cast<float*>(scratch);
  const bool capped = logit_cap > 0.f;
  switch (dtype) {
    case kF32:
      return capped ? launch<float, true>(q, k, v, len, out, scr, B, S, H, KVH, hd,
                                          split_keys, logit_cap, vec, s)
                    : launch<float, false>(q, k, v, len, out, scr, B, S, H, KVH, hd,
                                           split_keys, logit_cap, vec, s);
    case kBF16:
      return capped ? launch<__nv_bfloat16, true>(q, k, v, len, out, scr, B, S, H, KVH,
                                                  hd, split_keys, logit_cap, vec, s)
                    : launch<__nv_bfloat16, false>(q, k, v, len, out, scr, B, S, H, KVH,
                                                   hd, split_keys, logit_cap, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// flash_attention (forward) for Hopper: causal or full GQA attention with
// an online softmax, q [B,Sq,H,hd] and k/v [B,Sk,KVH,hd] -> o [B,Sq,H,hd].
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_fa_kernel; pallas_call at flash_attention.py:96) and
// computes what _fa_kernel computes: scores q.k scaled by 1/sqrt(hd) in
// f32; f32 running max m, denominator l and accumulator; scores masked to
// -1e30; l floored at 1e-30; the causal mask aligned bottom-right (query
// i sits at key position i + Sk - Sq, flash_attention.py:43) and key
// tiles wholly above the diagonal skipped (:47-49); the probabilities
// rounded to v's type before the P.V product, as the TPU kernel does.
// Query head h reads KV head h / G (G = H / KVH, odd G included): K and V
// are never repeated in memory.
//
// What bounds it on the H100: operations.  At the training shape of
// smollm-360m (B=8, S=1024, H=15, KVH=5, hd=64, causal, bf16) the two
// products are ~16 GFLOP, ~16 us at 989 TFLOP/s, against ~42 MB of q, k,
// v and o, ~13 us at 3.35 TB/s.
//
// What the design does about it: one CTA of 4 warps per (64-query tile,
// head, sequence); the TPU's sequential kv grid axis becomes a loop over
// 64-key tiles inside the CTA, which stops at the diagonal under `causal`.
// q, k and v tiles are staged in shared memory with 16-byte loads; in
// bf16 both products run on the tensor cores (WMMA m16n16k16, bf16 in,
// f32 out), in f32 on the FMA units (the TPU kernel's f32 dot; TF32 would
// not hold the f32 tolerance).  Each warp owns 16 query rows: their
// scores, softmax statistics and f32 output rows in shared memory; the
// softmax gives two lanes to a row, so its max and sum are one shuffle
// each.  The output rows are rescaled by exp(m_prev - m_new) before each
// P.V product is accumulated into them.  Any Sq and Sk (the ragged edge
// is masked here; the Pallas wrapper asserts Sq % block_q == 0, :89),
// hd <= 128 a multiple of 16.  Query tiles are scheduled in reverse
// order, so under `causal` the longest tiles start first.
// Known limits of this first version: no cp.async/TMA double buffering,
// no wgmma, and the q fragments are reloaded from shared memory per key
// tile.
#include <mma.h>

#include <cmath>

#include "common.cuh"

namespace repro_torch {
namespace {

using namespace nvcuda;

constexpr int kBQ = 64;        // queries per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory layout: byte offsets and row strides (in elements).
struct Layout {
  int ldq, ldk, ldv, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, c, total;
};

template <typename T>
__host__ __device__ inline Layout layout_for(int hd) {
  Layout L;
  constexpr bool kF32 = sizeof(T) == 4;
  // bf16 rows padded by 16 bytes (WMMA needs ldm % 8 == 0 and 32-byte
  // aligned tile starts); f32 K rows padded by one element, so the FMA
  // path's per-lane key reads hit distinct banks.
  L.ldq = kF32 ? hd : hd + 8;
  L.ldk = kF32 ? hd + 1 : hd + 8;
  L.ldv = kF32 ? hd : hd + 8;
  L.lds = kBK + 4;
  L.ldp = kF32 ? kBK + 4 : kBK + 8;
  L.ldo = hd + 4;
  size_t off = 0;
  L.q = off; off = align128(off + sizeof(T) * kBQ * L.ldq);
  L.k = off; off = align128(off + sizeof(T) * kBK * L.ldk);
  L.v = off; off = align128(off + sizeof(T) * kBK * L.ldv);
  L.s = off; off = align128(off + sizeof(float) * kBQ * L.lds);
  L.p = off; off = align128(off + sizeof(T) * kBQ * L.ldp);
  L.o = off; off = align128(off + sizeof(float) * kBQ * L.ldo);
  L.m = off; off += sizeof(float) * kBQ;
  L.l = off; off += sizeof(float) * kBQ;
  L.c = off; off += sizeof(float) * kBQ;
  L.total = align128(off);
  return L;
}

// rows x hd tile of a [*, row_stride] tensor into shared memory [rows][ld];
// rows at or past `valid` are zero.
template <typename T, bool kVec>
__device__ inline void load_tile(T* dst, int ld, const T* src,
                                 int64_t row_stride, int valid, int hd,
                                 int rows) {
  if (kVec) {
    constexpr int kV = 16 / sizeof(T);
    const int vpr = hd / kV;
    for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
      const int r = i / vpr, c = (i - r * vpr) * kV;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      if (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(dst + r * ld + c) = raw;   // ld % 8 == 0
      } else {
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < kV; ++j) dst[r * ld + c + j] = e[j];
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * hd; i += kThreads) {
      const int r = i / hd, c = i - r * hd;
      dst[r * ld + c] = r < valid ? src[r * row_stride + c] : from_f32<T>(0.f);
    }
  }
}

// S[16 rows of this warp][kBK] = Q K^T (unscaled), f32.
__device__ inline void scores(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                              float* ss, const Layout& L, int hd, int warp) {
  for (int n = 0; n < kBK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < hd; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, qs + warp * 16 * L.ldq + kk, L.ldq);
      wmma::load_matrix_sync(b, ks + n * 16 * L.ldk + kk, L.ldk);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(ss + warp * 16 * L.lds + n * 16, acc, L.lds,
                            wmma::mem_row_major);
  }
}

__device__ inline void scores(const float* qs, const float* ks, float* ss,
                              const Layout& L, int hd, int warp) {
  const int lane = threadIdx.x & 31;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  const float* q0 = qs + warp * 16 * L.ldq;
  for (int d = 0; d < hd; ++d) {
    const float k0 = ks[lane * L.ldk + d];
    const float k1 = ks[(lane + 32) * L.ldk + d];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float qv = q0[r * L.ldq + d];      // broadcast
      acc[r][0] = fmaf(qv, k0, acc[r][0]);
      acc[r][1] = fmaf(qv, k1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    ss[(warp * 16 + r) * L.lds + lane] = acc[r][0];
    ss[(warp * 16 + r) * L.lds + lane + 32] = acc[r][1];
  }
}

// O[16 rows of this warp] = O * corr + P V, f32 in shared memory.
__device__ inline void accumulate_pv(const __nv_bfloat16* ps,
                                     const __nv_bfloat16* vs, float* os,
                                     const float* corr, const Layout& L,
                                     int hd, int warp) {
  const int lane = threadIdx.x & 31;
  float* o0 = os + warp * 16 * L.ldo;
  {
    // two lanes per row, as in the softmax
    const float c = corr[warp * 16 + (lane >> 1)];
    float* orow = o0 + (lane >> 1) * L.ldo;
    for (int col = lane & 1; col < hd; col += 2) orow[col] *= c;
  }
  __syncwarp();
  for (int j = 0; j < hd; j += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o0 + j, L.ldo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, ps + warp * 16 * L.ldp + kk, L.ldp);
      wmma::load_matrix_sync(b, vs + kk * L.ldv + j, L.ldv);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o0 + j, acc, L.ldo, wmma::mem_row_major);
  }
}

__device__ inline void accumulate_pv(const float* ps, const float* vs,
                                     float* os, const float* corr,
                                     const Layout& L, int hd, int warp) {
  const int lane = threadIdx.x & 31;
  float* o0 = os + warp * 16 * L.ldo;
  const float* p0 = ps + warp * 16 * L.ldp;
  for (int c = lane; c < hd; c += 32) {
    float o[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) o[r] = o0[r * L.ldo + c] * corr[warp * 16 + r];
    for (int j = 0; j < kBK; ++j) {
      const float vv = vs[j * L.ldv + c];
#pragma unroll
      for (int r = 0; r < 16; ++r) o[r] = fmaf(p0[r * L.ldp + j], vv, o[r]);
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) o0[r * L.ldo + c] = o[r];
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int KVH, int hd, float scale,
                       int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout_for<T>(hd);
  T* qs = reinterpret_cast<T*>(smem + L.q);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  T* ps = reinterpret_cast<T*>(smem + L.p);
  float* os = reinterpret_cast<float*>(smem + L.o);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* c_s = reinterpret_cast<float*>(smem + L.c);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q_stride = static_cast<int64_t>(H) * hd;     // between positions
  const int64_t kv_stride = static_cast<int64_t>(KVH) * hd;
  const T* qb = q + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * hd;
  const T* kb = k + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * hd;
  const T* vb = v + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * hd;

  load_tile<T, kVec>(qs, L.ldq, qb, q_stride, min(kBQ, Sq - q0), hd, kBQ);
  for (int i = tid; i < kBQ * L.ldo; i += kThreads) os[i] = 0.f;
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int shift = Sk - Sq;   // query i sits at key position i + shift
  // causal: the tile's last query sees keys up to q0 + kBQ - 1 + shift
  const int kv_end = causal ? min(Sk, q0 + kBQ + shift) : Sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile's K/V reads are done
    load_tile<T, kVec>(ks, L.ldk, kb + k0 * kv_stride, kv_stride, Sk - k0, hd, kBK);
    load_tile<T, kVec>(vs, L.ldv, vb + k0 * kv_stride, kv_stride, Sk - k0, hd, kBK);
    __syncthreads();

    scores(qs, ks, ss, L, hd, warp);
    __syncwarp();

    // online softmax over this warp's 16 rows: two lanes per row, each
    // over every other key of the tile, so a row's max and sum take one
    // shuffle each (not a 5-step warp reduction per row)
    {
      const int r = warp * 16 + (lane >> 1);
      const int h = lane & 1;
      // keys of this tile the row may see: j < kmax
      int kmax = Sk - k0;
      if (causal) kmax = min(kmax, q0 + r + shift - k0 + 1);
      const float* srow = ss + r * L.lds;
      float sv[kBK / 2];
      float m_loc = kNegInf;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int j = 2 * i + h;
        sv[i] = j < kmax ? srow[j] * scale : kNegInf;
        m_loc = fmaxf(m_loc, sv[i]);
      }
      m_loc = fmaxf(m_loc, __shfl_xor_sync(0xffffffffu, m_loc, 1));
      // both lanes of the row read m_prev before the psum shuffle below,
      // and lane h == 0 writes it only after that shuffle
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_loc);
      T* prow = ps + r * L.ldp;
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const float pv = expf(sv[i] - m_new);
        prow[2 * i + h] = from_f32<T>(pv);
        psum += pv;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      if (h == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncwarp();
    accumulate_pv(ps, vs, os, c_s, L, hd, warp);
  }
  __syncthreads();

  T* ob = out + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * hd;
  const int valid = min(kBQ, Sq - q0);
  for (int i = tid; i < valid * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    ob[r * q_stride + c] = from_f32<T>(os[r * L.ldo + c] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KVH, int hd, int causal, int vec,
           cudaStream_t stream) {
  const Layout L = layout_for<T>(hd);
  auto kernel = vec ? flash_attention_kernel<T, true> : flash_attention_kernel<T, false>;
  // above 48 KB a kernel must opt in to dynamic shared memory (once is
  // enough; setting it again is cheap)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KVH, hd,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q, out: [B, Sq, H, hd]; k, v: [B, Sk, KVH, hd], all contiguous and of
// storage type `dtype`.  hd <= 128 and a multiple of 16; H a multiple of
// KVH; under `causal`, Sq <= Sk.  `vec` != 0 selects 16-byte loads (the
// caller checked the alignment).  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int KVH, int hd,
                                     int causal, int dtype, int vec,
                                     void* stream) {
  using namespace repro_torch;
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH != 0 || hd < 16 ||
      hd > kMaxHd || hd % 16 != 0 || (causal && Sq > Sk) || H > 65535 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(q, k, v, out, B, Sq, Sk, H, KVH, hd, causal, vec, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KVH, hd, causal, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

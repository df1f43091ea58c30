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
// are never repeated in memory.  With a logit cap (grok-1; the JAX models'
// L.attention applies it, the Pallas kernel has none) each scaled score s
// becomes tanh(s/cap)*cap before the mask and the online max; the cap is
// a template flag, so cap 0 runs the uncapped code.
//
// What bounds it on the H100: operations.  At the training shape of
// smollm-360m (B=8, S=1024, H=15, KVH=5, hd=64, causal, bf16) the two
// products are ~16 GFLOP, ~16 us at 989 TFLOP/s, against ~42 MB of q, k,
// v and o, ~13 us at 3.35 TB/s.  Only wgmma reaches that rate.
//
// What the bf16 design does about it: one CTA is one warpgroup (128
// threads) per (64-query tile, head, sequence); the TPU's sequential kv
// grid axis becomes a loop over 64-key tiles, which stops at the diagonal
// under `causal`; query tiles go in reverse order, so the longest start
// first.  Both products run on wgmma (m64n64k16, bf16 in, f32 out), whose
// register layouts are documented, so S, P and O never leave registers
// inside the key loop:
//   - Q (loaded once per CTA) and each K tile sit in shared memory in the
//     128-byte-swizzled layout wgmma reads through descriptors (rows of 64
//     bf16; hd < 64 is zero-padded to 64, 64 < hd <= 128 to two column
//     blocks of 64), and S = Q.K^T accumulates in registers;
//   - the softmax works on S in registers: each row's values sit in the
//     four threads of a quad, so its max and sum are two shuffles; the
//     scores are scaled by log2(e)/sqrt(hd) in one multiply and go through
//     exp2f; O is rescaled in registers;
//   - P is rounded to bf16 straight into wgmma's A-register layout (the
//     f32 accumulator pairs of S are the A fragment's bf16 pairs), and
//     O += P.V takes V from shared memory as an MN-major B operand (the
//     transpose flag), one m64n64 product per 64 columns of V;
//   - K/V tiles go through a ring of two stages filled with 16-byte
//     cp.async copies: tile t+1 is in flight while the tensor cores work
//     on tile t;
//   - ~41 KB of shared memory and 127 registers a thread at hd <= 64 let
//     four CTAs share an SM (~81 KB and 190 registers at hd <= 128: two).
// Any Sq and Sk (ragged rows and padded columns are zero-filled by the
// copies and masked), hd any multiple of 16 up to 128.
//
// The f32 path runs on the FMA units (the TPU kernel's f32 dot; TF32
// would not hold the f32 tolerance), with S, P and O in shared memory:
// off the main path, and faster than the library's f32 attention.
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;        // queries per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // one warpgroup; 4 warps x 16 query rows
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16: wgmma with S, P and O in registers
// ---------------------------------------------------------------------------

constexpr int kStages = 2;           // K/V ring

// Shared memory: Q, then K and V of each stage, each [64 rows][HDP] as
// HDP / 64 column blocks of kSw128Block bytes, 1024-byte aligned (the swizzle
// pattern repeats every 8 rows of 128 bytes).
template <int HDP>
struct Bf16Smem {
  static constexpr int kTile = kSw128Block * (HDP / 64);
  static constexpr int kTotal = kTile * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// Accumulator layout of m64n64 (PTX ISA, wgmma register fragments): thread
// (warp w, lane) holds rows 16w + lane/4 (i = 0) and +8 (i = 1), columns
// 8j + 2(lane%4) + e, j < 8, e < 2, in d[4j + 2i + e].
// With kCap the scores go to the log2 domain as tanh(s*cap_scale)*scale_log2
// (cap_scale = 1/(sqrt(hd)*cap), scale_log2 = cap*log2(e)); without, as
// s*scale_log2 (scale_log2 = log2(e)/sqrt(hd)).
template <int HDP, bool kCap>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                            int KVH, int hd, float scale_log2, float cap_scale,
                            int causal) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  using L = Bf16Smem<HDP>;
  constexpr int kNB = HDP / 64;        // column blocks of 64
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q_stride = static_cast<int64_t>(H) * hd;     // between positions
  const int64_t kv_stride = static_cast<int64_t>(KVH) * hd;
  const __nv_bfloat16* qb =
      q + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * hd;
  const __nv_bfloat16* kb =
      k + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * hd;
  const __nv_bfloat16* vb =
      v + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * hd;

  const int shift = Sk - Sq;   // query i sits at key position i + shift
  // causal: the tile's last query sees keys up to q0 + kBQ - 1 + shift
  const int kv_end = causal ? min(Sk, q0 + kBQ + shift) : Sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  // group 0: Q and the first K/V tile
  load_tile_sw128<HDP, kThreads>(qs, qb, q_stride, Sq - q0, hd);
  load_tile_sw128<HDP, kThreads>(base + L::kTile, kb, kv_stride, Sk, hd);
  load_tile_sw128<HDP, kThreads>(base + 2 * L::kTile, vb, kv_stride, Sk, hd);
  cp_async_commit();

  float o[kNB][32];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};              // this thread's part of each row's sum
  const int row0 = 16 * warp + (lane >> 2);   // local row of i = 0
  const int col0 = 2 * (lane & 3);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const int st = t & 1;
    const uint32_t ks = base + L::kTile * (1 + 2 * st);
    const uint32_t vs = ks + L::kTile;
    if (t + 1 < n_tiles) {   // tile t+1 into the other stage, freed at the end of t-1
      const uint32_t kn = base + L::kTile * (1 + 2 * (st ^ 1));
      const int64_t off = static_cast<int64_t>(k0 + kBK) * kv_stride;
      load_tile_sw128<HDP, kThreads>(kn, kb + off, kv_stride, Sk - k0 - kBK, hd);
      load_tile_sw128<HDP, kThreads>(kn + L::kTile, vb + off, kv_stride, Sk - k0 - kBK, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();      // all but the newest group: tile t has landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSw128Block + (kk % 4) * 32;
      wgmma_ss(s, sw128_desc(qs + off), sw128_desc(ks + off));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax in the log2 domain, on the registers
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0 + shift);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x;
          if constexpr (kCap) {
            x = tanhf(s[4 * j + 2 * i + e] * cap_scale) * scale_log2;
          } else {
            x = s[4 * j + 2 * i + e] * scale_log2;
          }
          if (edge) {
            const int key = k0 + 8 * j + col0 + e;
            const int qpos = q0 + row0 + 8 * i;
            if (key >= Sk || (causal && key > qpos + shift)) x = kNegInf;
          }
          s[4 * j + 2 * i + e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * i + e] - m[i]);
          s[4 * j + 2 * i + e] = p;
          rs[i] += p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[nb][4 * j + 2 * i] *= corr[i];
          o[nb][4 * j + 2 * i + 1] *= corr[i];
        }

    // P as bf16 A fragments: keys 16kk..16kk+15 are S columns j = 2kk, 2kk+1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);   // row, keys 2t..
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);   // row + 8
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);   // row, keys 8 + 2t..
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);   // row + 8
    }

    // O += P V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
        wgmma_rs(o[nb], pa[kk], sw128_desc(vs + nb * kSw128Block + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_regs(o[nb]);
    __syncthreads();         // stage st is free for the copy of tile t+2
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  __nv_bfloat16* ob =
      out + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * hd;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + 8 * i;
        const int c = nb * 64 + 8 * j + col0;
        if (q0 + r < Sq && c < hd) {
          *reinterpret_cast<__nv_bfloat162*>(ob + r * q_stride + c) = __floats2bfloat162_rn(
              o[nb][4 * j + 2 * i] * inv[i], o[nb][4 * j + 2 * i + 1] * inv[i]);
        }
      }
}

template <int HDP, bool kCap>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                int Sk, int H, int KVH, int hd, int causal, float cap,
                cudaStream_t stream) {
  constexpr int smem = Bf16Smem<HDP>::kTotal;
  auto kernel = flash_attention_bf16_kernel<HDP, kCap>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const double sd = std::sqrt(static_cast<double>(hd));
  const float scale_log2 = static_cast<float>(kCap ? 1.4426950408889634 * cap
                                                   : 1.4426950408889634 / sd);
  const float cap_scale = kCap ? static_cast<float>(1.0 / (sd * cap)) : 0.f;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq, Sk, H,
      KVH, hd, scale_log2, cap_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: FMA units, S, P and O in shared memory
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory layout: byte offsets and row strides (in elements).
struct Layout {
  int ldq, ldk, ldv, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, c, total;
};

__host__ __device__ inline Layout layout_f32(int hd) {
  Layout L;
  // K rows padded by one element, so the per-lane key reads hit distinct
  // banks
  L.ldq = hd;
  L.ldk = hd + 1;
  L.ldv = hd;
  L.lds = kBK + 4;
  L.ldp = kBK + 4;
  L.ldo = hd + 4;
  size_t off = 0;
  L.q = off; off = align128(off + sizeof(float) * kBQ * L.ldq);
  L.k = off; off = align128(off + sizeof(float) * kBK * L.ldk);
  L.v = off; off = align128(off + sizeof(float) * kBK * L.ldv);
  L.s = off; off = align128(off + sizeof(float) * kBQ * L.lds);
  L.p = off; off = align128(off + sizeof(float) * kBQ * L.ldp);
  L.o = off; off = align128(off + sizeof(float) * kBQ * L.ldo);
  L.m = off; off += sizeof(float) * kBQ;
  L.l = off; off += sizeof(float) * kBQ;
  L.c = off; off += sizeof(float) * kBQ;
  L.total = align128(off);
  return L;
}

// rows x hd tile of a [*, row_stride] tensor into shared memory [rows][ld];
// rows at or past `valid` are zero.
template <bool kVec>
__device__ inline void load_tile(float* dst, int ld, const float* src, int64_t row_stride,
                                 int valid, int hd, int rows) {
  if (kVec) {
    const int vpr = hd / 4;
    for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
      const int r = i / vpr, c = (i - r * vpr) * 4;
      float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < valid) raw = *reinterpret_cast<const float4*>(src + r * row_stride + c);
      dst[r * ld + c] = raw.x;
      dst[r * ld + c + 1] = raw.y;
      dst[r * ld + c + 2] = raw.z;
      dst[r * ld + c + 3] = raw.w;
    }
  } else {
    for (int i = threadIdx.x; i < rows * hd; i += kThreads) {
      const int r = i / hd, c = i - r * hd;
      dst[r * ld + c] = r < valid ? src[r * row_stride + c] : 0.f;
    }
  }
}

// S[16 rows of this warp][kBK] = Q K^T (unscaled)
__device__ inline void scores(const float* qs, const float* ks, float* ss, const Layout& L,
                              int hd, int warp) {
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

// O[16 rows of this warp] = O * corr + P V
__device__ inline void accumulate_pv(const float* ps, const float* vs, float* os,
                                     const float* corr, const Layout& L, int hd, int warp) {
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

template <bool kVec, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int Sq,
                           int Sk, int H, int KVH, int hd, float scale, float cap,
                           int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout_f32(hd);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ks = reinterpret_cast<float*>(smem + L.k);
  float* vs = reinterpret_cast<float*>(smem + L.v);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* ps = reinterpret_cast<float*>(smem + L.p);
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
  const float* qb = q + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * hd;
  const float* kb = k + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * hd;
  const float* vb = v + static_cast<int64_t>(b) * Sk * kv_stride + static_cast<int64_t>(kvh) * hd;

  load_tile<kVec>(qs, L.ldq, qb, q_stride, min(kBQ, Sq - q0), hd, kBQ);
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
    load_tile<kVec>(ks, L.ldk, kb + k0 * kv_stride, kv_stride, Sk - k0, hd, kBK);
    load_tile<kVec>(vs, L.ldv, vb + k0 * kv_stride, kv_stride, Sk - k0, hd, kBK);
    __syncthreads();

    scores(qs, ks, ss, L, hd, warp);
    __syncwarp();

    // online softmax over this warp's 16 rows: two lanes per row, each
    // over every other key of the tile, so a row's max and sum take one
    // shuffle each
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
        float x = srow[j] * scale;
        if constexpr (kCap) x = tanhf(x / cap) * cap;
        sv[i] = j < kmax ? x : kNegInf;
        m_loc = fmaxf(m_loc, sv[i]);
      }
      m_loc = fmaxf(m_loc, __shfl_xor_sync(0xffffffffu, m_loc, 1));
      // both lanes of the row read m_prev before the psum shuffle below,
      // and lane h == 0 writes it only after that shuffle
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_loc);
      float* prow = ps + r * L.ldp;
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const float pv = expf(sv[i] - m_new);
        prow[2 * i + h] = pv;
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

  float* ob = out + (static_cast<int64_t>(b) * Sq + q0) * q_stride + static_cast<int64_t>(h) * hd;
  const int valid = min(kBQ, Sq - q0);
  for (int i = tid; i < valid * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    ob[r * q_stride + c] = os[r * L.ldo + c] / fmaxf(l_s[r], 1e-30f);
  }
}

template <bool kCap>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq,
               int Sk, int H, int KVH, int hd, int causal, float cap, int vec,
               cudaStream_t stream) {
  const Layout L = layout_f32(hd);
  auto kernel = vec ? flash_attention_f32_kernel<true, kCap>
                    : flash_attention_f32_kernel<false, kCap>;
  // above 48 KB a kernel must opt in to dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Sk, H, KVH, hd, scale, cap, causal);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCap>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int H, int KVH, int hd, int causal, float cap, int dtype, int vec,
           cudaStream_t s) {
  switch (dtype) {
    case kF32:
      return launch_f32<kCap>(q, k, v, out, B, Sq, Sk, H, KVH, hd, causal, cap, vec, s);
    case kBF16:
      if (!vec) return static_cast<int>(cudaErrorMisalignedAddress);
      return hd <= 64
                 ? launch_bf16<64, kCap>(q, k, v, out, B, Sq, Sk, H, KVH, hd, causal, cap, s)
                 : launch_bf16<128, kCap>(q, k, v, out, B, Sq, Sk, H, KVH, hd, causal, cap,
                                          s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// q, out: [B, Sq, H, hd]; k, v: [B, Sk, KVH, hd], all contiguous and of
// storage type `dtype`.  hd <= 128 and a multiple of 16; H a multiple of
// KVH; under `causal`, Sq <= Sk.  `logit_cap` > 0 caps the scaled scores at
// tanh(s/cap)*cap, 0 takes the uncapped kernels.  `vec` != 0 says every
// pointer is 16-byte aligned: the f32 path then takes 16-byte loads, and
// the bf16 path needs it.  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int Sq, int Sk, int H, int KVH, int hd,
                                     int causal, float logit_cap, int dtype, int vec,
                                     void* stream) {
  using namespace repro_torch;
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH != 0 || hd < 16 || hd > kMaxHd ||
      hd % 16 != 0 || (causal && Sq > Sk) || H > 65535 || B > 65535 ||
      !(logit_cap >= 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return logit_cap > 0.f
             ? launch<true>(q, k, v, out, B, Sq, Sk, H, KVH, hd, causal, logit_cap, dtype,
                            vec, s)
             : launch<false>(q, k, v, out, B, Sq, Sk, H, KVH, hd, causal, logit_cap, dtype,
                             vec, s);
}

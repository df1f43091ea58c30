// ssd_chunk for Hopper: the Mamba2 SSD within one chunk, for stacked
// chunks.  x [B,Q,nh,hp], b/c [B,Q,ds], dt [B,Q,nh] (post-softplus),
// a_log [nh] f32 -> y [B,Q,nh,hp] (x's type), states [B,nh,hp,ds] f32,
// decay_total [B,nh] f32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_chunk
// (_ssd_kernel; pallas_call at ssd_scan.py:79) and computes what
// _ssd_kernel computes, per (chunk, head):
//   dA = dt * -exp(a_log), cum = cumsum_Q(dA);
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(clip(cum_i - cum_j, -60, 0)) dt_j x_j;
//   state = sum_j exp(clip(cum_last - cum_j, -60, 0)) dt_j x_j (x) B_j;
//   decay_total = exp(clip(cum_last, -60, 0)).
// The prefix sum runs in f32 in one fixed order, the one XLA's CPU
// backend gives the JAX package's jnp.cumsum (sequential within blocks of
// 16, each block's carry by the same scan of the block totals,
// recursively), as the plain version (kernels/ref.py::prefix_sum)
// does: y cancels cum_i - cum_j, two sums of up to hundreds, so two
// orders would move y by more than the f32 tolerance.
//
// What bounds it on the H100: bytes.  At the mamba2-1.3b training shape
// (x [32, 256, 64, 64] bf16, ds = 128) it moves ~207 MB (x, y, and the
// f32 states, 67 MB each), ~62 us at 3.35 TB/s, against ~17.5 GFLOP of
// causal products, ~18 us at 989 TFLOP/s.
//
// What the design does about it.  The TPU kernel keeps [Q, Q, block_h]
// in VMEM (2 MB at Q = 256, 8 heads); a CTA here has 227 KB.  So one
// CTA of 4 warps per (64-query tile, head, chunk) walks the 64-key
// tiles up to the diagonal: per tile it forms S = C B^T for its query
// rows (B and C staged in shared memory), the decayed, masked weights
// W = S exp(clip(cum_i - cum_j)) dt_j on the fly from the prefix sums,
// and accumulates Y += W X in registers.  One more CTA per (head,
// chunk), blockIdx.x == 0, walks all key tiles and accumulates the
// state (dt x decay)^T B.  A first launch writes the prefix sums
// cum [B, Q, nh] (one thread per (chunk, head), in the order above); the
// main launch reads them, so no CTA waits on another and any Q works (the
// ragged tail is masked).
// In bf16 the three products run on the tensor cores (WMMA m16n16k16,
// bf16 in, f32 out).  W and the decayed x are f32 values: each goes in
// as a bf16 pair hi + lo (hi = bf16(v), lo = bf16(v - hi)), two products
// whose sum is within ~2^-17 of v's (hi alone, 2^-9, put y over the bf16
// tolerance).  In f32 the products run on the FMA units (TF32 would not
// hold the f32 tolerance).
// Known limits of this first version: S = C B^T is recomputed for every
// head (64x at mamba2-1.3b: half of the tensor work), no cp.async/TMA
// pipelining, and no wgmma.
#include <mma.h>

#include "common.cuh"

namespace repro_torch {
namespace {

using namespace nvcuda;

constexpr int kTile = 64;        // query rows per CTA, keys per tile
constexpr int kThreads = 128;    // 4 warps x 16 rows
constexpr int kMaxHp = 128;
constexpr int kMaxDs = 256;
constexpr int kStateAcc = 8;     // state accumulator tiles per warp per pass
constexpr int kBlk = 16;         // the prefix sum's block

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory layout: byte offsets and row strides (in elements).
struct Layout {
  int ldc, ldx, lds, ldw, ldo;
  size_t c, b, x, xl, s, w, wl, cq, ck, dk, co, total;
};

template <typename T>
__host__ __device__ inline Layout layout_for(int hp, int ds) {
  constexpr bool kF32 = sizeof(T) == 4;
  Layout L;
  // bf16 rows padded by 16 bytes (WMMA needs ldm % 8 == 0 and 32-byte
  // aligned tile starts); f32 rows by 16 bytes too (16-byte stores).
  L.ldc = ds + (kF32 ? 4 : 8);
  L.ldx = hp + (kF32 ? 4 : 8);
  L.lds = kTile + 4;
  L.ldw = kTile + (kF32 ? 4 : 8);
  L.ldo = hp + 4;
  size_t off = 0;
  L.c = off; off = align128(off + sizeof(T) * kTile * L.ldc);
  L.b = off; off = align128(off + sizeof(T) * kTile * L.ldc);
  L.x = off; off = align128(off + sizeof(T) * kTile * L.ldx);
  L.s = off; off = align128(off + sizeof(float) * kTile * L.lds);
  // the state CTA's low part of the decayed x reuses S, which only the
  // y CTAs use (kTile * (hp + 8) * 2 <= kTile * lds * 4 for hp <= 128)
  L.xl = L.s;
  L.w = off; off = align128(off + sizeof(T) * kTile * L.ldw);
  L.wl = off; off = align128(off + (kF32 ? 0 : sizeof(T) * kTile * L.ldw));
  // the f32 y staging tile [kTile][ldo] reuses the region above once the
  // key loop is done
  const size_t stage = align128(sizeof(float) * kTile * L.ldo);
  off = off > stage ? off : stage;
  L.cq = off; off += sizeof(float) * kTile;
  L.ck = off; off += sizeof(float) * kTile;
  L.dk = off; off += sizeof(float) * kTile;
  L.co = off; off += sizeof(float) * kTile;
  L.total = align128(off);
  return L;
}

// ---------------------------------------------------------------------------
// 16x16 tile products with an f32 accumulator owned by one warp.  bf16:
// WMMA.  f32: FMA, lane l owning row l/2, columns (l%2)*8 .. +8.
// ---------------------------------------------------------------------------

struct AccF32 {
  float v[8];
};
using AccBF16 = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <typename T> struct Acc;
template <> struct Acc<float> { using type = AccF32; };
template <> struct Acc<__nv_bfloat16> { using type = AccBF16; };

__device__ inline void zero(AccF32& acc) {
#pragma unroll
  for (int c = 0; c < 8; ++c) acc.v[c] = 0.f;
}
__device__ inline void zero(AccBF16& acc) { wmma::fill_fragment(acc, 0.f); }

// acc += A B; A, B row-major 16x16
__device__ inline void mma_ab(AccF32& acc, const float* a, int lda,
                              const float* b, int ldb) {
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float av = a[r * lda + k];
    const float* brow = b + k * ldb + c0;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc.v[c] = fmaf(av, brow[c], acc.v[c]);
  }
}
__device__ inline void mma_ab(AccBF16& acc, const __nv_bfloat16* a, int lda,
                              const __nv_bfloat16* b, int ldb) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
  wmma::load_matrix_sync(fa, a, lda);
  wmma::load_matrix_sync(fb, b, ldb);
  wmma::mma_sync(acc, fa, fb, acc);
}

// acc += A B^T; A row-major 16x16, B stored row-major as [n][k]
__device__ inline void mma_abt(AccF32& acc, const float* a, int lda,
                               const float* b, int ldb) {
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float av = a[r * lda + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc.v[c] = fmaf(av, b[(c0 + c) * ldb + k], acc.v[c]);
  }
}
__device__ inline void mma_abt(AccBF16& acc, const __nv_bfloat16* a, int lda,
                               const __nv_bfloat16* b, int ldb) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
  wmma::load_matrix_sync(fa, a, lda);
  wmma::load_matrix_sync(fb, b, ldb);
  wmma::mma_sync(acc, fa, fb, acc);
}

// acc += A^T B; A stored row-major as [k][m], B row-major 16x16
__device__ inline void mma_atb(AccF32& acc, const float* a, int lda,
                               const float* b, int ldb) {
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float av = a[k * lda + r];
    const float* brow = b + k * ldb + c0;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc.v[c] = fmaf(av, brow[c], acc.v[c]);
  }
}
__device__ inline void mma_atb(AccBF16& acc, const __nv_bfloat16* a, int lda,
                               const __nv_bfloat16* b, int ldb) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
  wmma::load_matrix_sync(fa, a, lda);
  wmma::load_matrix_sync(fb, b, ldb);
  wmma::mma_sync(acc, fa, fb, acc);
}

// row-major f32 store of the tile (shared or global memory; for WMMA the
// pointer must be 32-byte aligned and ld a multiple of 4)
__device__ inline void store(float* dst, int ld, const AccF32& acc) {
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int c = 0; c < 8; ++c) dst[r * ld + c0 + c] = acc.v[c];
}
__device__ inline void store(float* dst, int ld, const AccBF16& acc) {
  wmma::store_matrix_sync(dst, acc, ld, wmma::mem_row_major);
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

// kTile x cols tile of a [*, row_stride] tensor into shared memory
// [kTile][ld]; rows at or past `valid` are zero.  `vec`: 16-byte loads
// (the caller checked the alignment; cols * sizeof(T) % 16 == 0 and
// ld * sizeof(T) % 16 == 0 always hold here).
template <typename T>
__device__ inline void load_tile(T* dst, int ld, const T* src,
                                 int64_t row_stride, int valid, int cols,
                                 int vec) {
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    const int vpr = cols / kV;
    for (int i = threadIdx.x; i < kTile * vpr; i += kThreads) {
      const int r = i / vpr, c = (i - r * vpr) * kV;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = raw;
    }
  } else {
    for (int i = threadIdx.x; i < kTile * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = r < valid ? src[r * row_stride + c] : from_f32<T>(0.f);
    }
  }
}

__device__ inline float decay_of(float seg) {
  return expf(fminf(fmaxf(seg, -60.f), 0.f));
}

// ---------------------------------------------------------------------------
// launch 1: the prefix sums
// ---------------------------------------------------------------------------

// Scratch values per (chunk, head) of a length-n prefix sum: the block
// totals of every level, n_1 = ceil(n / 16), n_2 = ceil(n_1 / 16), ...,
// down to a level of at most 16.
__host__ __device__ inline int scan_scratch(int n) {
  int total = 0;
  while (n > kBlk) {
    n = (n + kBlk - 1) / kBlk;
    total += n;
  }
  return total;
}

// cum [B, Q, nh] f32: the prefix sums over Q of dA = dt * -exp(a_log), in
// the order of kernels/ref.py::prefix_sum, each product and add
// rounded on its own as there (__fmul_rn/__fadd_rn: nvcc would otherwise
// contract them into FMAs).
// One thread per (chunk, head), heads on neighbouring threads (so loads
// and stores of [B, Q, nh] tensors coalesce); scratch [B, slen, nh] f32
// holds the levels' block totals, slen = scan_scratch(Q).
template <typename TD>
__global__ void ssd_cum_kernel(const TD* __restrict__ dt,
                               const float* __restrict__ a_log,
                               float* __restrict__ cum,
                               float* __restrict__ scratch, int Q, int nh,
                               int slen) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= nh) return;
  const int64_t b = blockIdx.y;
  const float a = -expf(a_log[h]);
  const TD* d = dt + b * Q * nh + h;
  float* out = cum + b * Q * nh + h;
  float* sc = scratch + b * slen * nh + h;     // element k at sc[k * nh]
  // level 0: scans within blocks of 16 (padded with zeros) into cum; the
  // block totals are level 1
  for (int k = 0; k * kBlk < Q; ++k) {
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < kBlk; ++m) {
      const int j = k * kBlk + m;
      const float v = j < Q ? __fmul_rn(to_f32(d[static_cast<int64_t>(j) * nh]), a) : 0.f;
      s = m == 0 ? v : __fadd_rn(s, v);
      if (j < Q) out[static_cast<int64_t>(j) * nh] = s;
    }
    if (Q > kBlk) sc[static_cast<int64_t>(k) * nh] = s;
  }
  if (Q <= kBlk) return;
  // up: each level's values become scans within their blocks of 16, their
  // block totals the next level; the last level (<= 16) one scan
  int ns[8], offs[8], depth = 0;      // 16^8 > 2^31: at most 8 levels
  int n = (Q + kBlk - 1) / kBlk, off = 0;
  while (true) {
    ns[depth] = n;
    offs[depth] = off;
    ++depth;
    if (n <= kBlk) {
      float s = 0.f;
      for (int i = 0; i < n; ++i) {
        float* e = sc + static_cast<int64_t>(off + i) * nh;
        s = i == 0 ? *e : __fadd_rn(s, *e);
        *e = s;
      }
      break;
    }
    const int nb = (n + kBlk - 1) / kBlk;
    for (int k = 0; k < nb; ++k) {
      float s = 0.f;
      for (int m = 0; m < kBlk; ++m) {
        const int i = k * kBlk + m;
        float* e = sc + static_cast<int64_t>(off + i) * nh;
        const float v = i < n ? *e : 0.f;
        s = m == 0 ? v : __fadd_rn(s, v);
        if (i < n) *e = s;
      }
      sc[static_cast<int64_t>(off + n + k) * nh] = s;
    }
    off += n;
    n = nb;
  }
  // down: add to each value past the first block the inclusive sum of the
  // blocks before its own, from the level above
  for (int l = depth - 2; l >= 0; --l) {
    for (int i = kBlk; i < ns[l]; ++i) {
      float* e = sc + static_cast<int64_t>(offs[l] + i) * nh;
      *e = __fadd_rn(*e, sc[static_cast<int64_t>(offs[l + 1] + i / kBlk - 1) * nh]);
    }
  }
  for (int j = kBlk; j < Q; ++j) {
    float* e = out + static_cast<int64_t>(j) * nh;
    *e = __fadd_rn(*e, sc[static_cast<int64_t>(j / kBlk - 1) * nh]);
  }
}

// ---------------------------------------------------------------------------
// launch 2: y, the states and the decay
// ---------------------------------------------------------------------------

// cum and dt of the kTile keys from k0 into shared memory (0 past Q).
template <typename TD>
__device__ inline void load_cum(float* ck, float* dk, const float* cumb,
                                const TD* dtb, int nh, int k0, int Q) {
  const int j = threadIdx.x;
  if (j < kTile) {
    const bool in = k0 + j < Q;
    ck[j] = in ? cumb[static_cast<int64_t>(k0 + j) * nh] : 0.f;
    dk[j] = in ? to_f32(dtb[static_cast<int64_t>(k0 + j) * nh]) : 0.f;
  }
}

struct Args {
  int Q, nh, hp, ds, vec;
  int64_t xrow;       // elements between positions of x and y (nh * hp)
};

// y for query rows [q0, q0 + kTile) of one (chunk, head).
template <typename T, typename TD>
__device__ void y_tile(const Layout& L, unsigned char* smem, const Args& A,
                       const T* xb, const T* bb, const T* cb, const TD* dtb,
                       const float* cumb, T* yb, int qt) {
  T* cs = reinterpret_cast<T*>(smem + L.c);
  T* bs = reinterpret_cast<T*>(smem + L.b);
  T* xs = reinterpret_cast<T*>(smem + L.x);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  T* ws = reinterpret_cast<T*>(smem + L.w);
  T* wl = reinterpret_cast<T*>(smem + L.wl);     // bf16 only: W's low part
  float* os = reinterpret_cast<float*>(smem);
  float* cq = reinterpret_cast<float*>(smem + L.cq);
  float* ck = reinterpret_cast<float*>(smem + L.ck);
  float* dk = reinterpret_cast<float*>(smem + L.dk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * 16;
  const int q0 = qt * kTile;

  load_tile<T>(cs, L.ldc, cb + static_cast<int64_t>(q0) * A.ds, A.ds,
               A.Q - q0, A.ds, A.vec);
  if (tid < kTile)
    cq[tid] = q0 + tid < A.Q ? cumb[static_cast<int64_t>(q0 + tid) * A.nh] : 0.f;

  using AccT = typename Acc<T>::type;
  const int nf = A.hp / 16;
  AccT yacc[kMaxHp / 16];
#pragma unroll
  for (int f = 0; f < kMaxHp / 16; ++f)
    if (f < nf) zero(yacc[f]);

  for (int t = 0; t <= qt; ++t) {
    const int k0 = t * kTile;
    __syncthreads();   // the previous tile's B, X, S and W reads are done
    load_tile<T>(bs, L.ldc, bb + static_cast<int64_t>(k0) * A.ds, A.ds,
                 A.Q - k0, A.ds, A.vec);
    load_tile<T>(xs, L.ldx, xb + k0 * A.xrow, A.xrow, A.Q - k0, A.hp, A.vec);
    load_cum(ck, dk, cumb, dtb, A.nh, k0, A.Q);
    __syncthreads();

    // S = C B^T for this warp's 16 query rows (warp-private rows of S, W)
    for (int n = 0; n < kTile / 16; ++n) {
      AccT acc;
      zero(acc);
      for (int kk = 0; kk < A.ds; kk += 16)
        mma_abt(acc, cs + r0 * L.ldc + kk, L.ldc, bs + n * 16 * L.ldc + kk, L.ldc);
      store(ss + r0 * L.lds + n * 16, L.lds, acc);
    }
    __syncwarp();
    // W = S exp(clip(cum_i - cum_j)) dt_j for j <= i, 0 above the diagonal
    // (masked explicitly: there the clip would give exp(0) = 1)
    {
      const int r = r0 + (lane >> 1);
      const int i_abs = q0 + r;
      const float ci = cq[r];
#pragma unroll 4
      for (int jj = 0; jj < kTile / 2; ++jj) {
        const int j = 2 * jj + (lane & 1);
        float w = 0.f;
        if (k0 + j <= i_abs) w = ss[r * L.lds + j] * decay_of(ci - ck[j]) * dk[j];
        const T hi = from_f32<T>(w);
        ws[r * L.ldw + j] = hi;
        if constexpr (sizeof(T) == 2) wl[r * L.ldw + j] = from_f32<T>(w - to_f32(hi));
      }
    }
    __syncwarp();
    // Y += W X
    for (int kk = 0; kk < kTile; kk += 16) {
#pragma unroll
      for (int f = 0; f < kMaxHp / 16; ++f) {
        if (f < nf) {
          mma_ab(yacc[f], ws + r0 * L.ldw + kk, L.ldw, xs + kk * L.ldx + f * 16, L.ldx);
          if constexpr (sizeof(T) == 2)
            mma_ab(yacc[f], wl + r0 * L.ldw + kk, L.ldw, xs + kk * L.ldx + f * 16, L.ldx);
        }
      }
    }
  }
  __syncthreads();   // every warp is done with the tiles the staging reuses
#pragma unroll
  for (int f = 0; f < kMaxHp / 16; ++f)
    if (f < nf) store(os + r0 * L.ldo + f * 16, L.ldo, yacc[f]);
  __syncthreads();
  const int valid = min(kTile, A.Q - q0);
  T* yq = yb + q0 * A.xrow;
  for (int i = tid; i < valid * A.hp; i += kThreads) {
    const int r = i / A.hp, p = i - r * A.hp;
    yq[r * A.xrow + p] = from_f32<T>(os[r * L.ldo + p]);
  }
}

// state [hp, ds] and decay_total of one (chunk, head).
template <typename T, typename TD>
__device__ void state_tile(const Layout& L, unsigned char* smem,
                           const Args& A, const T* xb, const T* bb,
                           const TD* dtb, const float* cumb, float* st,
                           float* dec) {
  T* bs = reinterpret_cast<T*>(smem + L.b);
  T* xs = reinterpret_cast<T*>(smem + L.x);
  T* xl = reinterpret_cast<T*>(smem + L.xl);     // bf16 only: the low part
  float* ck = reinterpret_cast<float*>(smem + L.ck);
  float* dk = reinterpret_cast<float*>(smem + L.dk);
  float* co = reinterpret_cast<float*>(smem + L.co);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_tiles = (A.Q + kTile - 1) / kTile;
  const float cum_last = cumb[static_cast<int64_t>(A.Q - 1) * A.nh];
  if (tid == 0) *dec = decay_of(cum_last);

  using AccT = typename Acc<T>::type;
  const int nsi = A.ds / 16;
  const int n_acc = (A.hp / 16) * nsi;      // 16x16 tiles of the state
  for (int f0 = 0; f0 < n_acc; f0 += 4 * kStateAcc) {
    AccT acc[kStateAcc];
#pragma unroll
    for (int i = 0; i < kStateAcc; ++i) zero(acc[i]);
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kTile;
      __syncthreads();   // the previous tile's reads are done
      load_tile<T>(bs, L.ldc, bb + static_cast<int64_t>(k0) * A.ds, A.ds,
                   A.Q - k0, A.ds, A.vec);
      load_tile<T>(xs, L.ldx, xb + k0 * A.xrow, A.xrow, A.Q - k0, A.hp, A.vec);
      load_cum(ck, dk, cumb, dtb, A.nh, k0, A.Q);
      __syncthreads();
      if (tid < kTile) co[tid] = decay_of(cum_last - ck[tid]);
      __syncthreads();
      // x -> (x dt) exp(clip(cum_last - cum_j)), in place
      for (int i = tid; i < kTile * A.hp; i += kThreads) {
        const int r = i / A.hp, p = i - r * A.hp;
        T* e = xs + r * L.ldx + p;
        const float v = to_f32(*e) * dk[r] * co[r];
        const T hi = from_f32<T>(v);
        *e = hi;
        if constexpr (sizeof(T) == 2) xl[r * L.ldx + p] = from_f32<T>(v - to_f32(hi));
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kStateAcc; ++i) {
        const int f = f0 + warp * kStateAcc + i;
        if (f < n_acc) {
          const int pi = f / nsi, si = f - pi * nsi;
          for (int kk = 0; kk < kTile; kk += 16) {
            mma_atb(acc[i], xs + kk * L.ldx + pi * 16, L.ldx,
                    bs + kk * L.ldc + si * 16, L.ldc);
            if constexpr (sizeof(T) == 2)
              mma_atb(acc[i], xl + kk * L.ldx + pi * 16, L.ldx,
                      bs + kk * L.ldc + si * 16, L.ldc);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kStateAcc; ++i) {
      const int f = f0 + warp * kStateAcc + i;
      if (f < n_acc) {
        const int pi = f / nsi, si = f - pi * nsi;
        store(st + pi * 16 * A.ds + si * 16, A.ds, acc[i]);
      }
    }
  }
}

// grid (n_tiles + 1, nh, B): blockIdx.x == 0 computes the state and the
// decay of (chunk blockIdx.z, head blockIdx.y); the others a query tile
// of y, the last (longest) tiles first.
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                 const T* __restrict__ cm, const TD* __restrict__ dt,
                 const float* __restrict__ cum, T* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ decay, int Q,
                 int nh, int hp, int ds, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout_for<T>(hp, ds);
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  Args A;
  A.Q = Q;
  A.nh = nh;
  A.hp = hp;
  A.ds = ds;
  A.vec = vec;
  A.xrow = static_cast<int64_t>(nh) * hp;
  const T* xb = x + b * Q * A.xrow + static_cast<int64_t>(h) * hp;
  const T* bb = bm + b * Q * ds;
  const TD* dtb = dt + b * Q * nh + h;
  const float* cumb = cum + b * Q * nh + h;
  if (blockIdx.x == 0) {
    state_tile<T, TD>(L, smem, A, xb, bb, dtb, cumb,
                      states + (b * nh + h) * hp * ds, decay + b * nh + h);
  } else {
    const T* cb = cm + b * Q * ds;
    T* yb = y + b * Q * A.xrow + static_cast<int64_t>(h) * hp;
    y_tile<T, TD>(L, smem, A, xb, bb, cb, dtb, cumb, yb,
                  gridDim.x - 1 - blockIdx.x);
  }
}

template <typename T, typename TD>
int launch(const void* x, const void* b, const void* c, const void* dt,
           const void* a_log, void* y, void* states, void* decay, void* cum,
           void* scratch, int B, int Q, int nh, int hp, int ds, int vec,
           cudaStream_t stream) {
  constexpr int kCumThreads = 64;
  dim3 cum_grid((nh + kCumThreads - 1) / kCumThreads, B);
  ssd_cum_kernel<TD><<<cum_grid, kCumThreads, 0, stream>>>(
      static_cast<const TD*>(dt), static_cast<const float*>(a_log),
      static_cast<float*>(cum), static_cast<float*>(scratch), Q, nh,
      scan_scratch(Q));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout L = layout_for<T>(hp, ds);
  auto kernel = ssd_chunk_kernel<T, TD>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Q + kTile - 1) / kTile + 1, nh, B);
  kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const TD*>(dt),
      static_cast<const float*>(cum), static_cast<T*>(y),
      static_cast<float*>(states), static_cast<float*>(decay), Q, nh, hp, ds,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Scratch floats per (chunk, head) that repro_ssd_chunk needs besides cum.
extern "C" int repro_ssd_chunk_scratch(int Q) {
  return repro_torch::scan_scratch(Q);
}

// x, y: [B, Q, nh, hp] and b, c: [B, Q, ds] of storage type `dtype`; dt:
// [B, Q, nh] of type `dt_dtype` (f32, or `dtype`); a_log [nh], states
// [B, nh, hp, ds] and decay [B, nh] f32; cum [B, Q, nh] and scratch
// [B, repro_ssd_chunk_scratch(Q), nh] f32 work space (cum holds the
// prefix sums of dA afterwards); all contiguous, states 32-byte aligned.
// hp a multiple of 16 up to 128, ds a multiple of 16 up to 256.  `vec` !=
// 0 selects 16-byte loads (the caller checked that x, b and c are 16-byte
// aligned).  Two launches; returns cudaGetLastError() after them.
extern "C" int repro_ssd_chunk(const void* x, const void* b, const void* c,
                               const void* dt, const void* a_log, void* y,
                               void* states, void* decay, void* cum,
                               void* scratch, int B, int Q, int nh, int hp,
                               int ds, int dtype, int dt_dtype, int vec,
                               void* stream) {
  using namespace repro_torch;
  if (B < 1 || Q < 1 || nh < 1 || hp < 16 || hp > kMaxHp || hp % 16 != 0 ||
      ds < 16 || ds > kMaxDs || ds % 16 != 0 || nh > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && dt_dtype == kF32)
    return launch<float, float>(x, b, c, dt, a_log, y, states, decay, cum,
                                scratch, B, Q, nh, hp, ds, vec, s);
  if (dtype == kBF16 && dt_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, b, c, dt, a_log, y, states,
                                                 decay, cum, scratch, B, Q, nh,
                                                 hp, ds, vec, s);
  if (dtype == kBF16 && dt_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, b, c, dt, a_log, y, states, decay,
                                         cum, scratch, B, Q, nh, hp, ds, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// causal products, ~18 us at 989 TFLOP/s.  What this design issues on the
// tensor cores is ~33 GFLOP (W goes in as a bf16 pair, below).
//
// What the design does about it.  Two launches:
//   1. ssd_cum_kernel: one warp per (chunk, head) writes the prefix sums
//      and dt as f32 rows [B, nh, Qp] (Qp = Q rounded up to 64, zero past
//      Q) into work space, its lanes scanning the blocks of 16 of each
//      level in the order above, the last level through shuffles;
//   2. ssd_chunk_bf16_kernel, CTAs of one warpgroup in two roles:
//   - y: a CTA per (chunk, 64-query tile, block of up to 8 heads).  The
//     TPU kernel shares S = C B^T over its 8-head block; so does this one:
//     it forms each S tile (64 x 64, depth ds) once with wgmma from
//     128-byte-swizzled C and B tiles, keeps the query tile's S tiles in
//     shared memory (f32, each thread's fragment at its own slots, up to
//     four tiles: all of them at Q <= 256), then walks its heads: per key
//     tile it forms W = S exp(clip(cum_i - cum_j)) dt_j, masked above the
//     diagonal, in the accumulator's registers, packs it to bf16 A
//     fragments and accumulates Y += W X with wgmma (X MN-major from
//     shared memory), Y staying in registers until the head's last tile.
//     A query tile past the fourth forms its S tiles anew for each head
//     (the cache would not fit), so any Q works.  The B tiles are copied
//     all at once, each into the cache slot its S tile then takes; the X
//     tiles (with B tiles when S is formed anew) come through a two-stage
//     cp.async ring that starts filling while the S tiles form, so item
//     i+1 lands while the tensor cores work on item i;
//   - state: a CTA per (chunk, head, 64-row block of hp, 128-column block
//     of ds) walks all key tiles through a two-stage ring of X and B
//     tiles, scales x by dt_j exp(clip(cum_last - cum_j)) into bf16 in
//     place, and accumulates the m64n128 product (scaled x)^T B with both
//     operands MN-major.
//   W is f32: it goes in as a bf16 pair hi + lo (hi = bf16(w), lo =
//   bf16(w - hi)), two products whose sum is within ~2^-17 of w's (hi
//   alone, 2^-9, puts y over the bf16 tolerance).  The scaled x of the
//   state goes in as hi alone: the states' tolerance (3e-2) is far above
//   one bf16 rounding of each term.  100 KB of shared memory and ~200
//   registers a thread at hp <= 64, ds <= 128: two CTAs a SM.
// The f32 path runs on the FMA units (TF32 would not hold the f32
// tolerance): a CTA per (64-query tile, head, chunk) with S, W and the
// tiles in shared memory, and one more per (head, chunk) for the state.
#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 64;        // query rows per CTA, keys per tile
constexpr int kThreads = 128;    // one warpgroup, 4 warps x 16 rows
constexpr int kMaxHp = 128;
constexpr int kMaxDs = 256;
constexpr int kBlk = 16;         // the prefix sum's block
constexpr int kMaxHeadBlock = 8; // heads a y CTA shares its S tiles over
constexpr int kSCache = 4;       // S tiles a y CTA keeps in shared memory

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

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

// Floats of work space per (chunk, head): cum and dt rows of Qp each, then
// the scan's scratch; a multiple of 4, so every row starts 16-byte aligned.
__host__ __device__ inline int work_row(int Q) {
  return 2 * round_up(Q, kTile) + round_up(scan_scratch(Q), 4);
}

// The inclusive scan, in order, of the n <= 32 values p[0..n) in place, by
// one warp: each lane loads one value and the chain of adds runs through
// shuffles (no dependent loads).
__device__ inline void warp_scan_small(float* p, int n, int lane) {
  const float v = lane < n ? p[lane] : 0.f;
  float s = 0.f, mine = 0.f;
  for (int i = 0; i < n; ++i) {
    const float vi = __shfl_sync(0xffffffffu, v, i);
    s = i == 0 ? vi : __fadd_rn(s, vi);
    if (lane == i) mine = s;
  }
  if (lane < n) p[lane] = mine;
  __syncwarp();
}

// Row (b, h) of the work space [B, nh, work_row(Q)]: cum[Qp] = the prefix
// sums over Q of dA = dt * -exp(a_log), in the order of
// kernels/ref.py::prefix_sum, each product and add rounded on its own as
// there (__fmul_rn/__fadd_rn: nvcc would otherwise contract them into
// FMAs); then dt[Qp] as f32; both zero past Q; then the levels' block
// totals.  One warp per (chunk, head): its lanes take the blocks of 16 of
// each level, each block scanned in order by one lane.  Level 0 runs twice:
// first for the block totals, then, once the levels above are scanned, for
// the values themselves, each block's with the carry of the blocks before
// it added, written once.
template <typename TD>
__global__ void __launch_bounds__(128)
ssd_cum_kernel(const TD* __restrict__ dt, const float* __restrict__ a_log,
               float* __restrict__ work, int Q, int nh) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (h >= nh) return;
  const int64_t b = blockIdx.y;
  const int Qp = round_up(Q, kTile);
  const float a = -expf(a_log[h]);
  const TD* d = dt + b * Q * nh + h;                  // position j at d[j * nh]
  float* out = work + (b * nh + h) * work_row(Q);
  float* dto = out + Qp;
  float* sc = out + 2 * Qp;
  const int nb0 = (Q + kBlk - 1) / kBlk;
  for (int j = nb0 * kBlk + lane; j < Qp; j += 32) {
    out[j] = 0.f;
    dto[j] = 0.f;
  }
  // one block of level 0: its 16 values of dt (0 past Q) and its scan
  auto block = [&](int k, float (&dv)[kBlk], float (&cs)[kBlk]) {
#pragma unroll
    for (int m = 0; m < kBlk; ++m) {
      const int j = k * kBlk + m;
      dv[m] = j < Q ? to_f32(d[static_cast<int64_t>(j) * nh]) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kBlk; ++m) {
      const float v = k * kBlk + m < Q ? __fmul_rn(dv[m], a) : 0.f;
      cs[m] = m == 0 ? v : __fadd_rn(cs[m - 1], v);
    }
  };
  if (nb0 > 1) {
    // level 0's block totals are level 1
    for (int k = lane; k < nb0; k += 32) {
      float dv[kBlk], cs[kBlk];
      block(k, dv, cs);
      sc[k] = cs[kBlk - 1];
    }
    __syncwarp();
    // up: each level's values become scans within their blocks of 16, their
    // block totals the next level; the last level (<= 16) one scan
    int ns[8], offs[8], depth = 0;      // 16^8 > 2^31: at most 8 levels
    int n = nb0, off = 0;
    while (true) {
      ns[depth] = n;
      offs[depth] = off;
      ++depth;
      if (n <= kBlk) {
        warp_scan_small(sc + off, n, lane);
        break;
      }
      const int nb = (n + kBlk - 1) / kBlk;
      for (int k = lane; k < nb; k += 32) {
        float v[kBlk];
#pragma unroll
        for (int m = 0; m < kBlk; ++m) v[m] = k * kBlk + m < n ? sc[off + k * kBlk + m] : 0.f;
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < kBlk; ++m) {
          s = m == 0 ? v[m] : __fadd_rn(s, v[m]);
          if (k * kBlk + m < n) sc[off + k * kBlk + m] = s;
        }
        sc[off + n + k] = s;
      }
      __syncwarp();
      off += n;
      n = nb;
    }
    // down: add to each value past the first block the inclusive sum of the
    // blocks before its own, from the level above (final by then)
    for (int l = depth - 2; l >= 0; --l) {
      for (int i = kBlk + lane; i < ns[l]; i += 32)
        sc[offs[l] + i] = __fadd_rn(sc[offs[l] + i], sc[offs[l + 1] + i / kBlk - 1]);
      __syncwarp();
    }
  }
  // level 0 again: each block's scan plus the blocks before it
  for (int k = lane; k < nb0; k += 32) {
    float dv[kBlk], cs[kBlk];
    block(k, dv, cs);
    if (k > 0) {
      const float carry = sc[k - 1];
#pragma unroll
      for (int m = 0; m < kBlk; ++m) cs[m] = __fadd_rn(cs[m], carry);
    }
#pragma unroll
    for (int m = 0; m < kBlk; ++m)
      if (k * kBlk + m >= Q) cs[m] = 0.f;
    float4* o4 = reinterpret_cast<float4*>(out + k * kBlk);
    float4* d4 = reinterpret_cast<float4*>(dto + k * kBlk);
#pragma unroll
    for (int q = 0; q < kBlk / 4; ++q) {
      o4[q] = make_float4(cs[4 * q], cs[4 * q + 1], cs[4 * q + 2], cs[4 * q + 3]);
      d4[q] = make_float4(dv[4 * q], dv[4 * q + 1], dv[4 * q + 2], dv[4 * q + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch 2, bf16: wgmma
// ---------------------------------------------------------------------------

// Shared memory (byte offsets from a 1024-aligned base) of a CTA of either
// role.  HPB, DSB: hp and ds in column blocks of 64 (hp padded to 64 or
// 128, ds to 128 or 256; the copies zero-fill the padding).
//   C:  the y CTA's C tile [64][DSB*64];
//   R1: the y CTA's S cache, kSCache slots of which slot t first holds the
//       B tile t and then the f32 S tile t, or the ring of X and B tiles
//       of a y CTA that forms S anew per head, or the state CTA's ring of
//       X (64 columns) and B (128 columns) tiles;
//   R2: the y CTA's ring of X tiles;
//   K:  the ring's cum and dt of the tile's keys, 2 x [2][64] f32;
//   QC: the y CTA's heads' cum of its queries, [kMaxHeadBlock][64] f32.
// Every ring has two stages: the copy of item i+1 is in flight while item
// i is computed.

template <int HPB, int DSB>
struct Smem {
  static constexpr int kX = kSw128Block * HPB;
  static constexpr int kB = kSw128Block * DSB;
  static constexpr int kS = kTile * kTile * 4;
  static constexpr int kSlot = kS > kB ? kS : kB;
  static constexpr int kSt = kSw128Block * 3;               // state stage: X + B
  static constexpr int kR1 = kSCache * kSlot;
  static constexpr int oC = 0;
  static constexpr int oR1 = oC + kB;
  static constexpr int oR2 = oR1 + kR1;
  static constexpr int oK = oR2 + 2 * kX;
  static constexpr int oQC = oK + 2 * 2 * kTile * 4;
  static constexpr int kTotal = oQC + kMaxHeadBlock * kTile * 4 + 1024;  // + alignment slack
  static_assert(2 * (kX + kB) <= kR1 && 2 * kSt <= kR1, "the rings in R1 must fit it");
};

struct BArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* bm;
  const __nv_bfloat16* cm;
  const float* work;
  __nv_bfloat16* y;
  float* states;
  float* decay;
  int Q, nh, hp, ds, hb, n_y;
};

// cum and dt of the 64 keys from k0 of work row `row` into `ks` (cum at
// ks, dt at ks + 256 bytes): 32 threads, one 16-byte copy each.
__device__ __forceinline__ void load_keys(uint32_t ks, const float* row, int Qp, int k0) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    const int c = tid & 15;
    const float* src = row + (tid < 16 ? 0 : Qp) + k0 + c * 4;
    cp_async16(ks + (tid < 16 ? 0 : 256) + c * 16, src, true);
  }
}

// Accumulator layout of m64nN (PTX ISA, wgmma register fragments): thread
// (warp w, lane) holds rows 16w + lane/4 (i = 0) and +8 (i = 1), columns
// 8j + 2(lane%4) + e, j < N/8, e < 2, in d[4j + 2i + e].
template <int HPB, int DSB>
__device__ void y_role(const BArgs& A, uint32_t base, unsigned char* gbase, int b, int item) {
  using L = Smem<HPB, DSB>;
  const int nhb = (A.nh + A.hb - 1) / A.hb;
  const int nqt = (A.Q + kTile - 1) / kTile;
  const int qt = nqt - 1 - item / nhb;                 // longest tiles first
  const int h0 = (item % nhb) * A.hb;
  const int nhh = min(A.hb, A.nh - h0);
  const int q0 = qt * kTile;
  const int nkt = qt + 1;                              // key tiles to the diagonal
  const bool cached = nkt <= kSCache;
  const int Qp = round_up(A.Q, kTile);
  const int wrow = work_row(A.Q);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = 16 * warp + (lane >> 2);            // local row of i = 0
  const int col0 = 2 * (lane & 3);
  const int64_t xrow = static_cast<int64_t>(A.nh) * A.hp;
  const __nv_bfloat16* xb = A.x + static_cast<int64_t>(b) * A.Q * xrow;
  const __nv_bfloat16* bb = A.bm + static_cast<int64_t>(b) * A.Q * A.ds;
  const float* wb = A.work + static_cast<int64_t>(b) * A.nh * wrow;

  // the heads in turn, each over its key tiles: item it = (hh, t), through
  // the ring (X tiles; with B tiles when S is formed anew)
  const uint32_t ring = base + (cached ? L::oR2 : L::oR1);
  const int stage = cached ? L::kX : L::kX + L::kB;
  const int n_items = nhh * nkt;
  auto issue = [&](int it) {
    const int hh = it / nkt, t = it - hh * nkt, k0 = t * kTile;
    const int st = it & 1;
    const uint32_t dst = ring + st * stage;
    load_tile_sw128<HPB * 64, kThreads>(dst, xb + k0 * xrow + static_cast<int64_t>(h0 + hh) * A.hp,
                                        xrow, A.Q - k0, A.hp);
    if (!cached)
      load_tile_sw128<DSB * 64, kThreads>(dst + L::kX, bb + static_cast<int64_t>(k0) * A.ds, A.ds,
                                          A.Q - k0, A.ds);
    load_keys(base + L::oK + st * 512, wb + static_cast<int64_t>(h0 + hh) * wrow, Qp, k0);
  };

  // group 0: C, the heads' query cum and, when the cache fills, every B
  // tile into its slot; then the ring's first two items, one group each
  load_tile_sw128<DSB * 64, kThreads>(base + L::oC, A.cm + (static_cast<int64_t>(b) * A.Q + q0) * A.ds,
                                      A.ds, A.Q - q0, A.ds);
  for (int i = tid; i < nhh * 16; i += kThreads) {
    const int hh = i >> 4, c = i & 15;
    cp_async16(base + L::oQC + hh * 256 + c * 16, wb + static_cast<int64_t>(h0 + hh) * wrow + q0 + c * 4,
               true);
  }
  if (cached) {
    for (int t = 0; t < nkt; ++t)
      load_tile_sw128<DSB * 64, kThreads>(base + L::oR1 + t * L::kSlot,
                                          bb + static_cast<int64_t>(t) * kTile * A.ds, A.ds,
                                          A.Q - t * kTile, A.ds);
  }
  cp_async_commit();
  for (int p = 0; p < 2; ++p) {
    if (p < n_items) issue(p);
    cp_async_commit();
  }
  const float* cq = reinterpret_cast<const float*>(gbase + L::oQC);

  if (cached) {
    // the query tile's S tiles, once for all its heads: S tile t replaces
    // B tile t in its slot
    cp_async_wait<2>();      // group 0
    fence_proxy_async();
    __syncthreads();
    for (int t = 0; t < nkt; ++t) {
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DSB * 4; ++kk) {
        const uint32_t off = (kk / 4) * kSw128Block + (kk % 4) * 32;
        wgmma_ss(s, sw128_desc(base + L::oC + off), sw128_desc(base + L::oR1 + t * L::kSlot + off));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      __syncthreads();   // every warp's products have read B tile t
      float4* slot = reinterpret_cast<float4*>(gbase + L::oR1 + t * L::kSlot) + tid;
#pragma unroll
      for (int v = 0; v < 8; ++v)
        slot[v * kThreads] = make_float4(s[4 * v], s[4 * v + 1], s[4 * v + 2], s[4 * v + 3]);
    }
  }

  float yacc[HPB][32];
#pragma unroll
  for (int nb = 0; nb < HPB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[nb][i] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    const int hh = it / nkt, t = it - hh * nkt;
    cp_async_wait<1>();      // all but the newest group: item it has landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t xs = ring + st * stage;

    float s[32];
    if (cached) {
      const float4* slot = reinterpret_cast<const float4*>(gbase + L::oR1 + t * L::kSlot) + tid;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float4 f = slot[v * kThreads];
        s[4 * v] = f.x;
        s[4 * v + 1] = f.y;
        s[4 * v + 2] = f.z;
        s[4 * v + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DSB * 4; ++kk) {
        const uint32_t off = (kk / 4) * kSw128Block + (kk % 4) * 32;
        wgmma_ss(s, sw128_desc(base + L::oC + off), sw128_desc(xs + L::kX + off));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
    }

    // W = S exp(clip(cum_i - cum_j)) dt_j for j <= i, 0 above the diagonal
    // (masked explicitly: there the clip would give exp(0) = 1)
    const float* ck = reinterpret_cast<const float*>(gbase + L::oK + st * 512);
    const float* dk = ck + kTile;
    const float ci[2] = {cq[hh * kTile + row0], cq[hh * kTile + row0 + 8]};
    const bool diag = t == qt;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 cj = *reinterpret_cast<const float2*>(ck + 8 * j + col0);
      const float2 dj = *reinterpret_cast<const float2*>(dk + 8 * j + col0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float w0 = s[4 * j + 2 * i] * __expf(fminf(fmaxf(ci[i] - cj.x, -60.f), 0.f)) * dj.x;
        float w1 = s[4 * j + 2 * i + 1] * __expf(fminf(fmaxf(ci[i] - cj.y, -60.f), 0.f)) * dj.y;
        if (diag) {
          const int r = row0 + 8 * i, c = 8 * j + col0;
          if (c > r) w0 = 0.f;
          if (c + 1 > r) w1 = 0.f;
        }
        s[4 * j + 2 * i] = w0;
        s[4 * j + 2 * i + 1] = w1;
      }
    }
    // W as bf16 hi and lo A fragments: keys 16kk..16kk+15 are the
    // accumulator's columns j = 2kk, 2kk+1
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float a0 = s[8 * kk + 2 * q], a1 = s[8 * kk + 2 * q + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a0, a1);
        const float2 hf = __bfloat1622float2(hi);
        ahi[kk][q] = *reinterpret_cast<const uint32_t*>(&hi);
        alo[kk][q] = pack_bf16(a0 - hf.x, a1 - hf.y);
      }

    // Y += W X
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < HPB; ++nb) {
        const uint64_t dx = sw128_desc(xs + nb * kSw128Block + kk * 16 * 128);
        wgmma_rs(yacc[nb], ahi[kk], dx);
        wgmma_rs(yacc[nb], alo[kk], dx);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < HPB; ++nb) fence_regs(yacc[nb]);

    if (t == qt) {           // the head's last tile: write and reset Y
      __nv_bfloat16* yb = A.y + (static_cast<int64_t>(b) * A.Q + q0) * xrow +
                          static_cast<int64_t>(h0 + hh) * A.hp;
#pragma unroll
      for (int nb = 0; nb < HPB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = row0 + 8 * i;
            const int c = nb * 64 + 8 * j + col0;
            if (q0 + r < A.Q && c < A.hp)
              *reinterpret_cast<__nv_bfloat162*>(yb + r * xrow + c) =
                  __floats2bfloat162_rn(yacc[nb][4 * j + 2 * i], yacc[nb][4 * j + 2 * i + 1]);
            yacc[nb][4 * j + 2 * i] = 0.f;
            yacc[nb][4 * j + 2 * i + 1] = 0.f;
          }
    }
    __syncthreads();         // stage st is free: the copy of item it+2
    if (it + 2 < n_items) issue(it + 2);
    cp_async_commit();
  }
}

// state [hp, ds] block (rows mb*64.., columns nb*128..) of one (chunk,
// head), and its decay_total.
template <int HPB, int DSB>
__device__ void state_role(const BArgs& A, uint32_t base, unsigned char* gbase, int b, int item) {
  using L = Smem<HPB, DSB>;
  constexpr int kStX = kSw128Block, kStage = L::kSt;
  const int nmb = (A.hp + 63) / 64, nnb = (A.ds + 127) / 128;
  const int h = item / (nmb * nnb);
  const int mb = (item / nnb) % nmb, nb = item % nnb;
  const int Qp = round_up(A.Q, kTile);
  const int wrow = work_row(A.Q);
  const int n_tiles = Qp / kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t xrow = static_cast<int64_t>(A.nh) * A.hp;
  const __nv_bfloat16* xb = A.x + static_cast<int64_t>(b) * A.Q * xrow +
                            static_cast<int64_t>(h) * A.hp + mb * 64;
  const __nv_bfloat16* bb = A.bm + static_cast<int64_t>(b) * A.Q * A.ds + nb * 128;
  const float* wr = A.work + (static_cast<int64_t>(b) * A.nh + h) * wrow;
  const float cum_last = wr[A.Q - 1];
  if (tid == 0 && mb == 0 && nb == 0) A.decay[b * A.nh + h] = decay_of(cum_last);

  const uint32_t ring = base + L::oR1;
  auto issue = [&](int t) {
    const int k0 = t * kTile, st = t & 1;
    const uint32_t dst = ring + st * kStage;
    load_tile_sw128<64, kThreads>(dst, xb + k0 * xrow, xrow, A.Q - k0, A.hp - mb * 64);
    load_tile_sw128<128, kThreads>(dst + kStX, bb + static_cast<int64_t>(k0) * A.ds, A.ds, A.Q - k0,
                                   A.ds - nb * 128);
    load_keys(base + L::oK + st * 512, wr, Qp, k0);
  };
  for (int p = 0; p < 2; ++p) {
    if (p < n_tiles) issue(p);
    cp_async_commit();
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    cp_async_wait<1>();      // all but the newest group: tile t has landed
    __syncthreads();
    // x -> bf16(x dt exp(clip(cum_last - cum_j))), in place: a row of the
    // X tile is 128 contiguous bytes (the swizzle permutes within it)
    const uint32_t xs = ring + st * kStage;
    const float* ck = reinterpret_cast<const float*>(gbase + L::oK + st * 512);
    const float* dk = ck + kTile;
    uint4* xv = reinterpret_cast<uint4*>(gbase + (xs - base));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = tid + k * kThreads;       // 16-byte chunk of 512
      const int r = i >> 3;
      const float f = dk[r] * decay_of(cum_last - ck[r]);
      uint4 raw = xv[i];
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = __bfloat1622float2(e[q]);
        e[q] = __floats2bfloat162_rn(v.x * f, v.y * f);
      }
      xv[i] = raw;
    }
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_m64n128_mn(acc, sw128_desc(xs + kk * 16 * 128),
                          sw128_desc(xs + kStX + kk * 16 * 128, kSw128Block));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();         // stage st is free: the copy of tile t+2
    if (t + 2 < n_tiles) issue(t + 2);
    cp_async_commit();
  }
  float* sb = A.states + (static_cast<int64_t>(b) * A.nh + h) * A.hp * A.ds;
  const int row0 = 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = mb * 64 + row0 + 8 * i;
      const int c = nb * 128 + 8 * j + col0;
      if (p < A.hp && c < A.ds)
        *reinterpret_cast<float2*>(sb + static_cast<int64_t>(p) * A.ds + c) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
}

// grid (B, n_y + n_state): blockIdx.x the chunk; blockIdx.y < n_y a y CTA
// (the longest query tiles first), the rest state CTAs.
template <int HPB, int DSB>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_bf16_kernel(BArgs A) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int b = blockIdx.x, item = blockIdx.y;
  if (item < A.n_y)
    y_role<HPB, DSB>(A, base, gbase, b, item);
  else
    state_role<HPB, DSB>(A, base, gbase, b, item - A.n_y);
}

template <int HPB, int DSB>
int launch_bf16(const BArgs& A, int B, cudaStream_t stream) {
  constexpr int smem = Smem<HPB, DSB>::kTotal;
  auto kernel = ssd_chunk_bf16_kernel<HPB, DSB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_state = A.nh * ((A.hp + 63) / 64) * ((A.ds + 127) / 128);
  if (A.n_y + n_state > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  dim3 grid(B, A.n_y + n_state);
  kernel<<<grid, kThreads, smem, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// launch 2, f32: FMA units, tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int kStateAcc = 8;     // state accumulator tiles per warp per pass

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory layout: byte offsets and row strides (in floats); rows
// padded by 16 bytes.
struct Layout {
  int ldc, ldx, lds, ldw, ldo;
  size_t c, b, x, s, w, cq, ck, dk, co, total;
};

__host__ __device__ inline Layout layout_f32(int hp, int ds) {
  Layout L;
  L.ldc = ds + 4;
  L.ldx = hp + 4;
  L.lds = kTile + 4;
  L.ldw = kTile + 4;
  L.ldo = hp + 4;
  size_t off = 0;
  L.c = off; off = align128(off + sizeof(float) * kTile * L.ldc);
  L.b = off; off = align128(off + sizeof(float) * kTile * L.ldc);
  L.x = off; off = align128(off + sizeof(float) * kTile * L.ldx);
  L.s = off; off = align128(off + sizeof(float) * kTile * L.lds);
  L.w = off; off = align128(off + sizeof(float) * kTile * L.ldw);
  // the y staging tile [kTile][ldo] reuses the region above once the key
  // loop is done
  const size_t stage = align128(sizeof(float) * kTile * L.ldo);
  off = off > stage ? off : stage;
  L.cq = off; off += sizeof(float) * kTile;
  L.ck = off; off += sizeof(float) * kTile;
  L.dk = off; off += sizeof(float) * kTile;
  L.co = off; off += sizeof(float) * kTile;
  L.total = align128(off);
  return L;
}

// A 16x16 f32 tile owned by one warp: lane l holds row l/2, columns
// (l%2)*8 .. +8.
struct AccF32 {
  float v[8];
};

__device__ inline void zero(AccF32& acc) {
#pragma unroll
  for (int c = 0; c < 8; ++c) acc.v[c] = 0.f;
}

// acc += A B; A, B row-major 16x16
__device__ inline void mma_ab(AccF32& acc, const float* a, int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float av = a[r * lda + k];
    const float* brow = b + k * ldb + c0;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc.v[c] = fmaf(av, brow[c], acc.v[c]);
  }
}

// acc += A B^T; A row-major 16x16, B stored row-major as [n][k]
__device__ inline void mma_abt(AccF32& acc, const float* a, int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float av = a[r * lda + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc.v[c] = fmaf(av, b[(c0 + c) * ldb + k], acc.v[c]);
  }
}

// acc += A^T B; A stored row-major as [k][m], B row-major 16x16
__device__ inline void mma_atb(AccF32& acc, const float* a, int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float av = a[k * lda + r];
    const float* brow = b + k * ldb + c0;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc.v[c] = fmaf(av, brow[c], acc.v[c]);
  }
}

__device__ inline void store(float* dst, int ld, const AccF32& acc) {
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int c = 0; c < 8; ++c) dst[r * ld + c0 + c] = acc.v[c];
}

// kTile x cols tile of a [*, row_stride] tensor into shared memory
// [kTile][ld]; rows at or past `valid` are zero.  `vec`: 16-byte loads
// (the caller checked the alignment).
__device__ inline void load_tile_f32(float* dst, int ld, const float* src, int64_t row_stride,
                                     int valid, int cols, int vec) {
  if (vec) {
    const int vpr = cols / 4;
    for (int i = threadIdx.x; i < kTile * vpr; i += kThreads) {
      const int r = i / vpr, c = (i - r * vpr) * 4;
      float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < valid) raw = *reinterpret_cast<const float4*>(src + r * row_stride + c);
      *reinterpret_cast<float4*>(dst + r * ld + c) = raw;
    }
  } else {
    for (int i = threadIdx.x; i < kTile * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = r < valid ? src[r * row_stride + c] : 0.f;
    }
  }
}

// cum and dt of the kTile keys from k0 (work row `wr`) into shared memory
__device__ inline void load_cum(float* ck, float* dk, const float* wr, int Qp, int k0) {
  const int j = threadIdx.x;
  if (j < kTile) {
    ck[j] = wr[k0 + j];
    dk[j] = wr[Qp + k0 + j];
  }
}

struct FArgs {
  int Q, Qp, nh, hp, ds, vec;
  int64_t xrow;       // elements between positions of x and y (nh * hp)
};

// y for query rows [q0, q0 + kTile) of one (chunk, head).
__device__ void y_tile_f32(const Layout& L, unsigned char* smem, const FArgs& A, const float* xb,
                           const float* bb, const float* cb, const float* wr, float* yb, int qt) {
  float* cs = reinterpret_cast<float*>(smem + L.c);
  float* bs = reinterpret_cast<float*>(smem + L.b);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* ws = reinterpret_cast<float*>(smem + L.w);
  float* os = reinterpret_cast<float*>(smem);
  float* cq = reinterpret_cast<float*>(smem + L.cq);
  float* ck = reinterpret_cast<float*>(smem + L.ck);
  float* dk = reinterpret_cast<float*>(smem + L.dk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * 16;
  const int q0 = qt * kTile;

  load_tile_f32(cs, L.ldc, cb + static_cast<int64_t>(q0) * A.ds, A.ds, A.Q - q0, A.ds, A.vec);
  if (tid < kTile) cq[tid] = wr[q0 + tid];

  const int nf = A.hp / 16;
  AccF32 yacc[kMaxHp / 16];
#pragma unroll
  for (int f = 0; f < kMaxHp / 16; ++f)
    if (f < nf) zero(yacc[f]);

  for (int t = 0; t <= qt; ++t) {
    const int k0 = t * kTile;
    __syncthreads();   // the previous tile's B, X, S and W reads are done
    load_tile_f32(bs, L.ldc, bb + static_cast<int64_t>(k0) * A.ds, A.ds, A.Q - k0, A.ds, A.vec);
    load_tile_f32(xs, L.ldx, xb + k0 * A.xrow, A.xrow, A.Q - k0, A.hp, A.vec);
    load_cum(ck, dk, wr, A.Qp, k0);
    __syncthreads();

    // S = C B^T for this warp's 16 query rows (warp-private rows of S, W)
    for (int n = 0; n < kTile / 16; ++n) {
      AccF32 acc;
      zero(acc);
      for (int kk = 0; kk < A.ds; kk += 16)
        mma_abt(acc, cs + r0 * L.ldc + kk, L.ldc, bs + n * 16 * L.ldc + kk, L.ldc);
      store(ss + r0 * L.lds + n * 16, L.lds, acc);
    }
    __syncwarp();
    // W = S exp(clip(cum_i - cum_j)) dt_j for j <= i, 0 above the diagonal
    {
      const int r = r0 + (lane >> 1);
      const int i_abs = q0 + r;
      const float ci = cq[r];
#pragma unroll 4
      for (int jj = 0; jj < kTile / 2; ++jj) {
        const int j = 2 * jj + (lane & 1);
        float w = 0.f;
        if (k0 + j <= i_abs) w = ss[r * L.lds + j] * decay_of(ci - ck[j]) * dk[j];
        ws[r * L.ldw + j] = w;
      }
    }
    __syncwarp();
    // Y += W X
    for (int kk = 0; kk < kTile; kk += 16) {
#pragma unroll
      for (int f = 0; f < kMaxHp / 16; ++f)
        if (f < nf) mma_ab(yacc[f], ws + r0 * L.ldw + kk, L.ldw, xs + kk * L.ldx + f * 16, L.ldx);
    }
  }
  __syncthreads();   // every warp is done with the tiles the staging reuses
#pragma unroll
  for (int f = 0; f < kMaxHp / 16; ++f)
    if (f < nf) store(os + r0 * L.ldo + f * 16, L.ldo, yacc[f]);
  __syncthreads();
  const int valid = min(kTile, A.Q - q0);
  float* yq = yb + q0 * A.xrow;
  for (int i = tid; i < valid * A.hp; i += kThreads) {
    const int r = i / A.hp, p = i - r * A.hp;
    yq[r * A.xrow + p] = os[r * L.ldo + p];
  }
}

// state [hp, ds] and decay_total of one (chunk, head).
__device__ void state_tile_f32(const Layout& L, unsigned char* smem, const FArgs& A,
                               const float* xb, const float* bb, const float* wr, float* st,
                               float* dec) {
  float* bs = reinterpret_cast<float*>(smem + L.b);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  float* ck = reinterpret_cast<float*>(smem + L.ck);
  float* dk = reinterpret_cast<float*>(smem + L.dk);
  float* co = reinterpret_cast<float*>(smem + L.co);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_tiles = (A.Q + kTile - 1) / kTile;
  const float cum_last = wr[A.Q - 1];
  if (tid == 0) *dec = decay_of(cum_last);

  const int nsi = A.ds / 16;
  const int n_acc = (A.hp / 16) * nsi;      // 16x16 tiles of the state
  for (int f0 = 0; f0 < n_acc; f0 += 4 * kStateAcc) {
    AccF32 acc[kStateAcc];
#pragma unroll
    for (int i = 0; i < kStateAcc; ++i) zero(acc[i]);
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kTile;
      __syncthreads();   // the previous tile's reads are done
      load_tile_f32(bs, L.ldc, bb + static_cast<int64_t>(k0) * A.ds, A.ds, A.Q - k0, A.ds, A.vec);
      load_tile_f32(xs, L.ldx, xb + k0 * A.xrow, A.xrow, A.Q - k0, A.hp, A.vec);
      load_cum(ck, dk, wr, A.Qp, k0);
      __syncthreads();
      if (tid < kTile) co[tid] = decay_of(cum_last - ck[tid]);
      __syncthreads();
      // x -> (x dt) exp(clip(cum_last - cum_j)), in place
      for (int i = tid; i < kTile * A.hp; i += kThreads) {
        const int r = i / A.hp, p = i - r * A.hp;
        xs[r * L.ldx + p] = xs[r * L.ldx + p] * dk[r] * co[r];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kStateAcc; ++i) {
        const int f = f0 + warp * kStateAcc + i;
        if (f < n_acc) {
          const int pi = f / nsi, si = f - pi * nsi;
          for (int kk = 0; kk < kTile; kk += 16)
            mma_atb(acc[i], xs + kk * L.ldx + pi * 16, L.ldx, bs + kk * L.ldc + si * 16, L.ldc);
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
__global__ void __launch_bounds__(kThreads)
ssd_chunk_f32_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                     const float* __restrict__ cm, const float* __restrict__ work,
                     float* __restrict__ y, float* __restrict__ states,
                     float* __restrict__ decay, int Q, int nh, int hp, int ds, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout_f32(hp, ds);
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  FArgs A;
  A.Q = Q;
  A.Qp = round_up(Q, kTile);
  A.nh = nh;
  A.hp = hp;
  A.ds = ds;
  A.vec = vec;
  A.xrow = static_cast<int64_t>(nh) * hp;
  const float* xb = x + b * Q * A.xrow + static_cast<int64_t>(h) * hp;
  const float* bb = bm + b * Q * ds;
  const float* wr = work + (b * nh + h) * work_row(Q);
  if (blockIdx.x == 0) {
    state_tile_f32(L, smem, A, xb, bb, wr, states + (b * nh + h) * hp * ds, decay + b * nh + h);
  } else {
    y_tile_f32(L, smem, A, xb, bb, cm + b * Q * ds, wr,
               y + b * Q * A.xrow + static_cast<int64_t>(h) * hp, gridDim.x - 1 - blockIdx.x);
  }
}

int launch_f32(const void* x, const void* b, const void* c, const void* work, void* y,
               void* states, void* decay, int B, int Q, int nh, int hp, int ds, int vec,
               cudaStream_t stream) {
  const Layout L = layout_f32(hp, ds);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Q + kTile - 1) / kTile + 1, nh, B);
  ssd_chunk_f32_kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(work), static_cast<float*>(y), static_cast<float*>(states),
      static_cast<float*>(decay), Q, nh, hp, ds, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD>
int launch_cum(const void* dt, const void* a_log, void* work, int B, int Q, int nh,
               cudaStream_t stream) {
  dim3 grid((nh + 3) / 4, B);
  ssd_cum_kernel<TD><<<grid, 128, 0, stream>>>(static_cast<const TD*>(dt),
                                               static_cast<const float*>(a_log),
                                               static_cast<float*>(work), Q, nh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// Floats of work space per (chunk, head) that repro_ssd_chunk needs.
extern "C" int repro_ssd_chunk_scratch(int Q) {
  return repro_torch::work_row(Q);
}

// x, y: [B, Q, nh, hp] and b, c: [B, Q, ds] of storage type `dtype`; dt:
// [B, Q, nh] of type `dt_dtype` (f32, or `dtype`); a_log [nh], states
// [B, nh, hp, ds] and decay [B, nh] f32; work [B, nh,
// repro_ssd_chunk_scratch(Q)] f32 work space (its rows hold the prefix sums
// of dA and dt afterwards); all contiguous.  hp a multiple of 16 up to
// 128, ds a multiple of 16 up to 256.  `head_block`: heads a bf16 y CTA
// shares its S tiles over, 1 to 8 (kernels/ssd_scan.py::ssd_head_block).
// `vec` != 0 says x, b and c are 16-byte aligned: the f32 path then takes
// 16-byte loads, and the bf16 path needs it.  Two launches; returns
// cudaGetLastError() after them.
extern "C" int repro_ssd_chunk(const void* x, const void* b, const void* c, const void* dt,
                               const void* a_log, void* y, void* states, void* decay,
                               void* work, int B, int Q, int nh, int hp, int ds,
                               int head_block, int dtype, int dt_dtype, int vec, void* stream) {
  using namespace repro_torch;
  if (B < 1 || Q < 1 || nh < 1 || hp < 16 || hp > kMaxHp || hp % 16 != 0 || ds < 16 ||
      ds > kMaxDs || ds % 16 != 0 || nh > 65535 || B > 65535 || head_block < 1 ||
      head_block > kMaxHeadBlock || (dt_dtype != kF32 && dt_dtype != dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = dt_dtype == kF32 ? launch_cum<float>(dt, a_log, work, B, Q, nh, s)
                            : launch_cum<__nv_bfloat16>(dt, a_log, work, B, Q, nh, s);
  if (rc != 0) return rc;
  switch (dtype) {
    case kF32: return launch_f32(x, b, c, work, y, states, decay, B, Q, nh, hp, ds, vec, s);
    case kBF16: {
      if (!vec) return static_cast<int>(cudaErrorMisalignedAddress);
      BArgs A;
      A.x = static_cast<const __nv_bfloat16*>(x);
      A.bm = static_cast<const __nv_bfloat16*>(b);
      A.cm = static_cast<const __nv_bfloat16*>(c);
      A.work = static_cast<const float*>(work);
      A.y = static_cast<__nv_bfloat16*>(y);
      A.states = static_cast<float*>(states);
      A.decay = static_cast<float*>(decay);
      A.Q = Q;
      A.nh = nh;
      A.hp = hp;
      A.ds = ds;
      A.hb = head_block;
      A.n_y = ((Q + kTile - 1) / kTile) * ((nh + head_block - 1) / head_block);
      if (hp <= 64)
        return ds <= 128 ? launch_bf16<1, 2>(A, B, s) : launch_bf16<1, 4>(A, B, s);
      return ds <= 128 ? launch_bf16<2, 2>(A, B, s) : launch_bf16<2, 4>(A, B, s);
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// FCM accumulation sweep (BigFCM paper, Alg. 1 body) for Hopper, sm_90a.
//
// Replaces repro/kernels/fcm_update.py::_fcm_tile_kernel (reached through
// fcm_accumulate_pallas and fcm_sweep_pallas) and, through the tile
// kernel's tenant axis, its jax.vmap in repro/engine/backend.py:216-232
// (the tenant-stacked sweep of fcm_converge_batched) wherever C*d is past
// fcm_batched.cu's rows kernel.  For records x (N, d) with weights w (N,)
// and centers V (C, d) (per tenant t: x_t, w_t, V_t and m_t), in IEEE fp32:
//
//   d2[k][i] = max(|x_k|^2 + |v_i|^2 - 2 x_k.v_i, 1e-12)
//   u[k][i]  = r_i / sum_j r_j,   r_i = exp(-(log d2_i - min_j log d2_j) / (m - 1))
//   wum      = u^m * w_k
//   v_num[i][j] = sum_k wum[k][i] x_k[j],  w_i = sum_k wum[k][i],  q = sum wum * d2
//
// and, for the sweep entry, v_new = v_num / max(w_i, 1e-12).
//
// What bounds it on an H100: it reads N*(d+1)*4 bytes once and does about
// 4*N*C*d flops.  At 3.35 TB/s and 67 TFLOP/s (f32 outside the tensor
// cores) the sweep is bound by memory below C*d/(d+1) ~ 20 centers and by
// f32 arithmetic above.  No tensor cores: TF32 would break the d2
// cancellation.  With both contraction operands read from shared memory
// per FMA, shared-memory bandwidth (128 bytes a clock per SM) caps the FMA
// rate at 1/8 of the f32 peak; the membership's logf/expf per (record,
// center) cost about as many instructions again as the two contractions
// at C = 23, d = 41.
//
// Three paths, chosen by kernels/fcm_update.py's launch plan (which sends
// the rest to fcm_ctiled.cu's C-tiled sweep):
//
//  * Small C*d (d <= 32 and C small enough, e.g. HIGGS-like d = 28, C = 2):
//    the tenant-stacked source's register-resident fcm_rows_kernel at
//    T = 1 with row splits (fcm_batched.cu), which this file does not
//    repeat.
//  * fcm_tile_kernel<RC> (this file), for C <= 128 and C*d up to a few
//    thousand (KDD99-like d = 41, C = 23): a register-blocked tile
//    contraction.  A persistent grid of CTAs walks row tiles; each tile of
//    x and w arrives by a double-buffered 4-byte cp.async while the
//    previous one is computed.  d2 = x.V^T is computed in micro-tiles of 4
//    records x RC centers per thread from operands it loads into
//    registers once per k, so each shared load feeds 4*RC/(4 + RC) FMAs
//    instead of 1/2.  The cg threads that share a record are neighbouring
//    lanes, and the membership's min and sum over centers are xor
//    shuffles among them (fcm_common.cuh's form: no powf).  v_num +=
//    wum^T.x runs in micro-tiles of 4 centers x 8 dims over a fixed
//    subset of the tile's records, and v_num, w_i and q stay in registers
//    for the CTA's whole walk: no per-tile global read-modify-write.  The
//    x and wum rows are 16-byte aligned, so a record's 8 dims and 4
//    centers arrive as three float4 shared loads.  At the end the row
//    subsets are summed in order, each CTA writes one partial, and the
//    last CTAs to finish sum the partials in CTA order, each one slice of
//    the outputs (fcm::finish_partials): no second launch.  At small N
//    (the driver's 2048- and 3184-row blocks) the tile shrinks so that the
//    grid still covers the SMs.
//    fcm_tile_tenants_kernel<RC> (this file) is the same kernel with a
//    tenant axis (T models in one launch, C*d past the rows kernel, such
//    as a tenant cohort at KDD99 width): both run the same stages (the
//    tile_* device functions), each with its own walk; its note says
//    where they differ.  CTA b owns split b % S of tenant b / S,
//    reading x_t, w_t, V_t and m_t (or a scalar m).  A tenant's N is cut
//    into tiles of at most the cap within one record of each other (300
//    rows: 3 x 100; more, down to 64 records, where that gives the splits
//    to fill the card).  Where the tenants alone fill the card, S = 1: the
//    CTA walks its tenant alone, first scanning its weights so that the
//    trailing zero-weight phantom rows of the bucket are not walked (they
//    would add exact zeros), and writes v_new (or v_num), w_i and q
//    itself: no partial, no ticket.  With fewer tenants the rows split
//    across S CTAs and each tenant's last CTA sums its partials in split
//    order.  It replaces the first tenant-stacked version, which staged
//    128-row tiles by synchronous 4-byte loads, formed each d2 as one
//    serial scalar dot, ran the membership on one thread per row with
//    powf, summed each of its C*d + C outputs serially over a tile's rows
//    and added its partials in a second launch.
//  * fcm_wide_kernel<MC, MD> (this file), for C*d past the tile kernel's
//    micro-tiles while V and one record fit one block's shared memory,
//    where the card measured it faster than the C-tiled kernel, such as
//    an LM's d_model at C = 16 (the curriculum's d = 1536, Qwen2-1.5B).
//    There the bound is bytes: a 65,536 x 1536 sweep reads 0.40 GB
//    (0.1203 ms at 3.35 TB/s) and does 6.4 GFLOP (0.096 ms at
//    67 TFLOP/s), so x must be read once and both contractions kept near
//    the FMA rate.  It replaces the first version, which staged 21-row
//    tiles by synchronous 4-byte loads, formed each d2 as one serial
//    scalar dot, ran the membership on one thread per row with powf,
//    read and wrote its partial v_num in device memory after every tile
//    (0.61 GB of L2 traffic per sweep) and summed the partials in a
//    second launch.
//    - d is split across a cluster of S CTAs (thread-block clusters, up
//      to 16), 512 threads each: CTA s holds dims [s*ds, (s+1)*ds) of V
//      (resident) and of each tile, so that its share of v_num fits its
//      registers (MC x MD = 16 a thread, for the whole walk) and a
//      tile's slice fits shared memory beside the next one.  x is read
//      from device memory once: 16-byte cp.async (4-byte where
//      d % 4 != 0) into the other tile buffer while a tile is computed.
//    - x.v and |x|^2 in 4-record x 4-center register micro-tiles (eight
//      16-byte shared loads per 64 FMAs, the warp's 8 records in distinct
//      banks), the slice's dims split between k-groups of threads summed
//      in group order; each CTA stores its slice's sums into every CTA's
//      shared memory (distributed shared memory), and after one cluster
//      barrier each adds the S posts in rank order, so all S form the
//      same d2 (and |v|^2 the same way, once), with no trip to device
//      memory.
//    - the membership on every thread: 512 / R lanes per record (at most
//      32), fcm_common.cuh's log-space form (one logf and two expf per
//      record and center, no powf), the min and the sum over centers by
//      xor shuffles among them.
//    - v_num += wum^T x over the CTA's slice from the tile it already
//      holds, MC centers x MD dims a thread (two 16-byte loads of wum,
//      the same for the warp, and one 8-byte load of x per 16 FMAs);
//      rank 0 also sums w_i and q.  Each cluster writes one partial at
//      the end, and the last CTAs to finish sum the partials in cluster
//      order (fcm::finish_partials): no second launch.  The grid is at
//      most the clusters the card holds at once, since that reduce waits
//      for every CTA.
//    - at small N (the driver's 2048-row blocks, 2C-point merges) the
//      tile shrinks and d splits across more CTAs until they cover half
//      the SMs (covering all of them was measured slower).
//    A record equal to a center gets d2 = 0 exactly: |v|^2, |x|^2 and x.v
//    run through the same k-groups, fmaf order and sums.
//
// No float atomics anywhere: for a fixed shape and card the summation
// order is fixed, so two runs on the same input are bit-identical.  This
// stands in for the TPU kernel's revisited output block, which relies on a
// sequential grid that CUDA does not have.  Offsets into x are 64-bit:
// N*d exceeds 2^31 at the paper's sizes.

#include <cooperative_groups.h>
#include <stdint.h>

#include "fcm_common.cuh"

namespace {

constexpr float kD2Floor = 1e-12f;

// -------------------------------------------------- register-blocked tile --

constexpr int kTileBlock = 256;
constexpr int kRM = 4;               // records per thread in the d2 micro-tile
constexpr int kAC = 4, kAD = 8;      // centers x dims per thread in the v_num micro-tile

struct TileLayout {   // offsets into dynamic shared memory, in floats
  int ldv, ldx, ldc;  // padded row strides of V, the x tiles, the wum tile
  size_t v, v2, x0, w0, x1, w1, scr, scw, wum, red, total;
};

__host__ __device__ inline size_t round4(size_t a) { return (a + 3) & ~(size_t)3; }

// The x and w tiles (two buffers each) share their floats with the end
// reduce's per-row-subset sums (scr: v_num, scw: w_i), used after the walk.
// The x and wum rows start on 16-byte boundaries, so that the v_num
// micro-tile reads its 8 dims and 4 centers of a record as float4s; x's
// stride is 4 mod 8 floats, so the d2 phase's 4 or 8 record rows of a warp
// fall in distinct banks.  Each x buffer ends in 8 spare floats for the
// float4 reads past a record's d-th dim (into sums that are never written).
__host__ __device__ inline TileLayout tile_layout(int d, int c, int tr, int rs, int ag,
                                                  int dg) {
  TileLayout L;
  L.ldv = d | 1;
  L.ldx = (int)round4(d) | 4;
  L.ldc = (int)round4(c);
  size_t o = 0;
  L.v = o;   o += (size_t)c * L.ldv;
  L.v2 = o;  o = round4(o + c);
  const size_t xbuf = (size_t)tr * L.ldx + 8, wbuf = round4(tr);
  const size_t tiles = 2 * (xbuf + wbuf);
  const size_t scr = (size_t)rs * ag * dg * kAC * kAD;
  const size_t scratch = scr + (size_t)rs * ag * kAC;
  L.x0 = o;
  L.w0 = L.x0 + xbuf;
  L.x1 = L.w0 + wbuf;
  L.w1 = L.x1 + xbuf;
  L.scr = o;
  L.scw = o + scr;
  o = round4(o + (tiles > scratch ? tiles : scratch));
  L.wum = o; o += (size_t)tr * L.ldc;
  L.red = o; o += kTileBlock / 32;
  L.total = o;
  return L;
}

// The tile loop's stages, one bit each (all of them unless a timing
// harness builds this file with some left out): 1 the x and w tile loads,
// 2 x.v and |x|^2, 4 the membership, 8 the contraction.  Only the tenant
// kernel reads them.
#ifndef FCM_TILE_STAGES
#define FCM_TILE_STAGES 15
#endif
constexpr int kTileStages = FCM_TILE_STAGES;

// ---- the stages both tile kernels run (fcm_tile_kernel, one model, and
// fcm_tile_tenants_kernel, a tenant axis); kChains fmaf chains for |x|^2,
// |v|^2 and x.v (the dims k = chain mod kChains, added at the end), and
// the membership's shuffles kIl records at a time.

// |v_i|^2 from device memory into v2_s, in the fmaf chains a record's
// |x|^2 and x.v take (`tile_dots`), so that a record equal to a center
// gets d2 = 0 exactly.
template <int kChains>
__device__ __forceinline__ void tile_center_norms(const float* __restrict__ v, int d,
                                                  int c, float* v2_s) {
  for (int i = threadIdx.x; i < c; i += kTileBlock) {
    const float* vi = v + i * d;
    float s = 0.f;
    if constexpr (kChains == 1) {
      for (int k = 0; k < d; ++k) s = fmaf(__ldg(vi + k), __ldg(vi + k), s);
    } else {
      float sb = 0.f;
      int k = 0;
      for (; k + 1 < d; k += 2) {
        s = fmaf(__ldg(vi + k), __ldg(vi + k), s);
        sb = fmaf(__ldg(vi + k + 1), __ldg(vi + k + 1), sb);
      }
      if (k < d) s = fmaf(__ldg(vi + k), __ldg(vi + k), s);
      s += sb;
    }
    v2_s[i] = s;
  }
}

// x.v and |x|^2 at dim k of the d2 micro-tile into one chain's sums.
template <int RC>
__device__ __forceinline__ void tile_dot_step(const float* xs, const float* v_s,
                                              int ldx, int ldv, const int (&ridx)[kRM],
                                              const int (&cidx)[RC], int k,
                                              float (&xc)[kRM], float (&dc)[kRM][RC]) {
  float xv[kRM], vv[RC];
#pragma unroll
  for (int i = 0; i < kRM; ++i) xv[i] = xs[ridx[i] * ldx + k];
#pragma unroll
  for (int j = 0; j < RC; ++j) vv[j] = v_s[cidx[j] * ldv + k];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    xc[i] = fmaf(xv[i], xv[i], xc[i]);
#pragma unroll
    for (int j = 0; j < RC; ++j) dc[i][j] = fmaf(xv[i], vv[j], dc[i][j]);
  }
}

// The d2 micro-tile's x.v and |x|^2: kRM records x RC centers a thread.
template <int RC, int kChains>
__device__ __forceinline__ void tile_dots(const float* xs, const float* v_s, int ldx,
                                          int ldv, const int (&ridx)[kRM],
                                          const int (&cidx)[RC], int d,
                                          float (&x2)[kRM], float (&dot)[kRM][RC]) {
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    x2[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RC; ++j) dot[i][j] = 0.f;
  }
  if constexpr (kChains == 1) {
#pragma unroll 4
    for (int k = 0; k < d; ++k) tile_dot_step<RC>(xs, v_s, ldx, ldv, ridx, cidx, k, x2, dot);
  } else {
    float dotb[kRM][RC], x2b[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      x2b[i] = 0.f;
#pragma unroll
      for (int j = 0; j < RC; ++j) dotb[i][j] = 0.f;
    }
    int k = 0;
#pragma unroll 2
    for (; k + 1 < d; k += 2) {
      tile_dot_step<RC>(xs, v_s, ldx, ldv, ridx, cidx, k, x2, dot);
      tile_dot_step<RC>(xs, v_s, ldx, ldv, ridx, cidx, k + 1, x2b, dotb);
    }
    if (k < d) tile_dot_step<RC>(xs, v_s, ldx, ldv, ridx, cidx, k, x2, dot);
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      x2[i] += x2b[i];
#pragma unroll
      for (int j = 0; j < RC; ++j) dot[i][j] += dotb[i][j];
    }
  }
}

// The min (kMin) or the sum over a record's cg neighbouring lanes, by xor
// shuffles, for K records at once.
template <bool kMin, int K>
__device__ __forceinline__ void lanes_reduce(float (&a)[K], int cg) {
  if constexpr (K == 1) {
    for (int off = 1; off < cg; off <<= 1) {
      const float o = __shfl_xor_sync(fcm::kFull, a[0], off);
      a[0] = kMin ? fminf(a[0], o) : a[0] + o;
    }
  } else {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      if (off < cg) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const float o = __shfl_xor_sync(fcm::kFull, a[i], off);
          a[i] = kMin ? fminf(a[i], o) : a[i] + o;
        }
      }
    }
  }
}

// Membership (fcm::memberships' form) of the d2 micro-tile's records, kIl
// at a time: the min and the sum over centers completed by xor shuffles
// over the record's cg lanes; wum into wum_s and q's share into accq.  A
// record past the tile (r >= rows) computes on stale values and writes
// nothing.
template <int RC, int kIl>
__device__ __forceinline__ void tile_members(
    const float (&x2)[kRM], const float (&dot)[kRM][RC], const float* v2_s,
    const int (&cidx)[RC], const bool (&cval)[RC], const int (&ridx)[kRM], int rgi,
    int rg, int rows, int cg, float m, float expo, const float* ws, float* wum_s,
    int ldc, float& accq) {
#pragma unroll
  for (int i0 = 0; i0 < kRM; i0 += kIl) {
    float d2[kIl][RC], a[kIl][RC], lmin[kIl], s[kIl];
#pragma unroll
    for (int ii = 0; ii < kIl; ++ii) {
      const int i = i0 + ii;
      lmin[ii] = INFINITY;
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        d2[ii][j] = cval[j] ? fmaxf(x2[i] + v2_s[cidx[j]] - 2.f * dot[i][j], kD2Floor)
                            : INFINITY;
        a[ii][j] = logf(d2[ii][j]);
        lmin[ii] = fminf(lmin[ii], a[ii][j]);
      }
    }
    lanes_reduce<true>(lmin, cg);
#pragma unroll
    for (int ii = 0; ii < kIl; ++ii) {
      s[ii] = 0.f;
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        a[ii][j] = -expo * (a[ii][j] - lmin[ii]);
        s[ii] += expf(a[ii][j]);
      }
    }
    lanes_reduce<false>(s, cg);
#pragma unroll
    for (int ii = 0; ii < kIl; ++ii) {
      const int i = i0 + ii;
      const int r = rgi + i * rg;
      const bool rv = r < rows;
      const float ls = logf(s[ii]);
      const float wk = ws[ridx[i]];
      float qr = 0.f;
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        if (rv && cval[j]) {
          const float wum = expf(m * (a[ii][j] - ls)) * wk;
          wum_s[r * ldc + cidx[j]] = wum;
          qr = fmaf(wum, d2[ii][j], qr);
        }
      }
      accq += qr;
    }
  }
}

// v_num += wum^T x over the tile's records rsi, rsi + rs, ...: kAC
// centers x kAD dims a thread (three float4 shared loads a record); w_i
// on the threads of the first dim group.
__device__ __forceinline__ void tile_contract(float (&acc)[kAC][kAD], float (&accw)[kAC],
                                              const float* wum_s, const float* xs,
                                              int rows, int rsi, int rs, int agi,
                                              int dgi, int ldc, int ldx) {
#pragma unroll 2
  for (int r = rsi; r < rows; r += rs) {
    const float4 w4 = *reinterpret_cast<const float4*>(wum_s + r * ldc + agi * kAC);
    const float4* xp = reinterpret_cast<const float4*>(xs + r * ldx + dgi * kAD);
    const float4 xa = xp[0], xb = xp[1];
    const float wv[kAC] = {w4.x, w4.y, w4.z, w4.w};
    const float xv[kAD] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int a = 0; a < kAC; ++a) {
#pragma unroll
      for (int b = 0; b < kAD; ++b) acc[a][b] = fmaf(wv[a], xv[b], acc[a][b]);
    }
    if (dgi == 0) {
#pragma unroll
      for (int a = 0; a < kAC; ++a) accw[a] += wv[a];
    }
  }
}

// After the walk: each thread's v_num and w_i micro-tiles into scr and
// scw, q's warp sums into red_s (read after the next barrier).
__device__ __forceinline__ void tile_stash(const float (&acc)[kAC][kAD],
                                           const float (&accw)[kAC], float accq,
                                           bool acc_on, int rsi, int og, int ogi,
                                           int ag, int agi, int dgi, int lane, int warp,
                                           float* scr, float* scw, float* red_s) {
  if (acc_on) {
#pragma unroll
    for (int a = 0; a < kAC; ++a) {
#pragma unroll
      for (int b = 0; b < kAD; ++b)
        scr[(size_t)(rsi * og + ogi) * (kAC * kAD) + a * kAD + b] = acc[a][b];
    }
    if (dgi == 0) {
#pragma unroll
      for (int a = 0; a < kAC; ++a) scw[(rsi * ag + agi) * kAC + a] = accw[a];
    }
  }
  accq = fcm::warp_sum(accq);
  if (lane == 0) red_s[warp] = accq;
}

// The CTA's sums of output o of v_num (o < C*d) or i of w_i over the
// record subsets in order, and of q over the warps.
__device__ __forceinline__ float tile_v_sum(const float* scr, int o, int d, int dg,
                                            int og, int rs) {
  const int i = o / d, j = o - i * d;
  const size_t slot = (size_t)((i / kAC) * dg + j / kAD) * (kAC * kAD)
                      + (i % kAC) * kAD + j % kAD;
  float s = 0.f;
  for (int k = 0; k < rs; ++k) s += scr[(size_t)k * og * (kAC * kAD) + slot];
  return s;
}

__device__ __forceinline__ float tile_w_sum(const float* scw, int i, int ag, int rs) {
  float s = 0.f;
  for (int k = 0; k < rs; ++k) s += scw[k * ag * kAC + i];
  return s;
}

__device__ __forceinline__ float tile_q_sum(const float* red_s) {
  float q = 0.f;
  for (int k = 0; k < kTileBlock / 32; ++k) q += red_s[k];
  return q;
}

template <int RC>
__global__ void __launch_bounds__(kTileBlock, 2)
fcm_tile_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ v, long long n, int d, int c, float m,
                float expo, int tr, int cg, int ag, int dg, int rs, int slices,
                int normalize, float* __restrict__ part, int* __restrict__ tickets,
                float* __restrict__ out_v, float* __restrict__ out_w,
                float* __restrict__ out_q) {
  extern __shared__ __align__(16) float tile_smem[];
  const TileLayout L = tile_layout(d, c, tr, rs, ag, dg);
  float* v_s = tile_smem + L.v;
  float* v2_s = tile_smem + L.v2;
  float* wum_s = tile_smem + L.wum;
  float* red_s = tile_smem + L.red;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int cd = c * d;

  // V arrives by cp.async with the first tile; meanwhile |v_i|^2 is formed
  // (`tile_center_norms`).  It is read after the walk's first barrier.
  for (int o = tid; o < cd; o += kTileBlock) {
    const int i = o / d, j = o - i * d;
    fcm::cp_async4(v_s + i * L.ldv + j, v + o);
  }
  tile_center_norms<1>(v, d, c, v2_s);

  // d2 micro-tile: records rgi + i*rg (i < kRM) x centers cgi + j*cg (j < RC).
  // The cg threads of one record group are neighbouring lanes (cg | 32).
  const int rg = kTileBlock / cg;
  const int cgi = tid % cg, rgi = tid / cg;
  int cidx[RC];
  bool cval[RC];
#pragma unroll
  for (int j = 0; j < RC; ++j) {
    const int ci = cgi + j * cg;
    cval[j] = ci < c;
    cidx[j] = min(ci, c - 1);
  }
  // v_num micro-tile: centers agi*kAC + a x dims dgi*kAD + b over the tile's
  // records rsi, rsi + rs, ...  Slots past C or d read padding; their sums
  // are never written.
  const int og = ag * dg;
  const bool acc_on = tid < rs * og;
  const int ogi = tid % og, rsi = tid / og;
  const int agi = ogi / dg, dgi = ogi - agi * dg;
  float acc[kAC][kAD], accw[kAC], accq = 0.f;
#pragma unroll
  for (int a = 0; a < kAC; ++a) {
    accw[a] = 0.f;
#pragma unroll
    for (int b = 0; b < kAD; ++b) acc[a][b] = 0.f;
  }

  const long long n_tiles = (n + tr - 1) / tr;
  auto load = [&](int buf, long long tile) {
    const long long r0 = tile * tr;
    const int rows = (int)min((long long)tr, n - r0);
    float* xs = tile_smem + (buf ? L.x1 : L.x0);
    float* ws = tile_smem + (buf ? L.w1 : L.w0);
    const float* xg = x + r0 * d;
    for (int r = warp; r < rows; r += kTileBlock / 32)
      for (int j = lane; j < d; j += 32)
        fcm::cp_async4(xs + r * L.ldx + j, xg + (long long)r * d + j);
    for (int r = tid; r < rows; r += kTileBlock) fcm::cp_async4(ws + r, w + r0 + r);
  };

  long long tile = blockIdx.x;
  int buf = 0;
  if (tile < n_tiles) load(0, tile);
  fcm::cp_async_commit();
  for (; tile < n_tiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles) load(buf ^ 1, next);
    fcm::cp_async_commit();
    fcm::cp_async_wait<1>();
    __syncthreads();
    const int rows = (int)min((long long)tr, n - tile * tr);
    const float* xs = tile_smem + (buf ? L.x1 : L.x0);
    const float* ws = tile_smem + (buf ? L.w1 : L.w0);

    int ridx[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i) ridx[i] = min(rgi + i * rg, tr - 1);
    float dot[kRM][RC], x2[kRM];
    tile_dots<RC, 1>(xs, v_s, L.ldx, L.ldv, ridx, cidx, d, x2, dot);
    tile_members<RC, 1>(x2, dot, v2_s, cidx, cval, ridx, rgi, rg, rows, cg, m, expo, ws,
                        wum_s, L.ldc, accq);
    __syncthreads();

    if (acc_on) tile_contract(acc, accw, wum_s, xs, rows, rsi, rs, agi, dgi, L.ldc, L.ldx);
    __syncthreads();
    buf ^= 1;
  }
  fcm::cp_async_wait<0>();
  __syncthreads();

  // The CTA's partial: each output summed over the record subsets in order.
  float* scr = tile_smem + L.scr;
  float* scw = tile_smem + L.scw;
  tile_stash(acc, accw, accq, acc_on, rsi, og, ogi, ag, agi, dgi, lane, warp, scr, scw,
             red_s);
  __syncthreads();
  const int p_len = cd + c + 1;
  float* my = part + (size_t)blockIdx.x * p_len;
  for (int o = tid; o < cd + c; o += kTileBlock)
    my[o] = o < cd ? tile_v_sum(scr, o, d, dg, og, rs) : tile_w_sum(scw, o - cd, ag, rs);
  if (tid == 0) my[cd + c] = tile_q_sum(red_s);
  fcm::finish_partials(part, tickets, gridDim.x, p_len, slices, d, c, normalize,
                       out_v, out_w, out_q);
}

template <int RC>
int launch_tile(const float* x, const float* w, const float* v, long long n, int d,
                int c, float m, float expo, int tr, int cg, int ag, int dg, int rs,
                int grid, int slices, int smem, float* part, int* tickets,
                float* out_v, float* out_w, float* out_q, int normalize,
                cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      fcm_tile_kernel<RC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fcm_tile_kernel<RC><<<grid, kTileBlock, smem, s>>>(
      x, w, v, n, d, c, m, expo, tr, cg, ag, dg, rs, slices, normalize, part,
      tickets, out_v, out_w, out_q);
  return (int)cudaGetLastError();
}

template <int RC>
int tile_occupancy(int smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      fcm_tile_kernel<RC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, fcm_tile_kernel<RC>, kTileBlock, smem);
}

__device__ __forceinline__ long long max_ll(long long a, long long b) {
  return a > b ? a : b;
}

// The tile kernel with a tenant axis (the tenant-stacked sweep past the
// rows kernel): fcm_tile_kernel's stages per tenant.  CTA b owns split
// b % splits of tenant b / splits.  Tenant t reads x + t*n*d, w + t*n,
// V_t and m_t[t] (or the scalar m); its n_eff rows fall in
// ceil(n_eff / tr) tiles within one record of each other, and split s
// walks tiles s, s + splits, ...  |x|^2, |v|^2 and x.v each run as two
// fmaf chains, over the even and the odd dims, added at the end: at the
// KDD99 width (|x|^2 ~ 680 against in-blob d2 ~ 40) the expansion cancels
// most of its digits, and two half-length chains round less than one.  A
// record equal to a center still gets d2 = 0 exactly: its chains hold the
// same values in the same order as the center's.  The membership's
// shuffles of a thread's kRM records are interleaved.  With trim (one
// split per tenant), n_eff is one past the tenant's last nonzero weight:
// its trailing zero-weight rows, which would add exact zeros, are not
// walked.
template <int RC>
__global__ void __launch_bounds__(kTileBlock, 2)
fcm_tile_tenants_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ v, const float* __restrict__ m_t,
                long long n, int d, int c, float m_s, float expo_s, int tr, int cg,
                int ag, int dg, int rs, int splits, int slices, int trim,
                int normalize, float* __restrict__ part, int* __restrict__ tickets,
                float* __restrict__ out_v, float* __restrict__ out_w,
                float* __restrict__ out_q) {
  extern __shared__ __align__(16) float tile_smem[];
  __shared__ long long live_s[kTileBlock / 32];
  const TileLayout L = tile_layout(d, c, tr, rs, ag, dg);
  float* v_s = tile_smem + L.v;
  float* v2_s = tile_smem + L.v2;
  float* wum_s = tile_smem + L.wum;
  float* red_s = tile_smem + L.red;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int cd = c * d;
  const long long tenant = (long long)blockIdx.x / splits;
  const int split = (int)((long long)blockIdx.x - tenant * splits);
  x += tenant * n * d;
  w += tenant * n;
  v += tenant * cd;
  const float m = m_t ? m_t[tenant] : m_s;
  const float expo = m_t ? 1.f / (m - 1.f) : expo_s;

  // The micro-tiles' roles, as in fcm_tile_kernel.
  const int rg = kTileBlock / cg;
  const int cgi = tid % cg, rgi = tid / cg;
  int cidx[RC];
  bool cval[RC];
#pragma unroll
  for (int j = 0; j < RC; ++j) {
    const int ci = cgi + j * cg;
    cval[j] = ci < c;
    cidx[j] = min(ci, c - 1);
  }
  const int og = ag * dg;
  const bool acc_on = tid < rs * og;
  const int ogi = tid % og, rsi = tid / og;
  const int agi = ogi / dg, dgi = ogi - agi * dg;
  float acc[kAC][kAD], accw[kAC], accq = 0.f;
#pragma unroll
  for (int a = 0; a < kAC; ++a) {
    accw[a] = 0.f;
#pragma unroll
    for (int b = 0; b < kAD; ++b) acc[a][b] = 0.f;
  }

  auto load = [&](int buf, long long r0, int rows) {
    if (!(kTileStages & 1)) return;
    float* xs = tile_smem + (buf ? L.x1 : L.x0);
    float* ws = tile_smem + (buf ? L.w1 : L.w0);
    const float* xg = x + r0 * d;
    for (int r = warp; r < rows; r += kTileBlock / 32)
      for (int j = lane; j < d; j += 32)
        fcm::cp_async4(xs + r * L.ldx + j, xg + (long long)r * d + j);
    for (int r = tid; r < rows; r += kTileBlock) fcm::cp_async4(ws + r, w + r0 + r);
  };

  // V and the first tile arrive by cp.async together.  With trim the first
  // tile's bounds wait on the scan of the weights below, so every row it
  // may hold is loaded (tr at most).  Meanwhile |v_i|^2 is formed
  // (`tile_center_norms`); it is read after the walk's first barrier.
  for (int o = tid; o < cd; o += kTileBlock) {
    const int i = o / d, j = o - i * d;
    fcm::cp_async4(v_s + i * L.ldv + j, v + o);
  }
  tile_center_norms<2>(v, d, c, v2_s);
  long long n_eff = n;
  long long n_tiles = (n + tr - 1) / tr;
  // Tile k: rows [k*per + min(k, extra), ...), per + (k < extra) of them.
  long long per = 0, extra = 0;
  auto balance = [&]() {
    per = n_tiles ? n_eff / n_tiles : 0;
    extra = n_eff - per * n_tiles;
  };
  balance();
  auto start = [&](long long k) { return k * per + min(k, extra); };
  auto span = [&](long long k) { return (int)(per + (k < extra)); };
  long long tile = split;
  if (trim) {
    load(0, 0, (int)min((long long)tr, n));
  } else if (tile < n_tiles) {
    load(0, start(tile), span(tile));
  }
  fcm::cp_async_commit();
  if (trim) {
    long long last = -1;
    for (long long r = tid; r < n; r += kTileBlock)
      if (__ldg(w + r) != 0.f) last = r;
    for (int off = 16; off > 0; off >>= 1)
      last = max_ll(last, __shfl_xor_sync(fcm::kFull, last, off));
    if (lane == 0) live_s[warp] = last;
    __syncthreads();
    last = live_s[0];
    for (int k = 1; k < kTileBlock / 32; ++k) last = max_ll(last, live_s[k]);
    n_eff = last + 1;
    n_tiles = (n_eff + tr - 1) / tr;
    balance();
  }

  int buf = 0;
  for (; tile < n_tiles; tile += splits) {
    const long long next = tile + splits;
    if (next < n_tiles) load(buf ^ 1, start(next), span(next));
    fcm::cp_async_commit();
    fcm::cp_async_wait<1>();
    __syncthreads();
    const int rows = span(tile);
    const float* xs = tile_smem + (buf ? L.x1 : L.x0);
    const float* ws = tile_smem + (buf ? L.w1 : L.w0);

    int ridx[kRM];
#pragma unroll
    for (int i = 0; i < kRM; ++i) ridx[i] = min(rgi + i * rg, tr - 1);
    float dot[kRM][RC] = {}, x2[kRM] = {};
    if (kTileStages & 2) tile_dots<RC, 2>(xs, v_s, L.ldx, L.ldv, ridx, cidx, d, x2, dot);
    if (kTileStages & 4)
      tile_members<RC, kRM>(x2, dot, v2_s, cidx, cval, ridx, rgi, rg, rows, cg, m, expo,
                            ws, wum_s, L.ldc, accq);
    __syncthreads();

    if ((kTileStages & 8) && acc_on)
      tile_contract(acc, accw, wum_s, xs, rows, rsi, rs, agi, dgi, L.ldc, L.ldx);
    __syncthreads();
    buf ^= 1;
  }
  fcm::cp_async_wait<0>();
  __syncthreads();

  // The CTA's sums: each output summed over the record subsets in order.
  float* scr = tile_smem + L.scr;
  float* scw = tile_smem + L.scw;
  tile_stash(acc, accw, accq, acc_on, rsi, og, ogi, ag, agi, dgi, lane, warp, scr, scw,
             red_s);
  __syncthreads();
  out_v += tenant * cd;
  out_w += tenant * c;
  out_q += tenant;
  if (splits == 1) {
    // The CTA owns its tenant and writes the outputs itself (no partial,
    // no ticket); w_i as summed is the divisor, bit for bit.
    for (int i = tid; i < c; i += kTileBlock) {
      const float s = tile_w_sum(scw, i, ag, rs);
      v2_s[i] = s;
      out_w[i] = s;
    }
    if (tid == 0) *out_q = tile_q_sum(red_s);
    __syncthreads();
    for (int o = tid; o < cd; o += kTileBlock) {
      const float s = tile_v_sum(scr, o, d, dg, og, rs);
      out_v[o] = normalize ? s / fmaxf(v2_s[o / d], kD2Floor) : s;
    }
    return;
  }
  const int p_len = cd + c + 1;
  float* my = part + (size_t)blockIdx.x * p_len;
  for (int o = tid; o < cd + c; o += kTileBlock)
    my[o] = o < cd ? tile_v_sum(scr, o, d, dg, og, rs) : tile_w_sum(scw, o - cd, ag, rs);
  if (tid == 0) my[cd + c] = tile_q_sum(red_s);
  fcm::finish_partials(part + (size_t)tenant * splits * p_len, tickets + 2 * tenant,
                       splits, p_len, slices, d, c, normalize, out_v, out_w, out_q);
}

template <int RC>
int launch_tile_tenants(const float* x, const float* w, const float* v, const float* m_t,
                long long n, int d, int c, float m, float expo, int tr, int cg, int ag,
                int dg, int rs, unsigned grid, int splits, int slices, int trim,
                int smem, float* part, int* tickets, float* out_v, float* out_w,
                float* out_q, int normalize, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      fcm_tile_tenants_kernel<RC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fcm_tile_tenants_kernel<RC><<<grid, kTileBlock, smem, s>>>(
      x, w, v, m_t, n, d, c, m, expo, tr, cg, ag, dg, rs, splits, slices, trim,
      normalize, part, tickets, out_v, out_w, out_q);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- wide --

constexpr int kWideBlock = 512;
// The tile loop's stages, one bit each (all of them unless a timing
// harness builds this file with some left out): 1 the x and w tile loads,
// 2 the partial x.v and |x|^2, 4 the k-group sums and their push to the
// cluster, 8 the cluster barrier, 16 the contraction, 32 the membership.
#ifndef FCM_WIDE_STAGES
#define FCM_WIDE_STAGES 63
#endif
constexpr int kWideStages = FCM_WIDE_STAGES;

__host__ __device__ inline int round32(int a) { return (a + 31) & ~31; }

struct WideLayout {  // offsets into dynamic shared memory, in floats
  int cp, ldw, ldx, ks;  // C to 4; wum row stride; V and x row stride; k-groups
  size_t ex;             // floats of one CTA's post: x.v (r x cp), then |x|^2 (r)
  size_t v, vx, v2, x0, w0, x1, w1, rx0, rx1, ksb, wum, lg, red, total;
};

// The wide kernel's shared memory for a d-slice of ds dims, C centers,
// r-record tiles, mc centers a thread in the contraction and clusters of
// s CTAs: V's slice; the slice's partial |v|^2 (read by the cluster) and
// the full |v|^2; two x and w tile buffers; two receive buffers of the s
// CTAs' posts (partial x.v and |x|^2 of a tile); the k-groups' partials;
// the tile's d2 then wum, and log d2 then its exponent; q's warp sums.
// The V and x rows are round32(ds) + 4 floats apart (4 mod 32: the x.v
// micro-tiles' 8 records of a warp in distinct banks), and every buffer
// read as float4 starts 16-byte aligned.
__host__ __device__ inline WideLayout wide_layout(int ds, int c, int r, int mc, int s) {
  WideLayout L;
  L.cp = (c + 3) & ~3;
  L.ldw = (c + mc - 1) / mc * mc;
  L.ldx = round32(ds) + 4;
  const int rg = r / 4 > 1 ? r / 4 : 1;
  L.ks = kWideBlock / (rg * (L.cp / 4));
  L.ex = (size_t)r * L.cp + r;
  size_t o = 0;
  L.v = o;   o += (size_t)L.cp * L.ldx;
  L.vx = o;  o += L.cp;
  L.v2 = o;  o += L.cp;
  L.x0 = o;  o += (size_t)r * L.ldx;
  L.w0 = o;  o += round4(r);
  L.x1 = o;  o += (size_t)r * L.ldx;
  L.w1 = o;  o += round4(r);
  L.rx0 = o; o += (size_t)s * L.ex;
  L.rx1 = o; o += (size_t)s * L.ex;
  L.ksb = o; o += (size_t)L.ks * L.ex;
  L.wum = round4(o); o = L.wum + (size_t)r * L.ldw;
  L.lg = o;  o += (size_t)r * L.ldw;
  L.red = o; o += kWideBlock / 32;
  L.total = o;
  return L;
}

// One cluster of S CTAs per tile of R records: CTA s holds dims
// [s*ds, (s+1)*ds) of V and of the tile.  The cluster's CTAs walk tiles
// blockIdx.x / S, + gridDim.x / S, ...  Per tile, each CTA forms its
// slice's partial x.v and |x|^2 of the tile (4 records x 4 centers a
// thread, the slice's dims split between k-groups of threads, summed in
// group order) and stores it into every CTA's receive buffer; after the
// cluster barrier each CTA adds the S posts in rank order, so all S form
// the same d2 and membership, and each adds wum^T x over its own slice
// (MC centers x MD dims a thread, kept in registers for the whole walk).
// Rank 0 also sums w_i and q.
template <int MC, int MD>
__global__ void __launch_bounds__(kWideBlock, 1)
fcm_wide_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ v, long long n, int d, int c, float m,
                float expo, int R, int ds, int vec, int slices, int normalize,
                float* __restrict__ part, int* __restrict__ tickets,
                float* __restrict__ out_v, float* __restrict__ out_w,
                float* __restrict__ out_q) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float wide_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const WideLayout L = wide_layout(ds, c, R, MC, S);
  float* vs = wide_smem + L.v;
  float* vx = wide_smem + L.vx;
  float* v2 = wide_smem + L.v2;
  float* ksb = wide_smem + L.ksb;
  float* wum = wide_smem + L.wum;
  float* lg = wide_smem + L.lg;
  float* red = wide_smem + L.red;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x / S, gc = blockIdx.x / S;
  const int k0 = rank * ds;
  const int cp = L.cp;
  const size_t ex = L.ex;
  const int nq = ds / 4;  // float4 steps of the slice

  // x.v micro-tile: k-group g, records rg + i*RG (i < 4), centers
  // cgi + j*CG (j < 4), dims 4*[q0, q1) of the slice.
  const int RG = R / 4 > 1 ? R / 4 : 1, CG = cp / 4;
  const int mt = RG * CG;
  const bool in1 = tid < mt * L.ks;
  const int g = tid / mt, u = tid % mt, rg = u % RG, cgi = u / RG;
  const int kq = (nq + L.ks - 1) / L.ks;
  const int q0 = min(nq, g * kq), q1 = min(nq, q0 + kq);
  // wum^T x micro-tile: centers agi*MC + a, dims dgi*MD + b of the slice.
  const int DG = ds / MD, AG = (c + MC - 1) / MC;
  const bool in3 = tid < AG * DG;
  const int agi = tid / DG, dgi = tid % DG;
  // membership: Lr lanes per record
  const int Lr = R >= kWideBlock / 32 ? kWideBlock / R : 32;
  const int rm = tid / Lr, h = tid % Lr;

  for (int e = tid; e < R * L.ldw; e += kWideBlock) wum[e] = 0.f;

  // V's slice, zero past C and d.
  for (int e = tid; e < cp * nq; e += kWideBlock) {
    const int i = e / nq, q = e - i * nq, k = k0 + 4 * q;
    if (vec) {
      const bool ok = i < c && k < d;
      fcm::cp_async16(vs + i * L.ldx + 4 * q, ok ? v + (size_t)i * d + k : v, ok);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const bool ok = i < c && k + b < d;
        fcm::cp_async4z(vs + i * L.ldx + 4 * q + b, ok ? v + (size_t)i * d + k + b : v, ok);
      }
    }
  }
  fcm::cp_async_commit();

  const long long n_tiles = (n + R - 1) / R;
  auto load = [&](int buf, long long tile) {
    if (!(kWideStages & 1)) return;
    float* xs = wide_smem + (buf ? L.x1 : L.x0);
    float* ws = wide_smem + (buf ? L.w1 : L.w0);
    const long long r0 = tile * R;
    for (int r = warp; r < R; r += kWideBlock / 32) {
      const bool row = r0 + r < n;
      const float* src = x + (r0 + r) * d + k0;
      float* dst = xs + r * L.ldx;
      for (int q = lane; q < nq; q += 32) {
        const int k = 4 * q;
        if (vec) {
          const bool ok = row && k0 + k < d;
          fcm::cp_async16(dst + k, ok ? src + k : x, ok);
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const bool ok = row && k0 + k + b < d;
            fcm::cp_async4z(dst + k + b, ok ? src + k + b : x, ok);
          }
        }
      }
    }
    for (int r = tid; r < R; r += kWideBlock)
      fcm::cp_async4z(ws + r, r0 + r < n ? w + r0 + r : w, r0 + r < n);
  };

  long long tile = gc;
  int buf = 0;
  if (tile < n_tiles) load(0, tile);
  fcm::cp_async_commit();
  fcm::cp_async_wait<1>();
  __syncthreads();  // V's slice is in

  // |v|^2 of the slice: the same k-groups and fmaf order as x.v below, so
  // that a record equal to a center gets d2 = 0 exactly.
  if (in1 && rg == 0) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = q0; q < q1; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(vs + (cgi + j * CG) * L.ldx + 4 * q);
        s[j] = fmaf(b.x, b.x, s[j]);
        s[j] = fmaf(b.y, b.y, s[j]);
        s[j] = fmaf(b.z, b.z, s[j]);
        s[j] = fmaf(b.w, b.w, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) ksb[g * cp + cgi + j * CG] = s[j];
  }
  __syncthreads();
  for (int i = tid; i < cp; i += kWideBlock) {
    float s = 0.f;
    for (int k = 0; k < L.ks; ++k) s += ksb[k * cp + i];
    vx[i] = s;
  }
  cluster.sync();
  for (int i = tid; i < cp; i += kWideBlock) {
    float s = 0.f;
    for (int r = 0; r < S; ++r) s += cluster.map_shared_rank(vx, r)[i];
    v2[i] = s;
  }

  float acc[MC][MD], accw[MC], accq = 0.f;
#pragma unroll
  for (int a = 0; a < MC; ++a) {
    accw[a] = 0.f;
#pragma unroll
    for (int b = 0; b < MD; ++b) acc[a][b] = 0.f;
  }

  int par = 0;
  for (; tile < n_tiles; tile += G) {
    const long long next = tile + G;
    if (next < n_tiles) load(buf ^ 1, next);
    fcm::cp_async_commit();
    fcm::cp_async_wait<1>();
    __syncthreads();  // this tile is in; v2 is written
    const int rows = (int)min((long long)R, n - tile * R);
    const float* xs = wide_smem + (buf ? L.x1 : L.x0);
    const float* ws = wide_smem + (buf ? L.w1 : L.w0);
    float* rx = wide_smem + (par ? L.rx1 : L.rx0);

    // 1. The slice's partial x.v and |x|^2 (on the lanes of center group
    // 0), per k-group.
    if ((kWideStages & 2) && in1) {
      int xo[4], vo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xo[i] = min(rg + i * RG, R - 1) * L.ldx;
#pragma unroll
      for (int j = 0; j < 4; ++j) vo[j] = (cgi + j * CG) * L.ldx;
      float dot[4][4], x2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x2[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[i][j] = 0.f;
      }
      const bool own_x2 = cgi == 0;
#pragma unroll 2
      for (int q = q0; q < q1; ++q) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(xs + xo[i] + 4 * q);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(vs + vo[j] + 4 * q);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dot[i][j] = fmaf(a[i].x, b[j].x, dot[i][j]);
            dot[i][j] = fmaf(a[i].y, b[j].y, dot[i][j]);
            dot[i][j] = fmaf(a[i].z, b[j].z, dot[i][j]);
            dot[i][j] = fmaf(a[i].w, b[j].w, dot[i][j]);
          }
          if (own_x2) {
            x2[i] = fmaf(a[i].x, a[i].x, x2[i]);
            x2[i] = fmaf(a[i].y, a[i].y, x2[i]);
            x2[i] = fmaf(a[i].z, a[i].z, x2[i]);
            x2[i] = fmaf(a[i].w, a[i].w, x2[i]);
          }
        }
      }
      float* kp = ksb + g * ex;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + i * RG;
        if (r < R) {
#pragma unroll
          for (int j = 0; j < 4; ++j) kp[r * cp + cgi + j * CG] = dot[i][j];
          if (own_x2) kp[(size_t)R * cp + r] = x2[i];
        }
      }
    }
    if (kWideStages & 4) {
      __syncthreads();
      // The k-groups summed in order: this CTA's post, stored into slot
      // `rank` of every CTA's receive buffer.
      for (int e = tid; e < (int)ex; e += kWideBlock) {
        float s = 0.f;
        for (int k = 0; k < L.ks; ++k) s += ksb[(size_t)k * ex + e];
        for (int r = 0; r < S; ++r) cluster.map_shared_rank(rx, r)[rank * ex + e] = s;
      }
    }

    // 2. d2 and the membership, the same on every CTA of the cluster: the
    // S posts added in rank order; Lr lanes per record, the min and the sum
    // over centers by xor shuffles among them (fcm::memberships' form).
    if (kWideStages & 8) cluster.sync();  // every post is in, read only after this
    if (kWideStages & 32) {
      if (rm < R) {
        float x2 = 0.f;
        for (int r = 0; r < S; ++r) x2 += rx[r * ex + (size_t)R * cp + rm];
        float* dr = wum + rm * L.ldw;
        float* ar = lg + rm * L.ldw;
        float lmin = INFINITY;
        for (int i = h; i < c; i += Lr) {
          float dot = 0.f;
          for (int r = 0; r < S; ++r) dot += rx[r * ex + rm * cp + i];
          const float d2 = fmaxf(x2 + v2[i] - 2.f * dot, kD2Floor);
          const float a = logf(d2);
          dr[i] = d2;
          ar[i] = a;
          lmin = fminf(lmin, a);
        }
        for (int off = Lr >> 1; off > 0; off >>= 1)
          lmin = fminf(lmin, __shfl_xor_sync(fcm::kFull, lmin, off));
        float sum = 0.f;
        for (int i = h; i < c; i += Lr) {
          const float a = -expo * (ar[i] - lmin);
          ar[i] = a;
          sum += expf(a);
        }
        for (int off = Lr >> 1; off > 0; off >>= 1) sum += __shfl_xor_sync(fcm::kFull, sum, off);
        const float ls = logf(sum), wk = ws[rm];
        for (int i = h; i < c; i += Lr) {
          const float um = expf(m * (ar[i] - ls)) * wk;
          if (rank == 0) accq = fmaf(um, dr[i], accq);
          dr[i] = um;
        }
      }
    }
    __syncthreads();

    // 3. v_num += wum^T x over the slice (w_i on rank 0).
    if ((kWideStages & 16) && in3) {
      const float* wp = wum + agi * MC;
      const float* xp = xs + dgi * MD;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        float wv[MC], xv[MD];
#pragma unroll
        for (int a = 0; a < MC; a += 4) {
          const float4 t = *reinterpret_cast<const float4*>(wp + r * L.ldw + a);
          wv[a] = t.x; wv[a + 1] = t.y; wv[a + 2] = t.z; wv[a + 3] = t.w;
        }
        if constexpr (MD == 2) {
          const float2 t = *reinterpret_cast<const float2*>(xp + r * L.ldx);
          xv[0] = t.x; xv[1] = t.y;
        } else {
#pragma unroll
          for (int b = 0; b < MD; b += 4) {
            const float4 t = *reinterpret_cast<const float4*>(xp + r * L.ldx + b);
            xv[b] = t.x; xv[b + 1] = t.y; xv[b + 2] = t.z; xv[b + 3] = t.w;
          }
        }
#pragma unroll
        for (int a = 0; a < MC; ++a) {
#pragma unroll
          for (int b = 0; b < MD; ++b) acc[a][b] = fmaf(wv[a], xv[b], acc[a][b]);
        }
        if (rank == 0 && dgi == 0) {
#pragma unroll
          for (int a = 0; a < MC; ++a) accw[a] += wv[a];
        }
      }
    }
    __syncthreads();  // buf and wum are free for the next tile
    buf ^= 1;
    par ^= 1;
  }
  fcm::cp_async_wait<0>();
  cluster.sync();  // no CTA leaves while another may still store to it

  // The cluster's partial: each CTA its slice of v_num, rank 0 w_i and q.
  const int p_len = c * d + c + 1;
  float* my = part + (size_t)gc * p_len;
  if (in3) {
#pragma unroll
    for (int a = 0; a < MC; ++a) {
      const int i = agi * MC + a;
#pragma unroll
      for (int b = 0; b < MD; ++b) {
        const int k = k0 + dgi * MD + b;
        if (i < c && k < d) my[(size_t)i * d + k] = acc[a][b];
      }
      if (rank == 0 && dgi == 0 && i < c) my[(size_t)c * d + i] = accw[a];
    }
  }
  accq = fcm::warp_sum(accq);
  if (lane == 0) red[warp] = accq;
  __syncthreads();
  if (rank == 0 && tid == 0) {
    float q = 0.f;
    for (int k = 0; k < kWideBlock / 32; ++k) q += red[k];
    my[(size_t)c * d + c] = q;
  }
  fcm::finish_partials(part, tickets, G, p_len, slices, d, c, normalize, out_v, out_w,
                       out_q, gridDim.x);
}

template <int MC, int MD>
cudaError_t wide_attributes(int S, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fcm_wide_kernel<MC, MD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || S <= 8) return err;
  return cudaFuncSetAttribute(fcm_wide_kernel<MC, MD>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

inline cudaLaunchConfig_t wide_config(int grid, int S, int smem, cudaStream_t s,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kWideBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int MC, int MD>
int wide_clusters(int S, int smem, int* clusters) {
  cudaError_t err = wide_attributes<MC, MD>(S, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_config(S, S, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)fcm_wide_kernel<MC, MD>, &cfg);
}

template <int MC, int MD>
int launch_wide(const float* x, const float* w, const float* v, long long n, int d,
                int c, float m, float expo, int R, int S, int ds, int vec, int grid,
                int slices, int smem, float* part, int* tickets, float* out_v,
                float* out_w, float* out_q, int normalize, cudaStream_t s) {
  cudaError_t err = wide_attributes<MC, MD>(S, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_config(grid, S, smem, s, &attr);
  err = cudaLaunchKernelEx(&cfg, fcm_wide_kernel<MC, MD>, x, w, v, n, d, c, m, expo, R, ds,
                           vec, slices, normalize, part, tickets, out_v, out_w, out_q);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

const char* fcm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The card's SM count and opt-in shared memory per block.
int fcm_device(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(smem_optin,
                                     cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Resident CTAs per SM of fcm_tile_kernel<rc> at `smem` bytes of dynamic
// shared memory (fcm_tile_tenants_kernel<rc> runs at the same launch
// bounds on the same layout).
int fcm_tile_occupancy(int rc, int smem, int* per_sm) {
  *per_sm = 0;
  switch (rc) {
    case 1: return tile_occupancy<1>(smem, per_sm);
    case 2: return tile_occupancy<2>(smem, per_sm);
    case 3: return tile_occupancy<3>(smem, per_sm);
    case 4: return tile_occupancy<4>(smem, per_sm);
  }
  return (int)cudaErrorInvalidValue;
}

// The clusters of s CTAs of the wide kernel (mc = 4 or 8 centers a thread)
// that the card holds at once with `smem` bytes of dynamic shared memory.
int fcm_wide_clusters(int mc, int s, int smem, int* clusters) {
  *clusters = 0;
  if (s < 1 || s > 16) return (int)cudaErrorInvalidValue;
  return mc == 4 ? wide_clusters<4, 4>(s, smem, clusters)
                 : wide_clusters<8, 2>(s, smem, clusters);
}

// The tile path on `stream`: `grid` CTAs walk tr-row tiles; cg center
// groups of rc = ceil(C / cg) centers (1 <= rc <= 4, cg | 32), ag x dg
// v_num micro-tiles over rs record subsets (ag*dg*rs <= 256); `slices`
// CTAs share the final reduce.  `part` holds grid * (C*d + C + 1) floats,
// `tickets` 2 ints, zero before the first launch (each launch leaves them
// zero).  Refuses a `smem` below the layout's need.  Returns
// cudaGetLastError().
int fcm_tile_sweep(const float* x, const float* w, const float* v, long long n,
                   int d, int c, float m, float expo, int tr, int cg, int rc, int ag,
                   int dg, int rs, int grid, int slices, int smem, float* part,
                   int* tickets, float* out_v, float* out_w, float* out_q,
                   int normalize, void* stream) {
  if (tile_layout(d, c, tr, rs, ag, dg).total * sizeof(float) > (size_t)smem ||
      ag * dg * rs > kTileBlock || 32 % cg != 0 || rc * cg < c || slices < 1 ||
      slices > grid)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rc) {
    case 1: return launch_tile<1>(x, w, v, n, d, c, m, expo, tr, cg, ag, dg, rs, grid,
                                  slices, smem, part, tickets, out_v, out_w, out_q,
                                  normalize, s);
    case 2: return launch_tile<2>(x, w, v, n, d, c, m, expo, tr, cg, ag, dg, rs, grid,
                                  slices, smem, part, tickets, out_v, out_w, out_q,
                                  normalize, s);
    case 3: return launch_tile<3>(x, w, v, n, d, c, m, expo, tr, cg, ag, dg, rs, grid,
                                  slices, smem, part, tickets, out_v, out_w, out_q,
                                  normalize, s);
    case 4: return launch_tile<4>(x, w, v, n, d, c, m, expo, tr, cg, ag, dg, rs, grid,
                                  slices, smem, part, tickets, out_v, out_w, out_q,
                                  normalize, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The tenant-stacked tile path on `stream`: T = `tenants` models of n
// records, `splits` CTAs each (T*splits in all) walking tiles of at most
// tr records; cg center groups of rc = ceil(C / cg) centers
// (1 <= rc <= 4, cg | 32), ag x dg v_num micro-tiles over rs record
// subsets (ag*dg*rs <= 256).  m_t holds one fuzzifier per tenant, or is
// null and m (with expo = 1 / (m - 1)) applies to all.  With splits > 1,
// `slices` CTAs share each tenant's final reduce, `part` holds
// T*splits*(C*d + C + 1) floats and `tickets` 2*T ints, zero before the
// first launch (each launch leaves them zero); with splits == 1 each CTA
// writes its tenant's outputs and both may be null, and `trim` skips each
// tenant's trailing zero-weight rows.  Refuses a `smem` below the
// layout's need.  Returns cudaGetLastError().
int fcm_tile_tenants_sweep(const float* x, const float* w, const float* v,
                           const float* m_t,
                   long long n, int d, int c, float m, float expo, int tr, int cg,
                   int rc, int ag, int dg, int rs, long long tenants, int splits,
                   int slices, int trim, int smem, float* part, int* tickets,
                   float* out_v, float* out_w, float* out_q, int normalize,
                   void* stream) {
  if (tile_layout(d, c, tr, rs, ag, dg).total * sizeof(float) > (size_t)smem ||
      ag * dg * rs > kTileBlock || 32 % cg != 0 || rc * cg < c || tenants < 1 ||
      splits < 1 || tenants * splits > 0x7fffffffLL ||
      (splits > 1 && (slices < 1 || slices > splits)) || (trim && splits != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(tenants * splits);
#define FCM_TILE_LAUNCH(RC)                                                       \
  case RC:                                                                        \
    return launch_tile_tenants<RC>(x, w, v, m_t, n, d, c, m, expo, tr, cg, ag, dg, \
                                   rs, grid, splits, slices, trim, smem, part,     \
                                   tickets, out_v, out_w, out_q, normalize, s);
  switch (rc) {
    FCM_TILE_LAUNCH(1)
    FCM_TILE_LAUNCH(2)
    FCM_TILE_LAUNCH(3)
    FCM_TILE_LAUNCH(4)
  }
  return (int)cudaErrorInvalidValue;
}

// The wide path on `stream`: clusters of S CTAs, `grid` CTAs in all (a
// multiple of S, at most what the card holds at once: the ticketed final
// reduce waits for every CTA), walk r-record tiles; CTA s of a cluster
// holds dims [s*ds, (s+1)*ds) (ds a multiple of 8, S*ds >= d >
// (S-1)*ds).  `slices` CTAs share the final reduce.  `part` holds
// grid / S * (C*d + C + 1) floats, `tickets` 2 ints, zero before the first
// launch (each launch leaves them zero).  Refuses a `smem` below the
// layout's need.  Returns cudaGetLastError().
int fcm_wide_sweep(const float* x, const float* w, const float* v, long long n, int d,
                   int c, float m, float expo, int r, int S, int ds, int grid,
                   int slices, int smem, float* part, int* tickets, float* out_v,
                   float* out_w, float* out_q, int normalize, void* stream) {
  const int mc = c <= 4 ? 4 : 8, md = 16 / mc;
  const int cp = (c + 3) & ~3;
  if (r < 1 || r > 64 || (r & (r - 1)) || (r >= 4 ? r / 4 : 1) * (cp / 4) > kWideBlock ||
      S < 1 || S > 16 || grid < S || grid % S || ds < 8 || ds % 8 ||
      (long long)S * ds < d || (long long)(S - 1) * ds >= d ||
      (c + mc - 1) / mc * (ds / md) > kWideBlock || slices < 1 || slices > grid ||
      wide_layout(ds, c, r, mc, S).total * sizeof(float) > (size_t)smem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = d % 4 == 0 && aligned16(x) && aligned16(v);
  if (mc == 4)
    return launch_wide<4, 4>(x, w, v, n, d, c, m, expo, r, S, ds, vec, grid, slices, smem,
                             part, tickets, out_v, out_w, out_q, normalize, s);
  return launch_wide<8, 2>(x, w, v, n, d, c, m, expo, r, S, ds, vec, grid, slices, smem,
                           part, tickets, out_v, out_w, out_q, normalize, s);
}

}  // extern "C"

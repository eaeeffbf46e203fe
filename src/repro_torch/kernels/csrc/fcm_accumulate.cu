// FCM accumulation sweep (BigFCM paper, Alg. 1 body) for Hopper, sm_90a.
//
// Replaces repro/kernels/fcm_update.py::_fcm_tile_kernel (reached through
// fcm_accumulate_pallas and fcm_sweep_pallas).  For records x (N, d) with
// weights w (N,) and centers V (C, d), in IEEE fp32:
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
// Three paths, chosen by kernels/fcm_update.py's launch plan:
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
//    centers arrive as three float4 shared loads.  At
//    the end the row subsets are summed in order, each CTA writes one
//    partial, and the last CTAs to finish sum the partials in CTA order,
//    each one slice of the outputs (fcm::finish_partials): no second
//    launch.  At small N (the driver's 2048- and 3184-row blocks) the
//    tile shrinks so that the grid still covers the SMs.
//  * fcm_partial_kernel + fcm_reduce_kernel, the first version, for the
//    rest (C > 128 or C*d too large for the micro-tiles): V resident in
//    shared memory, 128-row tiles staged in shared memory, d2 and the
//    accumulation as scalar FMAs from shared memory, one thread per row
//    for the membership, one partial per CTA and a second kernel that
//    sums them in CTA order.
//
// No float atomics anywhere: for a fixed shape and card the summation
// order is fixed, so two runs on the same input are bit-identical.  This
// stands in for the TPU kernel's revisited output block, which relies on a
// sequential grid that CUDA does not have.  Shared-memory row strides of
// V, x and d2/wum are padded to odd lengths so that threads walking a
// column hit distinct banks.  Offsets into x are 64-bit: N*d exceeds 2^31
// at the paper's sizes.

#include "fcm_common.cuh"

namespace {

constexpr float kD2Floor = 1e-12f;

struct Layout {      // offsets into dynamic shared memory, in floats
  int ldv, ldx, ldc;  // padded row strides of V, the x tile, the d2/wum tiles
  size_t v, v2, x, x2, w, d2, wum, red, total;
};

__host__ __device__ inline Layout make_layout(int d, int c, int t, int block) {
  Layout L;
  L.ldv = d | 1;
  L.ldx = d | 1;
  L.ldc = c | 1;
  size_t o = 0;
  L.v = o;   o += (size_t)c * L.ldv;
  L.v2 = o;  o += c;
  L.x = o;   o += (size_t)t * L.ldx;
  L.x2 = o;  o += t;
  L.w = o;   o += t;
  L.d2 = o;  o += (size_t)t * L.ldc;
  L.wum = o; o += (size_t)t * L.ldc;
  L.red = o; o += block;
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(256)
fcm_partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ v, long long n, int d, int c,
                   float m, float expo, int t, float* __restrict__ part) {
  extern __shared__ float smem[];
  const Layout L = make_layout(d, c, t, blockDim.x);
  float* v_s = smem + L.v;
  float* v2_s = smem + L.v2;
  float* x_s = smem + L.x;
  float* x2_s = smem + L.x2;
  float* w_s = smem + L.w;
  float* d2_s = smem + L.d2;
  float* wum_s = smem + L.wum;
  float* red_s = smem + L.red;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int cd = c * d;
  const size_t p_len = (size_t)cd + c + 1;
  float* my_part = part + (size_t)blockIdx.x * p_len;

  for (int o = tid; o < cd + c; o += nt) my_part[o] = 0.f;
  for (int o = tid; o < cd; o += nt) {
    const int i = o / d, j = o - i * d;
    v_s[i * L.ldv + j] = v[o];
  }
  __syncthreads();
  for (int i = tid; i < c; i += nt) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) s = fmaf(v_s[i * L.ldv + k], v_s[i * L.ldv + k], s);
    v2_s[i] = s;
  }

  float q_acc = 0.f;
  const long long n_tiles = (n + t - 1) / t;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * t;
    const int rows = (int)min((long long)t, n - r0);
    const float* xg = x + r0 * (long long)d;
    for (int o = tid; o < t * d; o += nt) {
      const int r = o / d, j = o - r * d;
      x_s[r * L.ldx + j] = (r < rows) ? xg[o] : 0.f;
    }
    for (int r = tid; r < t; r += nt) w_s[r] = (r < rows) ? w[r0 + r] : 0.f;
    __syncthreads();

    for (int r = tid; r < t; r += nt) {
      float s = 0.f;
      for (int k = 0; k < d; ++k) s = fmaf(x_s[r * L.ldx + k], x_s[r * L.ldx + k], s);
      x2_s[r] = s;
    }
    __syncthreads();

    for (int o = tid; o < t * c; o += nt) {
      const int r = o / c, i = o - r * c;
      const float* xr = x_s + r * L.ldx;
      const float* vi = v_s + i * L.ldv;
      float dot = 0.f;
      for (int k = 0; k < d; ++k) dot = fmaf(xr[k], vi[k], dot);
      d2_s[r * L.ldc + i] = fmaxf(x2_s[r] + v2_s[i] - 2.f * dot, kD2Floor);
    }
    __syncthreads();

    // Log-space, max-normalized membership: one thread per row.
    for (int r = tid; r < t; r += nt) {
      const float* d2r = d2_s + r * L.ldc;
      float* wr = wum_s + r * L.ldc;
      float lmin = INFINITY;
      for (int i = 0; i < c; ++i) lmin = fminf(lmin, logf(d2r[i]));
      float s = 0.f;
      for (int i = 0; i < c; ++i) {
        const float ri = expf(-expo * (logf(d2r[i]) - lmin));
        wr[i] = ri;
        s += ri;
      }
      const float wk = w_s[r];
      float qr = 0.f;
      for (int i = 0; i < c; ++i) {
        const float wum = powf(wr[i] / s, m) * wk;
        wr[i] = wum;
        qr = fmaf(wum, d2r[i], qr);
      }
      q_acc += qr;
    }
    __syncthreads();

    // Each thread owns fixed outputs: v_num[i][j] for o < C*d, w_i after.
    for (int o = tid; o < cd + c; o += nt) {
      float acc = 0.f;
      if (o < cd) {
        const int i = o / d, j = o - i * d;
        for (int r = 0; r < t; ++r)
          acc = fmaf(wum_s[r * L.ldc + i], x_s[r * L.ldx + j], acc);
      } else {
        const int i = o - cd;
        for (int r = 0; r < t; ++r) acc += wum_s[r * L.ldc + i];
      }
      my_part[o] += acc;
    }
    __syncthreads();
  }

  // q: fixed-order tree reduction over the CTA (blockDim is a power of 2).
  red_s[tid] = q_acc;
  __syncthreads();
  for (int s = nt / 2; s > 0; s >>= 1) {
    if (tid < s) red_s[tid] += red_s[tid + s];
    __syncthreads();
  }
  if (tid == 0) my_part[cd + c] = red_s[0];
}

__global__ void fcm_reduce_kernel(const float* __restrict__ part, int g, int d,
                                  int c, int normalize, float* __restrict__ out_v,
                                  float* __restrict__ out_w,
                                  float* __restrict__ out_q) {
  const int cd = c * d;
  const size_t p_len = (size_t)cd + c + 1;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (int)p_len) return;
  float s = 0.f;
  for (int b = 0; b < g; ++b) s += part[(size_t)b * p_len + o];
  if (o < cd) {
    if (normalize) {
      // The same loop as the w_i output's, so the divisor equals it bit for bit.
      const int i = o / d;
      float wi = 0.f;
      for (int b = 0; b < g; ++b) wi += part[(size_t)b * p_len + cd + i];
      s = s / fmaxf(wi, kD2Floor);
    }
    out_v[o] = s;
  } else if (o < cd + c) {
    out_w[o - cd] = s;
  } else {
    *out_q = s;
  }
}

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
  // from device memory in the same sequential fmaf order as a record's
  // |x|^2 and x.v below, so that a record equal to a center gets d2 = 0
  // exactly.  It is read after the walk's first barrier.
  for (int o = tid; o < cd; o += kTileBlock) {
    const int i = o / d, j = o - i * d;
    fcm::cp_async4(v_s + i * L.ldv + j, v + o);
  }
  for (int i = tid; i < c; i += kTileBlock) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) s = fmaf(__ldg(v + i * d + k), __ldg(v + i * d + k), s);
    v2_s[i] = s;
  }

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
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      x2[i] = 0.f;
#pragma unroll
      for (int j = 0; j < RC; ++j) dot[i][j] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      float xv[kRM], vv[RC];
#pragma unroll
      for (int i = 0; i < kRM; ++i) xv[i] = xs[ridx[i] * L.ldx + k];
#pragma unroll
      for (int j = 0; j < RC; ++j) vv[j] = v_s[cidx[j] * L.ldv + k];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        x2[i] = fmaf(xv[i], xv[i], x2[i]);
#pragma unroll
        for (int j = 0; j < RC; ++j) dot[i][j] = fmaf(xv[i], vv[j], dot[i][j]);
      }
    }

    // Membership (fcm::memberships' form), the min and the sum over
    // centers completed by xor shuffles over the record's cg lanes.  A
    // record past the tile computes on stale values and writes nothing.
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = rgi + i * rg;
      const bool rv = r < rows;
      float d2[RC], a[RC];
      float lmin = INFINITY;
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        d2[j] = cval[j] ? fmaxf(x2[i] + v2_s[cidx[j]] - 2.f * dot[i][j], kD2Floor)
                        : INFINITY;
        a[j] = logf(d2[j]);
        lmin = fminf(lmin, a[j]);
      }
      for (int off = 1; off < cg; off <<= 1)
        lmin = fminf(lmin, __shfl_xor_sync(fcm::kFull, lmin, off));
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        a[j] = -expo * (a[j] - lmin);
        s += expf(a[j]);
      }
      for (int off = 1; off < cg; off <<= 1) s += __shfl_xor_sync(fcm::kFull, s, off);
      const float ls = logf(s);
      const float wk = ws[ridx[i]];
      float qr = 0.f;
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        if (rv && cval[j]) {
          const float wum = expf(m * (a[j] - ls)) * wk;
          wum_s[r * L.ldc + cidx[j]] = wum;
          qr = fmaf(wum, d2[j], qr);
        }
      }
      accq += qr;
    }
    __syncthreads();

    if (acc_on) {
#pragma unroll 2
      for (int r = rsi; r < rows; r += rs) {
        const float4 w4 = *reinterpret_cast<const float4*>(wum_s + r * L.ldc + agi * kAC);
        const float4* xp = reinterpret_cast<const float4*>(xs + r * L.ldx + dgi * kAD);
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
    __syncthreads();
    buf ^= 1;
  }
  fcm::cp_async_wait<0>();
  __syncthreads();

  // The CTA's partial: each output summed over the record subsets in order.
  float* scr = tile_smem + L.scr;
  float* scw = tile_smem + L.scw;
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
  __syncthreads();
  const int p_len = cd + c + 1;
  float* my = part + (size_t)blockIdx.x * p_len;
  for (int o = tid; o < cd + c; o += kTileBlock) {
    float s = 0.f;
    if (o < cd) {
      const int i = o / d, j = o - i * d;
      const size_t slot = (size_t)((i / kAC) * dg + j / kAD) * (kAC * kAD)
                          + (i % kAC) * kAD + j % kAD;
      for (int k = 0; k < rs; ++k) s += scr[(size_t)k * og * (kAC * kAD) + slot];
    } else {
      const int i = o - cd;
      for (int k = 0; k < rs; ++k) s += scw[k * ag * kAC + i];
    }
    my[o] = s;
  }
  if (tid == 0) {
    float q = 0.f;
    for (int k = 0; k < kTileBlock / 32; ++k) q += red_s[k];
    my[cd + c] = q;
  }
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

// Resident CTAs per SM at `block` threads and `smem` bytes of dynamic
// shared memory: path 0 the first version's stage 1, path 2
// fcm_tile_kernel<rc> (block is then 256).
int fcm_occupancy(int path, int rc, int block, int smem, int* per_sm) {
  *per_sm = 0;
  if (path == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        fcm_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, fcm_partial_kernel, block, smem);
  }
  switch (rc) {
    case 1: return tile_occupancy<1>(smem, per_sm);
    case 2: return tile_occupancy<2>(smem, per_sm);
    case 3: return tile_occupancy<3>(smem, per_sm);
    case 4: return tile_occupancy<4>(smem, per_sm);
  }
  return (int)cudaErrorInvalidValue;
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

// The first version on `stream`: stage 1 on `grid` CTAs of `block` threads
// with t-row tiles, then stage 2.  `part` holds grid * (C*d + C + 1)
// floats.  Returns cudaGetLastError() after the launches.
int fcm_accumulate(const float* x, const float* w, const float* v, long long n,
                   int d, int c, float m, float expo, int t, int grid, int block,
                   float* part, float* out_v, float* out_w, float* out_q,
                   int normalize, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = make_layout(d, c, t, block).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fcm_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fcm_partial_kernel<<<grid, block, smem, s>>>(x, w, v, n, d, c, m, expo, t, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int p_len = c * d + c + 1;
  const int rb = 256;
  fcm_reduce_kernel<<<(p_len + rb - 1) / rb, rb, 0, s>>>(part, grid, d, c, normalize,
                                                         out_v, out_w, out_q);
  return (int)cudaGetLastError();
}


}  // extern "C"

// Tenant-stacked FCM accumulation sweep (BigFCM paper, Alg. 1 body, T
// independent models in one launch) for Hopper, sm_90a.
//
// Replaces the jax.vmap of repro/kernels/fcm_update.py::_fcm_tile_kernel
// in repro/engine/backend.py:216-232 (SweepBackend.batched_accumulate /
// batched_sweep of the Pallas backends), the launch that
// repro.engine.fcm_converge_batched runs once per iteration.  For T
// tenants, records x (T, N, d) with weights w (T, N), centers V (T, C, d)
// and a fuzzifier m (T,), in IEEE fp32, per tenant t:
//
//   d2[k][i] = max(|x_k|^2 + |v_i|^2 - 2 x_k.v_i, 1e-12)
//   u[k][i]  = r_i / sum_j r_j,   r_i = exp(-(log d2_i - min_j log d2_j) / (m_t - 1))
//   wum      = u^m_t * w_k
//   v_num[t][i][j] = sum_k wum[k][i] x_k[j],  w_i[t][i] = sum_k wum[k][i],
//   q[t] = sum wum * d2
//
// and, for the sweep entry, v_new = v_num / max(w_i, 1e-12).  Zero-weight
// phantom rows add exactly 0, so an all-zero phantom tenant (x = 0, V = 0,
// w = 0) gives v_num = 0, w_i = 0, q = 0 and v_new = 0.
//
// What bounds it on an H100: the block of T*N*(d+1) floats is read once
// and the sweep does about 4*T*N*C*d flops, so at the tenant plane's
// widths (d = 4, C = 3) it is bound by memory (3.35 TB/s): 65,536 tenants
// of 512 rows, 671 MB, take at least 0.20 ms.  A record is only 20 bytes
// there, and its membership costs three logf and six expf (plus one logf
// per record) in the form below, so instruction issue comes close to the
// memory time: every instruction per record counts.  At the reference
// benchmark's cohort (1024 tenants of 32 rows, 0.66 MB) the bound is below
// a microsecond and launch latency sets the time.
//
// Two paths, chosen by kernels/fcm_update.py's launch plan:
//
//  * fcm_rows_kernel<DM, CM, U>, the fast path for small C*d (d <= DM,
//    C <= CM for one of the instantiated (DM, CM): (4,3), (4,4), (8,8),
//    (16,4), (32,2); (4,3) is the tenant plane's exact width, so no
//    center slot is computed for nothing).  No shared-memory tiles: each
//    thread owns records (neighbouring lanes on neighbouring records, U of
//    them in flight, read as float4 when d % 4 == 0), keeps its C*d + C + 1
//    sums in registers for its whole walk, and forms the membership
//    without powf (fcm_common.cuh).  V_t sits in shared memory and is read
//    as a broadcast.  A team of warps owns one (tenant, row split):
//      - one-warp teams, several per CTA, when the tenants alone fill the
//        card and a tenant has at most 1024 records (the tenant plane):
//        the warp loads its V_t, walks its tenant, sums by an xor tree and
//        writes v_new (or v_num), w_i and q itself.  No CTA barrier, no
//        partials, no second launch.
//      - a whole-CTA team otherwise; the warps' sums are added in warp
//        order.  With one split per tenant the CTA writes the outputs;
//        with more (few long tenants, or one model: the single-model
//        sweep calls this entry with T = 1) each CTA writes a partial and
//        the last ones to finish sum them in split order
//        (fcm::finish_partials).
//  * fcm_batched_partial_kernel + fcm_batched_reduce_kernel, the first
//    version, kept for C*d beyond the fast path (such as d = 41, C = 23):
//    the grid is (tenants x row-splits); a CTA loads V_t and m_t into
//    shared memory and walks its split's 128-row tiles of x and d2 in
//    shared memory, one thread per row for the membership, the two sums
//    over rows spread over floor(blockDim / (C*d + C)) row groups in a
//    shared-memory accumulator; a second kernel sums each tenant's
//    partials in split order.
//
// No float atomics in either path: for a fixed shape and card the
// summation order is fixed, and two launches on the same input are
// bit-identical.  Offsets are 64-bit: T*N*d reaches 1.3e8 on the tenant
// plane.

#include "fcm_common.cuh"

namespace {

constexpr float kD2Floor = 1e-12f;

struct Layout {      // offsets into dynamic shared memory, in floats
  int ldv, ldx, ldc;  // padded row strides of V, the x tile, the d2/wum tiles
  int groups;         // row groups of the two sums over rows
  size_t v, v2, x, x2, w, d2, wum, acc, red, total;
};

__host__ __device__ inline int row_groups(int d, int c, int t, int block) {
  const int n_out = c * d + c;
  int g = block / n_out;
  if (g > t) g = t;
  return g > 0 ? g : 1;
}

__host__ __device__ inline Layout make_layout(int d, int c, int t, int block) {
  Layout L;
  L.ldv = d | 1;
  L.ldx = d | 1;
  L.ldc = c | 1;
  L.groups = row_groups(d, c, t, block);
  size_t o = 0;
  L.v = o;   o += (size_t)c * L.ldv;
  L.v2 = o;  o += c;
  L.x = o;   o += (size_t)t * L.ldx;
  L.x2 = o;  o += t;
  L.w = o;   o += t;
  L.d2 = o;  o += (size_t)t * L.ldc;
  L.wum = o; o += (size_t)t * L.ldc;
  L.acc = o; o += (size_t)L.groups * (c * d + c);
  L.red = o; o += block;
  L.total = o;
  return L;
}

__global__ void __launch_bounds__(256)
fcm_batched_partial_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ v,
                           const float* __restrict__ m_t, long long n, int d,
                           int c, int t, float* __restrict__ part) {
  extern __shared__ float smem[];
  const Layout L = make_layout(d, c, t, blockDim.x);
  float* v_s = smem + L.v;
  float* v2_s = smem + L.v2;
  float* x_s = smem + L.x;
  float* x2_s = smem + L.x2;
  float* w_s = smem + L.w;
  float* d2_s = smem + L.d2;
  float* wum_s = smem + L.wum;
  float* acc_s = smem + L.acc;
  float* red_s = smem + L.red;

  const long long tenant = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int cd = c * d;
  const int n_out = cd + c;
  const int groups = L.groups;
  const int slots = groups * n_out;
  const float m = m_t[tenant];
  const float expo = 1.f / (m - 1.f);
  const float* xt = x + tenant * n * d;
  const float* wt = w + tenant * n;
  float* my_part = part + (size_t)(tenant * splits + split) * (n_out + 1);

  for (int o = tid; o < slots; o += nt) acc_s[o] = 0.f;
  for (int o = tid; o < cd; o += nt) {
    const int i = o / d, j = o - i * d;
    v_s[i * L.ldv + j] = v[tenant * cd + o];
  }
  __syncthreads();
  for (int i = tid; i < c; i += nt) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) s = fmaf(v_s[i * L.ldv + k], v_s[i * L.ldv + k], s);
    v2_s[i] = s;
  }

  float q_acc = 0.f;
  const long long n_tiles = (n + t - 1) / t;
  for (long long tile = split; tile < n_tiles; tile += splits) {
    const long long r0 = tile * t;
    const int rows = (int)min((long long)t, n - r0);
    const float* xg = xt + r0 * (long long)d;
    for (int o = tid; o < rows * d; o += nt) {
      const int r = o / d, j = o - r * d;
      x_s[r * L.ldx + j] = xg[o];
    }
    for (int r = tid; r < rows; r += nt) w_s[r] = wt[r0 + r];
    __syncthreads();

    for (int r = tid; r < rows; r += nt) {
      float s = 0.f;
      for (int k = 0; k < d; ++k) s = fmaf(x_s[r * L.ldx + k], x_s[r * L.ldx + k], s);
      x2_s[r] = s;
    }
    __syncthreads();

    for (int o = tid; o < rows * c; o += nt) {
      const int r = o / c, i = o - r * c;
      const float* xr = x_s + r * L.ldx;
      const float* vi = v_s + i * L.ldv;
      float dot = 0.f;
      for (int k = 0; k < d; ++k) dot = fmaf(xr[k], vi[k], dot);
      d2_s[r * L.ldc + i] = fmaxf(x2_s[r] + v2_s[i] - 2.f * dot, kD2Floor);
    }
    __syncthreads();

    // Log-space, max-normalized membership: one thread per row.
    for (int r = tid; r < rows; r += nt) {
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

    // Slot s = g*n_out + o: output o (v_num[i][j] for o < C*d, w_i after)
    // over the tile's rows g, g + G, ...
    for (int s = tid; s < slots; s += nt) {
      const int g = s / n_out, o = s - g * n_out;
      float acc = 0.f;
      if (o < cd) {
        const int i = o / d, j = o - i * d;
        for (int r = g; r < rows; r += groups)
          acc = fmaf(wum_s[r * L.ldc + i], x_s[r * L.ldx + j], acc);
      } else {
        const int i = o - cd;
        for (int r = g; r < rows; r += groups) acc += wum_s[r * L.ldc + i];
      }
      acc_s[s] += acc;
    }
    __syncthreads();
  }

  for (int o = tid; o < n_out; o += nt) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += acc_s[g * n_out + o];
    my_part[o] = s;
  }
  // q: fixed-order tree reduction over the CTA (blockDim is a power of 2).
  red_s[tid] = q_acc;
  __syncthreads();
  for (int s = nt / 2; s > 0; s >>= 1) {
    if (tid < s) red_s[tid] += red_s[tid + s];
    __syncthreads();
  }
  if (tid == 0) my_part[n_out] = red_s[0];
}

__global__ void fcm_batched_reduce_kernel(const float* __restrict__ part,
                                          long long tenants, int splits, int d,
                                          int c, int normalize,
                                          float* __restrict__ out_v,
                                          float* __restrict__ out_w,
                                          float* __restrict__ out_q) {
  const int cd = c * d;
  const int p_len = cd + c + 1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= tenants * p_len) return;
  const long long tenant = idx / p_len;
  const int o = (int)(idx - tenant * p_len);
  const float* tp = part + (size_t)tenant * splits * p_len;
  float s = 0.f;
  for (int b = 0; b < splits; ++b) s += tp[(size_t)b * p_len + o];
  if (o < cd) {
    if (normalize) {
      // The same loop as the w_i output's, so the divisor equals it bit for bit.
      const int i = o / d;
      float wi = 0.f;
      for (int b = 0; b < splits; ++b) wi += tp[(size_t)b * p_len + cd + i];
      s = s / fmaxf(wi, kD2Floor);
    }
    out_v[tenant * cd + o] = s;
  } else if (o < cd + c) {
    out_w[tenant * c + (o - cd)] = s;
  } else {
    out_q[tenant] = s;
  }
}

// ------------------------------------------------------------- fast path --

template <int DM, int CM, int U>
__global__ void __launch_bounds__(256)
fcm_rows_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ v, const float* __restrict__ m_t,
                float m_scalar, long long tenants, long long n, int d, int c,
                long long chunk, int splits, int team_warps, int slices,
                int normalize, float* __restrict__ part, int* __restrict__ tickets,
                float* __restrict__ out_v, float* __restrict__ out_w,
                float* __restrict__ out_q) {
  static_assert(DM <= 32, "one lane per dimension of V");
  constexpr int NV = CM * DM + CM + 1;
  __shared__ __align__(16) float v_s[8][CM][DM];
  __shared__ float red_s[8][NV];
  __shared__ float tot_s[NV];

  // A team of team_warps warps owns one (tenant, split).  One-warp teams
  // (several per CTA, one split per tenant) synchronize only their warp;
  // a whole-CTA team uses the CTA's barriers and may have splits.
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int team_threads = team_warps * 32;
  const int team = tid / team_threads, ttid = tid - team * team_threads;
  const long long item = (long long)blockIdx.x * (blockDim.x / team_threads) + team;
  const long long tenant = item / splits;
  if (tenant >= tenants) return;  // only one-warp teams of the last CTA
  const int split = (int)(item - tenant * splits);
  const int cd = c * d;
  const float* xt = x + tenant * n * d;
  const float* wt = w + tenant * n;
  const long long r0 = (long long)split * chunk;
  const long long r1 = min(n, r0 + chunk);
  const long long step = (long long)team_threads * U;
  const bool vec = (d % 4 == 0) && ((reinterpret_cast<uintptr_t>(xt) & 15) == 0);

  // U records per lane, neighbouring lanes on neighbouring records; a
  // record past the split reads as a zero-weight zero record, which adds
  // exactly 0.
  auto load = [&](long long rb, float (&xr)[U][DM], float (&wk)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = rb + (long long)u * team_threads;
      const bool ok = r < r1;
      const float* xp = xt + r * d;
      if (vec) {
#pragma unroll
        for (int q = 0; q < DM / 4; ++q) {
          float4 t4 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ok && 4 * q < d) t4 = __ldg(reinterpret_cast<const float4*>(xp) + q);
          xr[u][4 * q] = t4.x;
          xr[u][4 * q + 1] = t4.y;
          xr[u][4 * q + 2] = t4.z;
          xr[u][4 * q + 3] = t4.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < DM; ++j) xr[u][j] = (ok && j < d) ? __ldg(xp + j) : 0.f;
      }
      wk[u] = ok ? __ldg(wt + r) : 0.f;
    }
  };
  // The first records are on their way before V is staged.
  long long rb = r0 + ttid;
  float xc[U][DM], wc[U];
  load(rb, xc, wc);

  // V_t, staged by the team's first lanes (lane j: dimension j of every
  // center), zero past C and d.  |v_i|^2 runs in the same sequential fmaf
  // order as a record's |x|^2 and x.v, so that a record equal to a center
  // gets d2 = 0 exactly, as the plain version's |x - v|^2 does.
  const float m = m_t ? m_t[tenant] : m_scalar;
  const float expo = 1.f / (m - 1.f);
  float (*vt)[DM] = v_s[team];
  if (ttid < DM) {
#pragma unroll
    for (int i = 0; i < CM; ++i)
      vt[i][ttid] = (i < c && ttid < d) ? __ldg(v + tenant * cd + i * d + ttid) : 0.f;
  }
  if (team_warps == 1) __syncwarp(); else __syncthreads();
  float v2[CM];
#pragma unroll
  for (int i = 0; i < CM; ++i) {
    v2[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DM; ++j) v2[i] = fmaf(vt[i][j], vt[i][j], v2[i]);
  }

  float acc[CM][DM], accw[CM], accq = 0.f;
#pragma unroll
  for (int i = 0; i < CM; ++i) {
    accw[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DM; ++j) acc[i][j] = 0.f;
  }
  auto compute = [&](const float (&xr)[U][DM], const float (&wk)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x2 = 0.f;
#pragma unroll
      for (int j = 0; j < DM; ++j) x2 = fmaf(xr[u][j], xr[u][j], x2);
      float d2[CM], wum[CM];
#pragma unroll
      for (int i = 0; i < CM; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < DM; ++j) dot = fmaf(xr[u][j], vt[i][j], dot);
        d2[i] = fmaxf(x2 + v2[i] - 2.f * dot, kD2Floor);
      }
      fcm::memberships<CM>(d2, c, expo, m, wk[u], wum);
      float qr = 0.f;
#pragma unroll
      for (int i = 0; i < CM; ++i) {
        if (i < c) {
          qr = fmaf(wum[i], d2[i], qr);
          accw[i] += wum[i];
#pragma unroll
          for (int j = 0; j < DM; ++j) acc[i][j] = fmaf(wum[i], xr[u][j], acc[i][j]);
        }
      }
      accq += qr;
    }
  };
  for (; rb < r1; rb += step) {
    compute(xc, wc);
    if (rb + step < r1) load(rb + step, xc, wc);
  }

  // The team's sums: an xor tree in each warp over every register, all
  // trees before any store so that their shuffles interleave, then
  // (whole-CTA teams) the warps in order.  Slots past C and d hold zeros.
#pragma unroll
  for (int i = 0; i < CM; ++i) {
    accw[i] = fcm::warp_sum(accw[i]);
#pragma unroll
    for (int j = 0; j < DM; ++j) acc[i][j] = fcm::warp_sum(acc[i][j]);
  }
  accq = fcm::warp_sum(accq);
  if (team_warps == 1 && splits == 1) {
    // One warp owns the whole tenant and writes its outputs itself, each
    // lane a share of them; w_i as summed is the divisor, bit for bit.
#pragma unroll
    for (int i = 0; i < CM; ++i) {
#pragma unroll
      for (int j = 0; j < DM; ++j) {
        const float s = normalize ? acc[i][j] / fmaxf(accw[i], kD2Floor) : acc[i][j];
        if (i < c && j < d && lane == (i * DM + j) % 32) out_v[tenant * cd + i * d + j] = s;
      }
      if (i < c && lane == (CM * DM + i) % 32) out_w[tenant * c + i] = accw[i];
    }
    if (lane == 31) out_q[tenant] = accq;
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < CM; ++i) {
      if (i < c) {
#pragma unroll
        for (int j = 0; j < DM; ++j)
          if (j < d) red_s[warp][i * d + j] = acc[i][j];
        red_s[warp][cd + i] = accw[i];
      }
    }
    red_s[warp][cd + c] = accq;
  }
  __syncthreads();
  const int L = cd + c + 1;
  for (int o = tid; o < L; o += team_threads) {
    float s = 0.f;
    for (int k = 0; k < team_warps; ++k) s += red_s[k][o];
    tot_s[o] = s;
  }
  __syncthreads();
  if (splits == 1) {
    for (int o = tid; o < L; o += team_threads) {
      const float s = tot_s[o];
      if (o < cd)
        out_v[tenant * cd + o] = normalize ? s / fmaxf(tot_s[cd + o / d], kD2Floor) : s;
      else if (o < cd + c)
        out_w[tenant * c + (o - cd)] = s;
      else
        out_q[tenant] = s;
    }
    return;
  }
  float* my = part + (size_t)item * L;
  for (int o = tid; o < L; o += team_threads) my[o] = tot_s[o];
  fcm::finish_partials(part + (size_t)tenant * splits * L, tickets + 2 * tenant, splits,
                       L, slices, d, c, normalize, out_v + tenant * cd,
                       out_w + tenant * c, out_q + tenant);
}

template <int DM, int CM, int U>
int launch_rows(const float* x, const float* w, const float* v, const float* m_t,
                float m, long long tenants, long long n, int d, int c,
                long long chunk, int splits, int team_warps, int slices, int block,
                int grid, float* part, int* tickets, float* out_v, float* out_w,
                float* out_q, int normalize, cudaStream_t s) {
  fcm_rows_kernel<DM, CM, U><<<(unsigned)grid, block, 0, s>>>(
      x, w, v, m_t, m, tenants, n, d, c, chunk, splits, team_warps, slices,
      normalize, part, tickets, out_v, out_w, out_q);
  return (int)cudaGetLastError();
}

template <int DM, int CM, int U>
int rows_occupancy(int block, int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, fcm_rows_kernel<DM, CM, U>, block, 0);
}

}  // namespace

extern "C" {

const char* fcm_batched_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Resident CTAs per SM of one kernel at `block` threads and `smem` bytes
// of dynamic shared memory: path 0 the first version's stage 1, path 1
// fcm_rows_kernel<dm, cm>.
int fcm_batched_occupancy(int path, int dm, int cm, int block, int smem, int* per_sm) {
  *per_sm = 0;
  if (path == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        fcm_batched_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, fcm_batched_partial_kernel, block, smem);
  }
#define FCM_ROWS_VARIANTS(X) X(4, 3, 4) X(4, 4, 4) X(8, 8, 2) X(16, 4, 1) X(32, 2, 1)
#define FCM_ROWS_OCC(DM, CM, U) \
  if (dm == DM && cm == CM) return rows_occupancy<DM, CM, U>(block, per_sm);
  FCM_ROWS_VARIANTS(FCM_ROWS_OCC)
  return (int)cudaErrorInvalidValue;
}

// The fast path on `stream`: `grid` CTAs of `block` threads in teams of
// team_warps warps, team k of CTA b owning item b * (block / 32 /
// team_warps) + k, that is split item % splits of tenant item / splits,
// rows [split*chunk, (split+1)*chunk).  Splits need one team per CTA.
// m_t holds one fuzzifier per tenant, or is null and m applies to all.
// With splits > 1, `part` holds tenants * splits * (C*d + C + 1) floats
// and `tickets` 2 * tenants ints, zero before the first launch (each
// launch leaves them zero); with splits == 1 both may be null.  Returns
// cudaGetLastError().
int fcm_rows_sweep(const float* x, const float* w, const float* v,
                   const float* m_t, float m, long long tenants, long long n,
                   int d, int c, int dm, int cm, long long chunk, int splits,
                   int team_warps, int slices, int block, int grid, float* part,
                   int* tickets, float* out_v, float* out_w, float* out_q,
                   int normalize, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (block % 32 || block > 256 || (block / 32) % team_warps ||
      (splits != 1 && block != 32 * team_warps))
    return (int)cudaErrorInvalidValue;
#define FCM_ROWS_LAUNCH(DM, CM, U)                                                \
  if (dm == DM && cm == CM)                                                       \
    return launch_rows<DM, CM, U>(x, w, v, m_t, m, tenants, n, d, c, chunk, splits, \
                                  team_warps, slices, block, grid, part, tickets,  \
                                  out_v, out_w, out_q, normalize, s);
  FCM_ROWS_VARIANTS(FCM_ROWS_LAUNCH)
  return (int)cudaErrorInvalidValue;
}

// The first version on `stream`: stage 1 on a (tenants x splits) grid of
// `block` threads with t-row tiles and `smem_bytes` of shared memory, then
// stage 2.  `part` holds tenants * splits * (C*d + C + 1) floats; m_t holds
// one fuzzifier per tenant.  Returns cudaGetLastError() after the launches.
int fcm_batched_accumulate(const float* x, const float* w, const float* v,
                           const float* m_t, long long tenants, long long n,
                           int d, int c, int t, int splits, int smem_bytes,
                           int block, float* part, float* out_v, float* out_w,
                           float* out_q, int normalize, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      fcm_batched_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)tenants, (unsigned)splits);
  fcm_batched_partial_kernel<<<grid, block, smem_bytes, s>>>(x, w, v, m_t, n, d, c,
                                                             t, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long outs = tenants * (c * d + c + 1);
  const int rb = 256;
  fcm_batched_reduce_kernel<<<(unsigned)((outs + rb - 1) / rb), rb, 0, s>>>(
      part, tenants, splits, d, c, normalize, out_v, out_w, out_q);
  return (int)cudaGetLastError();
}


}  // extern "C"

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
// One kernel, fcm_rows_kernel<DM, CM, U>, for small C*d; past it
// kernels/fcm_update.py's launch plan sends the tenant-stacked sweep to
// fcm_accumulate.cu's register-blocked tile kernel (it takes a tenant
// axis, such as d = 41, C = 23) and, past that kernel's micro-tiles, to
// fcm_ctiled.cu's C-tiled sweep.
//
// fcm_rows_kernel takes d <= DM, C <= CM for one of the instantiated
// (DM, CM): (4,3), (4,4), (8,8), (16,4), (32,2); (4,3) is the tenant
// plane's exact width, so no center slot is computed for nothing.  No
// shared-memory tiles: each thread owns records (neighbouring lanes on
// neighbouring records, U of them in flight, read as float4 when d % 4 ==
// 0), keeps its C*d + C + 1 sums in registers for its whole walk, and forms
// the membership without powf (fcm_common.cuh).  V_t sits in shared memory
// and is read as a broadcast.  A team of warps owns one (tenant, row
// split):
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
//
// No float atomics: for a fixed shape and card the summation order is
// fixed, and two launches on the same input are bit-identical.  Offsets are 64-bit: T*N*d reaches 1.3e8 on the tenant
// plane.

#include "fcm_common.cuh"

namespace {

constexpr float kD2Floor = 1e-12f;

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

// Resident CTAs per SM of fcm_rows_kernel<dm, cm> at `block` threads.
int fcm_batched_occupancy(int dm, int cm, int block, int* per_sm) {
  *per_sm = 0;
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

}  // extern "C"

// C-tiled FCM accumulation sweep (BigFCM paper, Alg. 1 body) for Hopper,
// sm_90a: the single-model sweep (T = 1) and the tenant-stacked one for any
// C*d, however large, from one code path with a tenant axis.
//
// Replaces repro/kernels/fcm_update.py::_fcm_tile_kernel (reached through
// fcm_accumulate_pallas and fcm_sweep_pallas) and its jax.vmap in
// repro/engine/backend.py:216-232 at the widths where V no longer fits in
// shared memory beside one record: the first versions of
// fcm_accumulate.cu and fcm_batched.cu hold V whole there, and the launch
// plan (kernels/fcm_update.py, path "ctiled") sends every wider shape
// here, such as a router fit's d = 2048, C = 64 (OLMoE) or d = 7168,
// C = 384 (Kimi-K2).  For T tenants, records x (T, N, d) with weights
// w (T, N), centers V (T, C, d) and a fuzzifier m_t, in IEEE fp32:
//
//   d2[k][i] = max(|x_k|^2 + |v_i|^2 - 2 x_k.v_i, 1e-12)
//   u[k][i]  = r_i / sum_j r_j,   r_i = exp(-(log d2_i - min_j log d2_j) / (m_t - 1))
//   wum      = u^m_t * w_k        (fcm_common.cuh's log-space form, no powf)
//   v_num[t][i][j] = sum_k wum[k][i] x_k[j],  w_i = sum_k wum[k][i],  q = sum wum * d2
//
// and, for the sweep entry, v_new = v_num / max(w_i, 1e-12).  Zero-weight
// phantom rows add exactly 0, so an all-zero phantom tenant gives zeros.
//
// What bounds it on an H100: it reads N*(d+1)*4 bytes once and does
// 4*N*C*d f32 operations (the two contractions, x.v^T and wum^T x), so at
// these widths it is bound by arithmetic: at d = 2048, C = 64 a sweep over
// 262,144 records is 1.37e11 operations against 2.15 GB, at least 2.05 ms
// at 67 TFLOP/s.  No tensor cores: wgmma takes f32 operands as TF32, and
// the d2 cancellation at d = 2048 cannot afford it, so every FMA is a
// scalar IEEE f32 FMA.  What keeps such a kernel below the FMA peak is
// feeding the FMAs and waiting on memory:
//  - shared memory delivers 128 B a clock to an SM, and a thread that keeps
//    a 4 x 4 block of sums needs two 16-byte shared loads per 16 FMAs.  Both
//    contractions here keep 8 x 8 (or, in 64-record membership tiles,
//    4 x 8) sums per thread: four 16-byte loads per 64 FMAs, each one
//    shared-memory wavefront per warp (a warp's threads share their row
//    operands and read neighbouring column operands, every float4 in its
//    own bank group);
//  - synchronous tile loads between two barriers leave every global round
//    trip exposed.  Both kernels stream their tiles through a ring of
//    shared-memory stages filled by 16-byte cp.async (4-byte where d % 4
//    != 0), the next stages in flight while a stage's FMAs run, one
//    barrier per stage;
//  - at small N the membership's few row tiles leave the card idle while
//    each walks all of d.  There the plan splits d across CTAs (1.), and
//    the contraction's rows across more, shorter splits (2.).
//
// One chunk of rows (the wrapper walks the rows in chunks so that the
// scratch stays under a stated bound, and raw sums add across chunks) is
// three or four launches on the caller's stream (fcm_ctiled_stage launches
// one):
//
//  1. ctiled_member_kernel<RM>: one CTA per (row tile of 16*RM records,
//     d-split, tenant), 128 threads.  Per tile of 64 centers, the records'
//     and centers' dims of the split stream through a 3-stage ring as
//     [row][dim] tiles of 32 dims; each thread keeps RM x 8 sums of x.v
//     (records rg + 16 i, centers cg + 8 j), and owner threads form |x|^2
//     and |v|^2 in dim order beside them (about 3 % of the FMAs).
//     - One d-split (the plan's choice wherever 128-record tiles alone
//       fill the card, as at a router fit's full size): the tile's d2
//       block goes to shared memory where it fits (over the ring when
//       C <= 64), else to the wum scratch, so C is not capped; then
//       128 / (16 RM) threads per record form the membership (min of log
//       d2 and the sum over all C taken before u) and write wum and the
//       record's sum_i wum*d2.
//     - S > 1 d-splits of whole 32-dim chunks (at least 4 a split; enough
//       that row tiles x splits x tenants reach about two CTAs per SM):
//       each CTA writes its partial x.v block, |x|^2 and |v|^2 to scratch,
//       and
//  1b. ctiled_member_finish_kernel, one warp per record, sums them in
//     split order and forms d2 and the membership.  A launch, not the last
//     CTA of a row tile behind an integer ticket: in the ticketed version
//     that CTA alone summed the tile's 256 KB of partials (at 64 records,
//     16 splits, C = 64), one SM waiting on L2 round trips, and its
//     membership took 28 us at a 128-record merge against 12 us for these
//     two launches (scripts/compare_kernels.py on an H100).
//  2. ctiled_contract_kernel: one CTA per (64-center x 128-dim output
//     block, row split, tenant), 128 threads, forms v_num = wum^T x for
//     its block over its rows: wum and x tiles of 16 records a stage
//     through a 4-stage ring, record-major as they lie in memory, 8 x 8
//     sums per thread (centers in two float4s 32 apart, dims in two 64
//     apart).  The CTAs of the first dim block also sum w_i: each thread
//     adds the stage's 8 records of one half for one center, and the two
//     halves are added once at the end; the first of all sums the records'
//     q terms with the whole CTA.  Each writes its own partial: no two CTAs
//     write one float.  The plan sizes the splits so that blocks x splits
//     fill the card once at four CTAs per SM.
//  3. ctiled_finish_kernel: one CTA per (center, tenant) adds the split
//     partials in split order (32 loads in flight a thread), adds the sums
//     of earlier chunks (kept in the outputs) and, on the last chunk of a
//     sweep, normalizes.  Every thread of a CTA forms w_i the same way, so
//     the divisor equals the w_i output bit for bit.
//
// No float atomics: for a fixed shape, card and plan the summation order
// is fixed, and two launches on the same input are bit-identical.
// Offsets into x, the scratch and the outputs are 64-bit (N*d and N*C pass
// 2^31 at these widths).  The wum scratch rows are ldc = round4(C) floats
// apart, so that every one starts 16-byte aligned.

#include <stdint.h>

#include "fcm_common.cuh"

namespace {

constexpr float kD2Floor = 1e-12f;
constexpr int kThreads = 128;  // membership and contraction CTAs
constexpr int kFinish = 256;   // finish CTAs
constexpr int kBK = 16;        // records per stage of the contraction's ring
constexpr int kStages = 4;     // stages of the contraction's ring
constexpr int kMBK = 32;       // dims per stage of the membership's ring
constexpr int kMStages = 3;    // stages of the membership's ring
constexpr int kLDK = kMBK + 4; // row stride of the membership's [row][dim] tiles
constexpr int kTC = 64;        // centers per membership center tile
constexpr int kChunk = 32;     // dims per unit of a d-split
constexpr int kOC = 64;        // centers per output block of the contraction
constexpr int kOD = 128;       // dims per output block of the contraction

__host__ __device__ inline int round4(int a) { return (a + 3) & ~3; }

// Row stride of the shared d2 block: odd, so that the membership's
// threads (one or two per record) read distinct banks, and 9 more than a
// multiple of 32, so that the epilogue's 4 records x 8 centers of a warp
// meet at most two to a bank.
__host__ __device__ inline int d2_ld(int c) { return (c + 22) / 32 * 32 + 9; }

// The membership kernel's shared memory in floats: the ring, |x|^2 and w
// of the tile's records, |v|^2 of the center tile, and the d2 block when
// it is resident (over the ring when C <= 64 and it fits there).
struct MemberLayout {
  int x2, w, v2, d2, total;
};
__host__ __device__ inline MemberLayout member_layout(int c, int tile_rows,
                                                      int resident) {
  MemberLayout L;
  const int ring = kMStages * (tile_rows + kTC) * kLDK;
  L.x2 = ring;
  L.w = L.x2 + tile_rows;
  L.v2 = L.w + tile_rows;
  L.total = L.v2 + kTC;
  L.d2 = 0;
  if (resident && (c > kTC || tile_rows * d2_ld(c) > ring)) {
    L.d2 = L.total;
    L.total += tile_rows * d2_ld(c);
  }
  return L;
}

// sum_s p[s * stride] for s = 0 .. S-1 from L2, added in s order, eight
// loads in flight.
__device__ __forceinline__ float sum_splits(const float* p, size_t stride, int S) {
  float a = 0.f;
  int s0 = 0;
  for (; s0 + 8 <= S; s0 += 8) {
    float b[8];
#pragma unroll
    for (int g = 0; g < 8; ++g) b[g] = __ldcg(p + (s0 + g) * stride);
#pragma unroll
    for (int g = 0; g < 8; ++g) a += b[g];
  }
  for (; s0 < S; ++s0) a += __ldcg(p + s0 * stride);
  return a;
}

__device__ __forceinline__ void fma4(float a, const float4& b, float* acc) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// x, w: the tenant group's first tenant at row 0; v: its centers; wum:
// (tenants, ld_rows, ldc) scratch, qrow: (tenants, ld_rows); rows of this
// chunk start at r0.  grid (row tiles, d-splits S, tenants); the split s
// covers dims [s*kper*32, (s+1)*kper*32).  With S > 1, dpart holds per
// (tenant, split) an (ld_rows, ldc) block of partial x.v, then per
// (tenant, split, row) partial |x|^2, then per (tenant, split, row tile) an
// ldc block of partial |v|^2, which ctiled_member_finish_kernel sums.
template <int RM, bool VEC>
__global__ void __launch_bounds__(kThreads)
ctiled_member_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ v, const float* __restrict__ m_t,
                     float m_s, long long n, int d, int c, long long r0, int rows,
                     int ld_rows, int kper, int resident, float* wum,
                     float* __restrict__ qrow, float* __restrict__ dpart) {
  constexpr int R = 16 * RM;
  constexpr int kStage = (R + kTC) * kLDK;
  extern __shared__ __align__(16) float sm[];
  const MemberLayout L = member_layout(c, R, resident);
  float* x2s = sm + L.x2;
  float* ws = sm + L.w;
  float* v2s = sm + L.v2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp * 4 + (lane >> 3), cg = lane & 7;
  const int tile = blockIdx.x, s = blockIdx.y, t = blockIdx.z;
  const int S = gridDim.y, tenants = gridDim.z;
  const int rt0 = tile * R;
  const int nr = min(R, rows - rt0);
  const int kbeg = s * kper * kChunk, kend = min(d, kbeg + kper * kChunk);
  const int nst = (kend - kbeg + kMBK - 1) / kMBK;
  const float* xt = x + ((long long)t * n + r0 + rt0) * d;
  const float* vt = v + (long long)t * c * d;
  const int ldc = round4(c);
  float* wum_tile = wum + ((size_t)t * ld_rows + rt0) * ldc;
  float* d2 = resident ? sm + L.d2 : wum_tile;
  const int ldd = resident ? d2_ld(c) : ldc;
  const size_t dots = (size_t)tenants * S * ld_rows * ldc;
  float* px2 = dpart + dots;
  float* pv2 = px2 + (size_t)tenants * S * ld_rows;
  const int tiles_ld = (ld_rows + R - 1) / R;

  if (tid < R) ws[tid] = tid < nr ? w[(long long)t * n + r0 + rt0 + tid] : 0.f;

  // Stage st of the split (dims kbeg + kMBK * st ..) into its ring slot.
  auto load = [&](int st, int c0) {
    float* xs = sm + (st % kMStages) * kStage;
    float* vs = xs + R * kLDK;
    const int k0 = kbeg + st * kMBK;
    if (VEC) {
#pragma unroll
      for (int u = 0; u < R * (kMBK / 4) / kThreads; ++u) {
        const int e = tid + u * kThreads, r = e / (kMBK / 4), kk = 4 * (e % (kMBK / 4));
        const bool ok = r < nr && k0 + kk < kend;
        fcm::cp_async16(xs + r * kLDK + kk, ok ? xt + (long long)r * d + k0 + kk : x, ok);
      }
#pragma unroll
      for (int u = 0; u < kTC * (kMBK / 4) / kThreads; ++u) {
        const int e = tid + u * kThreads, i = e / (kMBK / 4), kk = 4 * (e % (kMBK / 4));
        const bool ok = c0 + i < c && k0 + kk < kend;
        fcm::cp_async16(vs + i * kLDK + kk,
                        ok ? vt + (long long)(c0 + i) * d + k0 + kk : v, ok);
      }
    } else {
      for (int e = tid; e < R * kMBK; e += kThreads) {
        const int r = e / kMBK, kk = e % kMBK, k = k0 + kk;
        const bool ok = r < nr && k < kend;
        fcm::cp_async4z(xs + r * kLDK + kk, ok ? xt + (long long)r * d + k : x, ok);
      }
      for (int e = tid; e < kTC * kMBK; e += kThreads) {
        const int i = e / kMBK, kk = e % kMBK, k = k0 + kk;
        const bool ok = c0 + i < c && k < kend;
        fcm::cp_async4z(vs + i * kLDK + kk, ok ? vt + (long long)(c0 + i) * d + k : v, ok);
      }
    }
  };

  for (int c0 = 0; c0 < c; c0 += kTC) {
    float acc[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float nx = 0.f, nv = 0.f;  // this thread's |x|^2 row, |v|^2 center
#pragma unroll
    for (int st = 0; st < kMStages - 1; ++st) {
      if (st < nst) load(st, c0);
      fcm::cp_async_commit();
    }
    for (int st = 0; st < nst; ++st) {
      fcm::cp_async_wait<kMStages - 2>();
      __syncthreads();  // stage st is in; every warp is done with st - 1
      if (st + kMStages - 1 < nst) load(st + kMStages - 1, c0);
      fcm::cp_async_commit();
      const float* xs = sm + (st % kMStages) * kStage;
      const float* vs = xs + R * kLDK;
      if (c0 == 0 && tid < R) {
#pragma unroll
        for (int q = 0; q < kMBK / 4; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(xs + tid * kLDK + 4 * q);
          nx = fmaf(a.x, a.x, nx);
          nx = fmaf(a.y, a.y, nx);
          nx = fmaf(a.z, a.z, nx);
          nx = fmaf(a.w, a.w, nx);
        }
      }
      if (tid >= kThreads - kTC) {
#pragma unroll
        for (int q = 0; q < kMBK / 4; ++q) {
          const float4 b =
              *reinterpret_cast<const float4*>(vs + (tid - (kThreads - kTC)) * kLDK + 4 * q);
          nv = fmaf(b.x, b.x, nv);
          nv = fmaf(b.y, b.y, nv);
          nv = fmaf(b.z, b.z, nv);
          nv = fmaf(b.w, b.w, nv);
        }
      }
#pragma unroll
      for (int q = 0; q < kMBK / 4; ++q) {
        float4 a[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          a[i] = *reinterpret_cast<const float4*>(xs + (rg + 16 * i) * kLDK + 4 * q);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(vs + (cg + 8 * j) * kLDK + 4 * q);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
          }
        }
      }
    }
    fcm::cp_async_wait<0>();
    if (c0 == 0 && tid < R) x2s[tid] = nx;
    if (tid >= kThreads - kTC) v2s[tid - (kThreads - kTC)] = nv;
    __syncthreads();  // norms in; every warp is done with the ring
    if (S == 1) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ci = c0 + cg + 8 * j;
          if (r < nr && ci < c)
            d2[(size_t)r * ldd + ci] =
                fmaxf(x2s[r] + v2s[cg + 8 * j] - 2.f * acc[i][j], kD2Floor);
        }
      }
    } else {
      float* dp = dpart + (((size_t)t * S + s) * ld_rows + rt0) * ldc;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ci = c0 + cg + 8 * j;
          if (r < nr && ci < c) dp[(size_t)r * ldc + ci] = acc[i][j];
        }
      }
      if (c0 == 0 && tid < nr) px2[((size_t)t * S + s) * ld_rows + rt0 + tid] = nx;
      const int i = tid - (kThreads - kTC);
      if (i >= 0 && c0 + i < c)
        pv2[(((size_t)t * S + s) * tiles_ld + tile) * ldc + c0 + i] = nv;
    }
    __syncthreads();  // x2s, v2s and the d2 block are read before reuse
  }

  if (S > 1) return;  // ctiled_member_finish_kernel takes it from here

  // The membership, G = 128 / R threads per record (min of log d2 and the
  // sum over all C before u; a pair adds its two halves with one xor
  // shuffle, the same bits in both), wum written over d2 in place, then
  // (resident d2) copied out to the scratch in whole rows.
  constexpr int G = kThreads / R;
  const float m = m_t ? m_t[t] : m_s;
  const float expo = 1.f / (m - 1.f);
  {
    const int r = tid / G, h = tid % G;
    const int cr = r < nr ? c : 0;  // every thread reaches the shuffles
    float* dr = d2 + (size_t)min(r, nr - 1) * ldd;
    float lmin = INFINITY;
#pragma unroll 4
    for (int i = h; i < cr; i += G) lmin = fminf(lmin, logf(dr[i]));
    if (G > 1) lmin = fminf(lmin, __shfl_xor_sync(fcm::kFull, lmin, 1));
    float sum = 0.f;
#pragma unroll 4
    for (int i = h; i < cr; i += G) sum += expf(-expo * (logf(dr[i]) - lmin));
    if (G > 1) sum += __shfl_xor_sync(fcm::kFull, sum, 1);
    const float ls = logf(sum), wk = ws[min(r, R - 1)];
    float q = 0.f;
#pragma unroll 4
    for (int i = h; i < cr; i += G) {
      const float d2i = dr[i];
      const float u = expf(m * (-expo * (logf(d2i) - lmin) - ls)) * wk;
      q = fmaf(u, d2i, q);
      dr[i] = u;
    }
    if (G > 1) q += __shfl_xor_sync(fcm::kFull, q, 1);
    if (r < nr && h == 0) qrow[(size_t)t * ld_rows + rt0 + r] = q;
  }
  if (resident) {
    __syncthreads();
    for (int e = tid; e < nr * c; e += kThreads) {
      const int r = e / c, i = e % c;
      wum_tile[(size_t)r * ldc + i] = d2[(size_t)r * ldd + i];
    }
  }
}

// sum_s p[s * stride] for s = 0 .. S-1 from L2, added in s order, sixteen
// loads in flight (S <= kMaxBatched; more in batches of eight).
constexpr int kMaxBatched = 16;
__device__ __forceinline__ float sum_splits16(const float* p, size_t stride, int S) {
  if (S > kMaxBatched) return sum_splits(p, stride, S);
  float b[kMaxBatched];
#pragma unroll
  for (int g = 0; g < kMaxBatched; ++g) b[g] = g < S ? __ldcg(p + g * stride) : 0.f;
  float a = 0.f;
#pragma unroll
  for (int g = 0; g < kMaxBatched; ++g)
    if (g < S) a += b[g];
  return a;
}

// With S > 1 d-splits: grid (ceil(rows / 8), tenants), one warp per
// record.  Sums the record's partial |x|^2, x.v and its tile's partial
// |v|^2 in split order into d2 (in its wum scratch row), then forms the
// membership there (min of log d2 and the sum over all C before u, by
// xor-shuffle trees whose bits every lane shares), writes wum over d2 and
// the record's sum_i wum*d2.
__global__ void __launch_bounds__(kFinish)
ctiled_member_finish_kernel(const float* __restrict__ w, const float* __restrict__ m_t,
                            float m_s, long long n, int c, long long r0, int rows,
                            int ld_rows, int tile_rows, int S,
                            const float* __restrict__ dpart, float* __restrict__ wum,
                            float* __restrict__ qrow) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kFinish / 32) + (threadIdx.x >> 5);
  const int t = blockIdx.y, tenants = gridDim.y;
  if (r >= rows) return;  // the whole warp
  const int ldc = round4(c);
  const int tiles_ld = (ld_rows + tile_rows - 1) / tile_rows;
  const size_t dots = (size_t)tenants * S * ld_rows * ldc;
  const float* px2 = dpart + dots;
  const float* pv2 = px2 + (size_t)tenants * S * ld_rows;
  const float x2 = sum_splits16(px2 + (size_t)t * S * ld_rows + r, ld_rows, S);
  const float* dot = dpart + ((size_t)t * S * ld_rows + r) * ldc;
  const float* v2 = pv2 + ((size_t)t * S * tiles_ld + r / tile_rows) * ldc;
  float* dr = wum + ((size_t)t * ld_rows + r) * ldc;  // d2, then wum
  for (int i = lane; i < c; i += 32)
    dr[i] = fmaxf(x2 + sum_splits16(v2 + i, (size_t)tiles_ld * ldc, S) -
                      2.f * sum_splits16(dot + i, (size_t)ld_rows * ldc, S),
                  kD2Floor);
  const float m = m_t ? m_t[t] : m_s;
  const float expo = 1.f / (m - 1.f);
  float lmin = INFINITY;
  for (int i = lane; i < c; i += 32) lmin = fminf(lmin, logf(dr[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lmin = fminf(lmin, __shfl_xor_sync(fcm::kFull, lmin, off));
  float sum = 0.f;
  for (int i = lane; i < c; i += 32) sum += expf(-expo * (logf(dr[i]) - lmin));
  const float ls = logf(fcm::warp_sum(sum));
  const float wk = w[(long long)t * n + r0 + r];
  float q = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float d2i = dr[i];
    const float u = expf(m * (-expo * (logf(d2i) - lmin) - ls)) * wk;
    q = fmaf(u, d2i, q);
    dr[i] = u;
  }
  q = fcm::warp_sum(q);
  if (lane == 0) qrow[(size_t)t * ld_rows + r] = q;
}

// Floats of the contraction's ring (dynamic shared memory).
constexpr int kContractStage = kBK * (kOC + kOD);
constexpr int kContractFloats = kStages * kContractStage + kThreads + kThreads / 32;

// part: (tenants, splits, C*d + C + 1); grid (C-blocks x d-blocks, splits,
// tenants).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
ctiled_contract_kernel(const float* __restrict__ x, const float* __restrict__ wum,
                       const float* __restrict__ qrow, long long n, int d, int c,
                       long long r0, int rows, int ld_rows, int splits,
                       float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  float* red = sm + kStages * kContractStage;  // [kThreads] w_i halves
  float* qred = red + kThreads;                // [kThreads / 32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ci0 = ((warp & 1) * 4 + (lane >> 3)) * 4;  // centers ci0.., 32 + ci0..
  const int dj0 = ((warp >> 1) * 8 + (lane & 7)) * 4;  // dims dj0.., 64 + dj0..
  const int cblocks = (c + kOC - 1) / kOC;
  const int cb = blockIdx.x % cblocks, db = blockIdx.x / cblocks;
  const int sp = blockIdx.y, t = blockIdx.z;
  const int per = (rows + splits - 1) / splits;
  const int ra = min(rows, sp * per), rb = min(rows, ra + per);
  const int c0 = cb * kOC, j0 = db * kOD;
  const int ldc = round4(c);
  const float* xt = x + ((long long)t * n + r0) * d;
  const float* ut = wum + (size_t)t * ld_rows * ldc;
  const int nst = (rb - ra + kBK - 1) / kBK;

  auto load = [&](int st) {
    float* us = sm + (st % kStages) * kContractStage;  // [record][center]
    float* xs = us + kBK * kOC;                        // [record][dim]
    const int k0 = ra + st * kBK;
#pragma unroll
    for (int u = 0; u < kBK * (kOC / 4) / kThreads; ++u) {
      const int e = tid + u * kThreads;
      const int kk = e / (kOC / 4), i = 4 * (e % (kOC / 4)), r = k0 + kk;
      const bool ok = r < rb && c0 + i < c;
      fcm::cp_async16(us + kk * kOC + i, ok ? ut + (size_t)r * ldc + c0 + i : wum, ok);
    }
    if (VEC) {
#pragma unroll
      for (int u = 0; u < kBK * (kOD / 4) / kThreads; ++u) {
        const int e = tid + u * kThreads;
        const int kk = e / (kOD / 4), j = 4 * (e % (kOD / 4)), r = k0 + kk;
        const bool ok = r < rb && j0 + j < d;
        fcm::cp_async16(xs + kk * kOD + j, ok ? xt + (long long)r * d + j0 + j : x, ok);
      }
    } else {
      for (int e = tid; e < kBK * kOD; e += kThreads) {
        const int kk = e / kOD, j = e % kOD, r = k0 + kk;
        const bool ok = r < rb && j0 + j < d;
        fcm::cp_async4z(xs + kk * kOD + j, ok ? xt + (long long)r * d + j0 + j : x, ok);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float wacc = 0.f;  // center tid % 64, records of half tid / 64 of each stage
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) load(st);
    fcm::cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    fcm::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (st + kStages - 1 < nst) load(st + kStages - 1);
    fcm::cp_async_commit();
    const float* us = sm + (st % kStages) * kContractStage;
    const float* xs = us + kBK * kOC;
    if (db == 0) {
      const int h = (tid / kOC) * (kBK / 2);
#pragma unroll
      for (int kk = 0; kk < kBK / 2; ++kk) wacc += us[(h + kk) * kOC + tid % kOC];
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(us + kk * kOC + ci0);
      const float4 a1 = *reinterpret_cast<const float4*>(us + kk * kOC + 32 + ci0);
      const float4 b0 = *reinterpret_cast<const float4*>(xs + kk * kOD + dj0);
      const float4 b1 = *reinterpret_cast<const float4*>(xs + kk * kOD + 64 + dj0);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        fma4(av[i], b0, acc[i]);
        fma4(av[i], b1, acc[i] + 4);
      }
    }
  }
  fcm::cp_async_wait<0>();

  const size_t cd = (size_t)c * d;
  float* p = part + ((size_t)t * splits + sp) * (cd + c + 1);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ci = c0 + ci0 + (i & 3) + (i >> 2) * 32;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = j0 + dj0 + (j & 3) + (j >> 2) * 64;
      if (ci < c && jj < d) p[(size_t)ci * d + jj] = acc[i][j];
    }
  }
  if (db == 0) {
    red[tid] = wacc;
    __syncthreads();
    if (tid < kOC && c0 + tid < c) p[cd + c0 + tid] = red[tid] + red[tid + kOC];
    if (cb == 0) {
      float s = 0.f;
      for (int r = ra + tid; r < rb; r += kThreads) s += qrow[(size_t)t * ld_rows + r];
      s = fcm::warp_sum(s);
      if (lane == 0) qred[warp] = s;
      __syncthreads();
      if (tid == 0) {
        float q = 0.f;
        for (int k = 0; k < kThreads / 32; ++k) q += qred[k];
        p[cd + c] = q;
      }
    }
  }
}

// grid (C + 1, tenants): CTA i < C owns center i's v_num row and w_i, CTA
// C owns q.  Outputs hold the sums of earlier chunks unless `first`.  A
// thread sums 8 outputs at once, four splits at a time (32 loads in
// flight), each in split order.
__global__ void __launch_bounds__(kFinish)
ctiled_finish_kernel(const float* __restrict__ part, int splits, int d, int c, int first,
                     int finish, float* __restrict__ out_v, float* __restrict__ out_w,
                     float* __restrict__ out_q) {
  const int i = blockIdx.x, t = blockIdx.y, tid = threadIdx.x;
  const size_t cd = (size_t)c * d, len = cd + c + 1;
  const float* pt = part + (size_t)t * splits * len;
  if (i == c) {
    if (tid == 0) {
      const float s = sum_splits(pt + cd + c, len, splits);
      out_q[t] = first ? s : out_q[t] + s;
    }
    return;
  }
  const float ws = sum_splits(pt + cd + i, len, splits);
  const float wi = first ? ws : out_w[(size_t)t * c + i] + ws;
  const float div = fmaxf(wi, kD2Floor);
  float* ov = out_v + ((size_t)t * c + i) * d;
  const float* pv = pt + (size_t)i * d;
  for (int jb = tid; jb < d; jb += 8 * kFinish) {
    float acc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] = 0.f;
    int s0 = 0;
    for (; s0 + 4 <= splits; s0 += 4) {
      float b[4][8];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = jb + u * kFinish;
          b[g][u] = j < d ? __ldcg(pv + (s0 + g) * len + j) : 0.f;
        }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[u] += b[g][u];
    }
    for (; s0 < splits; ++s0)
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = jb + u * kFinish;
        acc[u] += j < d ? __ldcg(pv + s0 * len + j) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = jb + u * kFinish;
      if (j < d) {
        const float s = first ? acc[u] : ov[j] + acc[u];
        ov[j] = finish ? s / div : s;
      }
    }
  }
  __syncthreads();  // every thread has read the earlier w_i
  if (tid == 0) out_w[(size_t)t * c + i] = wi;
}

template <int RM, bool VEC>
cudaError_t launch_member(dim3 grid, int smem, cudaStream_t s, const float* x,
                          const float* w, const float* v, const float* m_t, float m_s,
                          long long n, int d, int c, long long r0, int rows, int ld_rows,
                          int kper, int resident, float* wum, float* qrow, float* dpart) {
  cudaError_t err = cudaFuncSetAttribute(
      ctiled_member_kernel<RM, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ctiled_member_kernel<RM, VEC><<<grid, kThreads, smem, s>>>(
      x, w, v, m_t, m_s, n, d, c, r0, rows, ld_rows, kper, resident, wum, qrow, dpart);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_contract(dim3 grid, cudaStream_t s, const float* x, const float* wum,
                            const float* qrow, long long n, int d, int c, long long r0,
                            int rows, int ld_rows, int splits, float* part) {
  const int smem = kContractFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ctiled_contract_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ctiled_contract_kernel<VEC><<<grid, kThreads, smem, s>>>(x, wum, qrow, n, d, c, r0, rows,
                                                          ld_rows, splits, part);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

const char* fcm_ctiled_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launch `stage` of one row chunk of the C-tiled sweep on `stream`: 0 the
// membership (with S > 1 d-splits its x.v partials), 1 the membership's
// sum over the d-splits (nothing with S = 1), 2 the contraction, 3 the
// finish; for tenants [t0, t0 + tenants) of x (T, n, d), w (T, n),
// v (T, C, d), m_t (T,) or null (then m_s applies to all), rows
// [r0, r0 + rows).  Scratch: wum holds tenants * ld_rows * round4(C)
// floats, qrow tenants * ld_rows, part tenants * splits * (C*d + C + 1);
// rows <= ld_rows.  tile_rows (64 or 128) records per membership tile and
// kper 32-dim chunks per d-split, S = ceil(ceil(d / 32) / kper) splits;
// with S > 1, dpart holds tenants * S * (ld_rows * (round4(C) + 1) +
// ceil(ld_rows / tile_rows) * round4(C)) floats.  `first`: the chunk starts
// the sums (the outputs are not read); `finish`: normalize v (the sweep's
// last chunk).  Returns cudaGetLastError() after the launch.
int fcm_ctiled_stage(int stage, const float* x, const float* w, const float* v,
                     const float* m_t, float m_s, long long n, int d, int c, int t0,
                     int tenants, long long r0, int rows, int ld_rows, int splits,
                     int tile_rows, int kper, int resident, float* wum, float* qrow,
                     float* dpart, float* part, float* out_v, float* out_w, float* out_q,
                     int first, int finish, void* stream) {
  const int chunks = (d + kChunk - 1) / kChunk;
  const int dsplits = kper > 0 ? (chunks + kper - 1) / kper : 0;
  if (rows < 0 || rows > ld_rows || splits < 1 || tenants < 1 || tenants > 65535 ||
      splits > 65535 || c < 1 || d < 1 || (tile_rows != 64 && tile_rows != 128) ||
      dsplits < 1 || dsplits > 65535 || (dsplits > 1 && !dpart))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tn = t0;
  x += tn * n * d;
  w += tn * n;
  v += tn * c * d;
  if (m_t) m_t += t0;
  out_v += tn * c * d;
  out_w += tn * c;
  out_q += t0;
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(v);
  if (stage == 0) {
    if (rows == 0) return 0;
    const dim3 grid((rows + tile_rows - 1) / tile_rows, dsplits, tenants);
    const int smem = member_layout(c, tile_rows, resident).total * (int)sizeof(float);
    auto launch = tile_rows == 128
                      ? (vec ? &launch_member<8, true> : &launch_member<8, false>)
                      : (vec ? &launch_member<4, true> : &launch_member<4, false>);
    return (int)launch(grid, smem, s, x, w, v, m_t, m_s, n, d, c, r0, rows, ld_rows, kper,
                       resident, wum, qrow, dpart);
  }
  if (stage == 1) {
    if (rows == 0 || dsplits == 1) return 0;
    ctiled_member_finish_kernel<<<dim3((rows + kFinish / 32 - 1) / (kFinish / 32), tenants),
                                  kFinish, 0, s>>>(w, m_t, m_s, n, c, r0, rows, ld_rows,
                                                   tile_rows, dsplits, dpart, wum, qrow);
    return (int)cudaGetLastError();
  }
  if (stage == 2) {
    const dim3 grid(((c + kOC - 1) / kOC) * ((d + kOD - 1) / kOD), splits, tenants);
    return (int)(vec ? &launch_contract<true> : &launch_contract<false>)(
        grid, s, x, wum, qrow, n, d, c, r0, rows, ld_rows, splits, part);
  }
  ctiled_finish_kernel<<<dim3(c + 1, tenants), kFinish, 0, s>>>(
      part, splits, d, c, first, finish, out_v, out_w, out_q);
  return (int)cudaGetLastError();
}

// One row chunk of the C-tiled sweep: its launches in order (the
// arguments as fcm_ctiled_stage's).
int fcm_ctiled_chunk(const float* x, const float* w, const float* v, const float* m_t,
                     float m_s, long long n, int d, int c, int t0, int tenants,
                     long long r0, int rows, int ld_rows, int splits, int tile_rows,
                     int kper, int resident, float* wum, float* qrow, float* dpart,
                     float* part, float* out_v, float* out_w, float* out_q, int first,
                     int finish, void* stream) {
  for (int stage = 0; stage < 4; ++stage) {
    const int err = fcm_ctiled_stage(stage, x, w, v, m_t, m_s, n, d, c, t0, tenants, r0,
                                     rows, ld_rows, splits, tile_rows, kper, resident, wum,
                                     qrow, dpart, part, out_v, out_w, out_q, first, finish,
                                     stream);
    if (err) return err;
  }
  return 0;
}

}  // extern "C"

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
// 4*N*C*d f32 operations (the two contractions), so at these widths it is
// bound by arithmetic: at d = 2048, C = 64 a sweep over 262,144 records is
// 1.37e11 operations against 2.15 GB, at least 2.05 ms at 67 TFLOP/s.  No
// tensor cores and no TF32: the d2 cancellation at d = 2048 cannot afford
// it.  Every FMA here is a scalar f32 FMA with both operands from shared
// memory (two float4 loads feed a 4 x 4 register micro-tile), which caps it
// well below that peak; making it fast is later work.
//
// One chunk of rows (the wrapper walks the rows in chunks so that the
// scratch stays under a stated bound, and raw sums add across chunks) is
// three launches on the caller's stream:
//
//  1. ctiled_member_kernel: one CTA per (64-row tile, tenant).  V streams
//     through shared memory in tiles of 64 centers x 32 dims beside the
//     matching 32 dims of the 64 records; each thread keeps a 4 x 4 block
//     of x.v in registers, summed over the d-chunks in order.  The tile's
//     d2 block (64 x C) stays in shared memory where it fits beside the
//     tiles, else it goes to the wum scratch and is overwritten there by
//     wum, so C is not capped.  Then one warp per record forms the
//     membership (min of log d2 and the sum over all C taken before u),
//     writes wum to the N x C scratch and the record's sum_i wum*d2.
//  2. ctiled_contract_kernel: one CTA per (64-center x 64-dim output block,
//     row split, tenant) forms v_num = wum^T x for its block from the
//     scratch and x, in 32-row steps through shared memory (4 x 4 register
//     micro-tiles again); the CTAs of the first dim block also sum w_i, and
//     the first of all sums the records' q terms.  Each writes its own
//     partial: no two CTAs write one float.
//  3. ctiled_finish_kernel: one CTA per (center, tenant) adds the split
//     partials in split order, adds the sums of earlier chunks (kept in the
//     outputs) and, on the last chunk of a sweep, normalizes.  Every thread
//     of a CTA forms w_i the same way, so the divisor equals the w_i output
//     bit for bit.
//
// No float atomics: for a fixed shape, card and chunking the summation
// order is fixed, and two launches on the same input are bit-identical.
// Offsets into x, the scratch and the outputs are 64-bit (N*d and N*C pass
// 2^31 at these widths).

#include "fcm_common.cuh"

namespace {

constexpr float kD2Floor = 1e-12f;
constexpr int kBlock = 256;
constexpr int kTR = 64;        // records per membership tile
constexpr int kTC = 64;        // centers per V tile
constexpr int kTD = 32;        // dims per V / x tile
constexpr int kLD = 68;        // shared row stride of the transposed tiles
constexpr int kOC = 64;        // centers per output block of the contraction
constexpr int kOD = 64;        // dims per output block of the contraction
constexpr int kKR = 32;        // records per step of the contraction

__host__ __device__ inline int round4(int a) { return (a + 3) & ~3; }

// Shared floats of the membership kernel: the x and V tiles ([dim][row]
// and [dim][center]), |x|^2, |v|^2 of the V tile, w, and the d2 block.
__host__ __device__ inline size_t member_floats(int c, int resident) {
  const size_t base = 2 * (size_t)kTD * kLD + 2 * kTR + kTC;
  return base + (resident ? (size_t)kTR * round4(c) : 0);
}

// 16 FMAs from two float4 shared loads: acc[i][j] += a[i] * b[j].
__device__ __forceinline__ void fma4x4(const float* a_s, const float* b_s,
                                       float (&acc)[4][4]) {
  const float4 a = *reinterpret_cast<const float4*>(a_s);
  const float4 b = *reinterpret_cast<const float4*>(b_s);
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// x, w: the tenant group's first tenant at row 0; v: its centers; wum:
// (tenants, ld_rows, C) scratch, qrow: (tenants, ld_rows); rows of this
// chunk start at r0.
__global__ void __launch_bounds__(kBlock)
ctiled_member_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ v, const float* __restrict__ m_t,
                     float m_s, long long n, int d, int c, long long r0, int rows,
                     int ld_rows, int resident, float* wum, float* __restrict__ qrow) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                    // [kTD][kLD]
  float* vs = xs + kTD * kLD;        // [kTD][kLD]
  float* x2s = vs + kTD * kLD;       // [kTR]
  float* ws = x2s + kTR;             // [kTR]
  float* v2s = ws + kTR;             // [kTC]
  float* d2s = v2s + kTC;            // [kTR][round4(C)] when resident

  const int tid = threadIdx.x;
  const int t = blockIdx.y;
  const int rt0 = blockIdx.x * kTR;  // the tile's first row in the chunk
  const int nr = min(kTR, rows - rt0);
  const float* xt = x + ((long long)t * n + r0 + rt0) * d;
  const float* vt = v + (long long)t * c * d;
  const float m = m_t ? m_t[t] : m_s;
  const float expo = 1.f / (m - 1.f);
  float* wum_tile = wum + ((size_t)t * ld_rows + rt0) * c;
  float* d2 = resident ? d2s : wum_tile;
  const int ldd = resident ? round4(c) : c;

  if (tid < kTR) ws[tid] = tid < nr ? w[(long long)t * n + r0 + rt0 + tid] : 0.f;
  const int tx = tid & 15, ty = tid >> 4;  // centers tx*4.., records ty*4..
  for (int c0 = 0; c0 < c; c0 += kTC) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += kTD) {
      __syncthreads();  // the previous tiles (and d2 writes) are done
      for (int e = tid; e < kTR * kTD; e += kBlock) {
        const int r = e / kTD, kk = e % kTD, k = k0 + kk;
        xs[kk * kLD + r] = (r < nr && k < d) ? xt[(long long)r * d + k] : 0.f;
      }
      for (int e = tid; e < kTC * kTD; e += kBlock) {
        const int i = e / kTD, kk = e % kTD, k = k0 + kk;
        vs[kk * kLD + i] = (c0 + i < c && k < d) ? vt[(long long)(c0 + i) * d + k] : 0.f;
      }
      __syncthreads();
      // |x|^2 (first center tile only) and |v|^2, each by one owner thread
      // in dim order.
      if (tid < kTR && c0 == 0) {
        float s = k0 == 0 ? 0.f : x2s[tid];
        for (int kk = 0; kk < kTD; ++kk) s = fmaf(xs[kk * kLD + tid], xs[kk * kLD + tid], s);
        x2s[tid] = s;
      } else if (tid >= 128 && tid < 128 + kTC) {
        const int i = tid - 128;
        float s = k0 == 0 ? 0.f : v2s[i];
        for (int kk = 0; kk < kTD; ++kk) s = fmaf(vs[kk * kLD + i], vs[kk * kLD + i], s);
        v2s[i] = s;
      }
#pragma unroll 8
      for (int kk = 0; kk < kTD; ++kk)
        fma4x4(xs + kk * kLD + ty * 4, vs + kk * kLD + tx * 4, acc);
    }
    __syncthreads();  // x2s, v2s complete
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = c0 + tx * 4 + j;
        if (r < nr && ci < c)
          d2[(size_t)r * ldd + ci] =
              fmaxf(x2s[r] + v2s[tx * 4 + j] - 2.f * acc[i][j], kD2Floor);
      }
    }
  }
  __syncthreads();  // the d2 block is complete

  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < nr; r += kBlock / 32) {
    const float* dr = d2 + (size_t)r * ldd;
    float lmin = INFINITY;
    for (int i = lane; i < c; i += 32) lmin = fminf(lmin, logf(dr[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lmin = fminf(lmin, __shfl_xor_sync(fcm::kFull, lmin, off));
    float s = 0.f;
    for (int i = lane; i < c; i += 32) s += expf(-expo * (logf(dr[i]) - lmin));
    const float ls = logf(fcm::warp_sum(s));
    const float wk = ws[r];
    float* out = wum_tile + (size_t)r * c;  // may alias dr: each lane
    float q = 0.f;                          // reads its i, then writes it
    for (int i = lane; i < c; i += 32) {
      const float d2i = dr[i];
      const float u = expf(m * (-expo * (logf(d2i) - lmin) - ls)) * wk;
      q = fmaf(u, d2i, q);
      out[i] = u;
    }
    q = fcm::warp_sum(q);
    if (lane == 0) qrow[(size_t)t * ld_rows + rt0 + r] = q;
  }
}

// part: (tenants, splits, C*d + C + 1); grid (C-blocks x d-blocks, splits,
// tenants).
__global__ void __launch_bounds__(kBlock)
ctiled_contract_kernel(const float* __restrict__ x, const float* __restrict__ wum,
                       const float* __restrict__ qrow, long long n, int d, int c,
                       long long r0, int rows, int ld_rows, int splits,
                       float* __restrict__ part) {
  __shared__ __align__(16) float us[kKR * kLD];  // [record][center]
  __shared__ __align__(16) float xs[kKR * kLD];  // [record][dim]
  const int tid = threadIdx.x;
  const int cblocks = (c + kOC - 1) / kOC;
  const int cb = blockIdx.x % cblocks, db = blockIdx.x / cblocks;
  const int sp = blockIdx.y, t = blockIdx.z;
  const int per = (rows + splits - 1) / splits;
  const int ra = min(rows, sp * per), rb = min(rows, ra + per);
  const int c0 = cb * kOC, j0 = db * kOD;
  const float* xt = x + ((long long)t * n + r0) * d;
  const float* ut = wum + (size_t)t * ld_rows * c;
  const int tx = tid & 15, ty = tid >> 4;  // dims tx*4.., centers ty*4..

  float acc[4][4] = {};
  float wacc = 0.f;
  for (int k0 = ra; k0 < rb; k0 += kKR) {
    __syncthreads();
    for (int e = tid; e < kKR * kOC; e += kBlock) {
      const int kk = e / kOC, i = e % kOC, r = k0 + kk;
      us[kk * kLD + i] = (r < rb && c0 + i < c) ? ut[(size_t)r * c + c0 + i] : 0.f;
      xs[kk * kLD + i] = (r < rb && j0 + i < d) ? xt[(long long)r * d + j0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKR; ++kk)
      fma4x4(us + kk * kLD + ty * 4, xs + kk * kLD + tx * 4, acc);
    if (db == 0 && tid < kOC)
      for (int kk = 0; kk < kKR; ++kk) wacc += us[kk * kLD + tid];
  }

  const size_t cd = (size_t)c * d;
  float* p = part + ((size_t)t * splits + sp) * (cd + c + 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = c0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + tx * 4 + j;
      if (ci < c && jj < d) p[(size_t)ci * d + jj] = acc[i][j];
    }
  }
  if (db == 0 && tid < kOC && c0 + tid < c) p[cd + c0 + tid] = wacc;
  if (db == 0 && cb == 0 && tid >= 128 && tid < 160) {
    float s = 0.f;
    for (int r = ra + tid - 128; r < rb; r += 32) s += qrow[(size_t)t * ld_rows + r];
    s = fcm::warp_sum(s);
    if (tid == 128) p[cd + c] = s;
  }
}

// grid (C + 1, tenants): CTA i < C owns center i's v_num row and w_i, CTA
// C owns q.  Outputs hold the sums of earlier chunks unless `first`.
__global__ void __launch_bounds__(kBlock)
ctiled_finish_kernel(const float* __restrict__ part, int splits, int d, int c, int first,
                     int finish, float* __restrict__ out_v, float* __restrict__ out_w,
                     float* __restrict__ out_q) {
  const int i = blockIdx.x, t = blockIdx.y, tid = threadIdx.x;
  const size_t cd = (size_t)c * d, len = cd + c + 1;
  const float* pt = part + (size_t)t * splits * len;
  if (i == c) {
    if (tid == 0) {
      float s = 0.f;
      for (int sp = 0; sp < splits; ++sp) s += pt[sp * len + cd + c];
      out_q[t] = first ? s : out_q[t] + s;
    }
    return;
  }
  float ws = 0.f;
  for (int sp = 0; sp < splits; ++sp) ws += pt[sp * len + cd + i];
  const float wi = first ? ws : out_w[(size_t)t * c + i] + ws;
  const float div = fmaxf(wi, kD2Floor);
  float* ov = out_v + ((size_t)t * c + i) * d;
  for (int j = tid; j < d; j += kBlock) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += pt[sp * len + (size_t)i * d + j];
    s = first ? s : ov[j] + s;
    ov[j] = finish ? s / div : s;
  }
  __syncthreads();  // every thread has read the earlier w_i
  if (tid == 0) out_w[(size_t)t * c + i] = wi;
}

}  // namespace

extern "C" {

const char* fcm_ctiled_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One row chunk of the C-tiled sweep on `stream`, for tenants
// [t0, t0 + tenants) of x (T, n, d), w (T, n), v (T, C, d), m_t (T,) or
// null (then m_s applies to all), rows [r0, r0 + rows).  Scratch: wum
// holds tenants * ld_rows * C floats, qrow tenants * ld_rows, part
// tenants * splits * (C*d + C + 1); rows <= ld_rows.  `first`: the chunk
// starts the sums (the outputs are not read); `finish`: normalize v (the
// sweep's last chunk).  Returns cudaGetLastError() after the launches.
int fcm_ctiled_chunk(const float* x, const float* w, const float* v, const float* m_t,
                     float m_s, long long n, int d, int c, int t0, int tenants,
                     long long r0, int rows, int ld_rows, int splits, int resident,
                     float* wum, float* qrow, float* part, float* out_v, float* out_w,
                     float* out_q, int first, int finish, void* stream) {
  if (rows < 0 || rows > ld_rows || splits < 1 || tenants < 1 || tenants > 65535 ||
      splits > 65535 || c < 1 || d < 1)
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
  if (rows > 0) {
    const int smem = (int)(member_floats(c, resident) * sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        ctiled_member_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ctiled_member_kernel<<<dim3((rows + kTR - 1) / kTR, tenants), kBlock, smem, s>>>(
        x, w, v, m_t, m_s, n, d, c, r0, rows, ld_rows, resident, wum, qrow);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = ((c + kOC - 1) / kOC) * ((d + kOD - 1) / kOD);
  ctiled_contract_kernel<<<dim3(blocks, splits, tenants), kBlock, 0, s>>>(
      x, wum, qrow, n, d, c, r0, rows, ld_rows, splits, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ctiled_finish_kernel<<<dim3(c + 1, tenants), kBlock, 0, s>>>(
      part, splits, d, c, first, finish, out_v, out_w, out_q);
  return (int)cudaGetLastError();
}

}  // extern "C"

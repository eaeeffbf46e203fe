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
// of 512 rows, 671 MB, take at least 0.20 ms.  Second comes the
// membership: two logf, an expf and a powf per (row, center), about 4e8
// special-function operations at that size, roughly 0.1 ms of issue.  At
// the reference benchmark's cohort (1024 tenants of 32 rows, 0.66 MB) the
// bound is below a microsecond and the launch latency sets the time.
//
// Design: the grid is (tenants x row-splits).
//   * Stage 1 (fcm_batched_partial_kernel): a CTA loads its tenant's V_t
//     and m_t into shared memory (expo = 1/(m_t - 1) is formed here, on
//     the device) and walks its split's row tiles of that tenant, tile
//     after tile, as the single-model kernel's stage 1 does: x tile and d2
//     in shared memory, one thread per row for the log-space membership.
//     The two sums over rows are spread over the CTA: with n_out = C*d + C
//     outputs and G = min(blockDim / n_out, tile rows) row groups, each of
//     the G*n_out slots is owned by one thread, which adds its rows (r = g,
//     g + G, ...) in order into a shared-memory accumulator that lives for
//     the whole walk.  At the end the G groups are summed in group order
//     into the CTA's partial (C*d + C + 1 floats) for its (tenant, split).
//   * Stage 2 (fcm_batched_reduce_kernel): one thread per (tenant, output)
//     sums that tenant's partials in split order and, for the sweep,
//     divides by max(w_i, 1e-12).
//   * Splits: as many as it takes to give the card a persistent grid's
//     worth of CTAs, never more than a tenant has tiles.  So 1024 tenants
//     of 32 rows take one CTA each, and a few long tenants take several.
//   No float atomics: for a fixed shape and card the summation order is
//   fixed, and two launches on the same input are bit-identical.
//   Offsets are 64-bit: T*N*d reaches 1.3e8 on the tenant plane.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTileRows = 128;
constexpr int kMaxSplits = 65535;   // gridDim.y limit
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

}  // namespace

extern "C" {

const char* fcm_batched_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Tile height, row splits per tenant and shared-memory bytes for one
// shape on the current card.  tile_rows is the largest T <= min(128, N)
// whose shared memory fits the per-block limit (0 when even V_t does not
// fit: C*d too large for this kernel).  splits is the persistent grid's
// CTA count over the tenants, rounded up, at most the tenant's tile count.
int fcm_batched_plan(long long tenants, long long n, int d, int c, int block,
                     int* tile_rows, int* splits, int* smem_bytes) {
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *tile_rows = 0;
  *splits = 0;
  *smem_bytes = 0;
  const int t_max = (int)(n < kMaxTileRows ? n : kMaxTileRows);
  int t = 0;
  for (int cand = t_max; cand >= 1; --cand) {
    if (make_layout(d, c, cand, block).total * sizeof(float) <= (size_t)max_smem) {
      t = cand;
      break;
    }
  }
  if (t == 0) return 0;
  const size_t smem = make_layout(d, c, t, block).total * sizeof(float);
  err = cudaFuncSetAttribute(fcm_batched_partial_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fcm_batched_partial_kernel, block, smem);
  if (err != cudaSuccess) return (int)err;
  const long long target = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long n_tiles = (n + t - 1) / t;
  long long s = (target + tenants - 1) / tenants;
  if (s > n_tiles) s = n_tiles;
  if (s > kMaxSplits) s = kMaxSplits;
  *tile_rows = t;
  *splits = s > 0 ? (int)s : 1;
  *smem_bytes = (int)smem;
  return 0;
}

// Launches both stages on `stream`.  `part` holds tenants * splits *
// (C*d + C + 1) floats; m_t holds one fuzzifier per tenant.  Returns
// cudaGetLastError() after the launches.
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

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
// f32 arithmetic above.  This first version does both contractions as
// scalar FMAs from shared memory (no tensor cores: TF32 would break the
// d2 cancellation), so for larger C it is bound by shared-memory
// bandwidth, one shared load per FMA, well above the arithmetic bound.
//
// Design:
//   * Stage 1 (fcm_partial_kernel): a persistent grid of a few CTAs per SM.
//     Each CTA keeps V in shared memory for the whole sweep and walks row
//     tiles of T records with a grid-stride loop.  Per tile it stages x in
//     shared memory, computes d2 (T x C) into shared memory, lets one
//     thread per row do the log-space membership over the C centers, and
//     then each thread adds its fixed set of (i, j) outputs of v_num and
//     w_i over the tile's rows, in row order, into the CTA's own slice of
//     a partials buffer.  The N x C membership never reaches device memory.
//   * Stage 2 (fcm_reduce_kernel): one thread per output sums the CTA
//     partials in CTA order and, for the sweep, divides by max(w_i, 1e-12).
//   No float atomics anywhere: for a fixed shape and card the summation
//   order is fixed, so two runs on the same input are bit-identical.  This
//   stands in for the TPU kernel's revisited output block, which relies on
//   a sequential grid that CUDA does not have.
//   * Shared-memory row strides of V, x and d2 are padded to odd lengths so
//     that threads walking a column hit distinct banks.
//   * Offsets into x are 64-bit: N*d exceeds 2^31 at the paper's sizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTileRows = 128;
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

}  // namespace

extern "C" {

const char* fcm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Largest tile T <= 128 whose shared memory fits the card's per-block
// limit; 0 when even V alone does not fit (C*d too large for this kernel).
int fcm_tile_rows(int d, int c, int block, int* tile_rows) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  *tile_rows = 0;
  for (int t = kMaxTileRows; t >= 1; --t) {
    if (make_layout(d, c, t, block).total * sizeof(float) <= (size_t)max_smem) {
      *tile_rows = t;
      break;
    }
  }
  return 0;
}

// Persistent grid: as many CTAs as fit on the card at once, never more than
// there are tiles, at least one.
int fcm_grid_size(long long n, int d, int c, int t, int block, int* grid) {
  const size_t smem = make_layout(d, c, t, block).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fcm_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fcm_partial_kernel,
                                                      block, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + t - 1) / t;
  long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (n_tiles < g) g = n_tiles;
  *grid = g > 0 ? (int)g : 1;
  return 0;
}

// Launches both stages on `stream`.  `part` holds grid * (C*d + C + 1)
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

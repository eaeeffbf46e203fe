// Device code shared by the three FCM sweep sources (fcm_accumulate.cu,
// fcm_batched.cu and fcm_ctiled.cu): the membership of one record
// without powf, warp sums, 4- and 16-byte cp.async, and the ticketed
// final reduce that replaces a second launch.
//
// Determinism.  Every sum below runs in an order fixed by the launch
// shape alone: xor-shuffle trees have a fixed pattern (and give the same
// bits in every lane, since each step adds the same two values in either
// order), CTA partials are summed in partial order, and the integer ticket
// counter only decides which CTA does the final sum, never the order of
// its terms.  No float atomics.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fcm {

constexpr float kD2Floor = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;

// The log-space, max-normalized membership of one record over CN center
// slots (the first c valid), IEEE logf/expf and no powf:
//   a_i   = -(log d2_i - min_j log d2_j) / (m - 1)
//   r_i   = exp(a_i),  s = sum_i r_i  (in slot order)
//   wum_i = exp(m * (a_i - log s)) * w  = u_i^m * w
// One logf and two expf per (record, center), one logf per record.
template <int CN>
__device__ __forceinline__ void memberships(const float (&d2)[CN], int c,
                                            float expo, float m, float wk,
                                            float (&wum)[CN]) {
  float a[CN];
  float lmin = INFINITY;
#pragma unroll
  for (int i = 0; i < CN; ++i) {
    a[i] = logf(d2[i]);
    if (i < c) lmin = fminf(lmin, a[i]);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CN; ++i) {
    a[i] = -expo * (a[i] - lmin);
    if (i < c) s += expf(a[i]);
  }
  const float ls = logf(s);
#pragma unroll
  for (int i = 0; i < CN; ++i) wum[i] = (i < c) ? expf(m * (a[i] - ls)) * wk : 0.f;
}

// Sum over the 32 lanes of a warp; every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
// 16 bytes (4 floats, both addresses 16-byte aligned), cached in L2 only;
// with ok false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0)
               : "memory");
}
// 4 bytes, zeroed where ok is false.
__device__ __forceinline__ void cp_async4z(float* smem, const float* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Output o of P partials of L floats, summed by g lanes of one warp (g a
// power of 2 <= 32, lane gl of the group adds partials gl, gl + g, ... in
// order, eight loads in flight at a time) and an xor tree over the group.
// Every lane of the warp must call it (the shuffles use the full mask).
__device__ __forceinline__ float sum_partials(const float* __restrict__ part, int P,
                                              int L, int o, int g, int gl) {
  float s = 0.f;
  int p = gl;
  for (; p + 7 * g < P; p += 8 * g) {
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = __ldcg(part + (size_t)(p + u * g) * L + o);
#pragma unroll
    for (int u = 0; u < 8; ++u) s += t[u];
  }
  for (; p < P; p += g) s += __ldcg(part + (size_t)p * L + o);
  for (int off = g >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// Outputs o and o2 at once, each summed exactly as sum_partials sums it
// (so the bits agree), with both loads of a step in flight together.
__device__ __forceinline__ float2 sum_partials2(const float* __restrict__ part, int P,
                                                int L, int o, int o2, int g, int gl) {
  float s = 0.f, s2 = 0.f;
  int p = gl;
  for (; p + 7 * g < P; p += 8 * g) {
    float t[8], t2[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      t[u] = __ldcg(part + (size_t)(p + u * g) * L + o);
      t2[u] = __ldcg(part + (size_t)(p + u * g) * L + o2);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      s += t[u];
      s2 += t2[u];
    }
  }
  for (; p < P; p += g) {
    s += __ldcg(part + (size_t)p * L + o);
    s2 += __ldcg(part + (size_t)p * L + o2);
  }
  for (int off = g >> 1; off > 0; off >>= 1) {
    s += __shfl_xor_sync(kFull, s, off);
    s2 += __shfl_xor_sync(kFull, s2, off);
  }
  return make_float2(s, s2);
}

// The final reduce of one group of P partials (part: P x L floats,
// L = C*d + C + 1: v_num, w_i, q), without a second launch.  Each of the
// group's A CTAs calls it after writing its share of a partial (A == P:
// one partial per CTA; the wide kernel's clusters write one partial
// between A / P CTAs).  The integer ticket (tickets[0]) counts arrivals;
// the last S arrivals each sum one slice of the L outputs, after waiting
// until all A arrivals are in (S == 1: the last arrival finds them in).  A
// waiting CTA holds an SM slot only after at least A - S of the group have
// finished, so the remaining ones always find room: S is kept far below
// the card's resident CTAs.  tickets[1] counts finished slices, and the
// last one resets both to 0 for the next launch on the stream.
// blockDim.x must be a multiple of 32.
__device__ void finish_partials(const float* __restrict__ part, int* tickets, int P,
                                int L, int S, int d, int c, int normalize,
                                float* __restrict__ out_v, float* __restrict__ out_w,
                                float* __restrict__ out_q, int A) {
  __shared__ int s_ticket;
  // The barrier orders the CTA's partial writes before thread 0's fence,
  // which makes them visible device-wide before its ticket (cumulativity).
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_ticket = atomicAdd(tickets, 1);
  }
  __syncthreads();
  const int t = s_ticket;
  if (t < A - S) return;
  if (threadIdx.x == 0 && S > 1) {
    volatile int* vt = tickets;
    while (*vt < A) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
  const int cd = c * d;
  const int per = (L + S - 1) / S;
  const int slice = t - (A - S);
  const int o0 = slice * per;
  const int o1 = min(L, o0 + per);
  int g = 32;  // lanes per output: a function of (blockDim, per) alone
  while (g > 1 && g * per > (int)blockDim.x) g >>= 1;
  const int gl = threadIdx.x % g;
  const int groups = blockDim.x / g;
  for (int base = o0; base < o1; base += groups) {
    const int o = base + threadIdx.x / g;
    const int oc = min(o, L - 1);
    float s;
    if (normalize) {
      // w_i summed as its own output is, so the divisor equals it bit for bit.
      const float2 sw = sum_partials2(part, P, L, oc, oc < cd ? cd + oc / d : oc, g, gl);
      s = oc < cd ? sw.x / fmaxf(sw.y, kD2Floor) : sw.x;
    } else {
      s = sum_partials(part, P, L, oc, g, gl);
    }
    if (o < o1 && gl == 0) {
      if (o < cd) out_v[o] = s;
      else if (o < cd + c) out_w[o - cd] = s;
      else *out_q = s;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(tickets + 1, 1) == S - 1) {
      atomicExch(tickets, 0);
      atomicExch(tickets + 1, 0);
    }
  }
}

__device__ __forceinline__ void finish_partials(const float* __restrict__ part,
                                                int* tickets, int P, int L, int S, int d,
                                                int c, int normalize,
                                                float* __restrict__ out_v,
                                                float* __restrict__ out_w,
                                                float* __restrict__ out_q) {
  finish_partials(part, tickets, P, L, S, d, c, normalize, out_v, out_w, out_q, P);
}

}  // namespace fcm

// K3: the Mamba1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scan_kernel` (public `mamba_scan`) in
// src/repro/kernels/mamba_scan.py. For every batch row b, channel d and
// state n it runs the fp32 recurrence over the whole sequence
//
//   h_t = exp(dt_t * A[d, n]) * h_{t-1} + (dt_t * x_t) * B_t[n]
//   y_t = sum_n h_t[n] * C_t[n]
//
// from h_{-1} = h0 (zeros when absent) and writes y (B, S, dI) fp32 and the
// final state hT (B, dI, N) fp32; D * x is added by the caller, as on the
// TPU. dt and A are fp32; x, B and C come in bf16 or fp32 (one template per
// type) and are widened on load.
//
// What bounds it on the H100: at falcon-mamba's prefill shape (B = 1,
// S = 300, dI = 8192, N = 16) the bytes are ~25.6 MB (dt and y in fp32,
// x in bf16, A and hT), 7.6 us at 3.35 TB/s, and the work is B*S*dI*N =
// 39.3 M exponentials, 9.4 us at the SFU's 16 results per clock per SM.
// Neither is what a simple kernel meets: each (b, d, n) element is a chain
// of S dependent steps, and at B = 1 there are only dI * N = 131,072 of
// them, so its time is the latency of one chain (S steps of exp, FMA and a
// 4-level shuffle reduction) times the warps that share an SM's issue
// slots.
//
// Design: the TPU grid (B, dI / block_d, S / chunk) walked the sequence
// axis in order with a (block_d, N) state resident in VMEM. Here one thread
// owns one (d, n) state element and keeps h in a register for the whole
// sequence: a block of 256 threads holds 16 channels x 16 states (N <= 16)
// or 8 channels x 32 states (16 < N <= 32); the grid is (ceil(dI / 16 or
// 8), B). The block walks the sequence in chunks of 64 steps: it stages the
// chunk's dt, x (its channels), B and C (all N) into shared memory with
// coalesced loads, runs the chunk's steps out of shared memory, reduces
// <h_t, C_t> over n with __shfl_xor_sync inside each 16- or 32-lane group,
// stages y in shared memory and writes it back row by row. Ragged S
// (a short last chunk) and ragged dI (masked channels, whose h stays 0) are
// handled in the kernel, where the TPU kernel asserted dI % block_d == 0 and
// S % chunk == 0. exp is expf, not __expf, to stay close to the plain
// version. Shared memory is at most 23 KB of static arrays.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kChunk = 64;     // time steps staged in shared memory at once

// NL: lanes per channel (16 or 32), N <= NL; CH = kThreads / NL channels.
template <typename T, int NL>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ dt, const T* __restrict__ x,
                      const T* __restrict__ Bc, const T* __restrict__ Cc,
                      const float* __restrict__ A,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int S, int dI, int N) {
  constexpr int CH = kThreads / NL;
  __shared__ float s_dt[kChunk][CH];
  __shared__ float s_x[kChunk][CH];
  __shared__ float s_b[kChunk][NL];
  __shared__ float s_c[kChunk][NL];
  __shared__ float s_y[kChunk][CH];

  const int tid = threadIdx.x;
  const int c = tid / NL;          // channel within the block
  const int n = tid % NL;          // state index
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool live = d < dI && n < N;
  const size_t row0 = (size_t)b * S;   // row b's first time step

  // a masked element has A = 0 and sees dt = x = B = 0: h stays 0
  const float a_dn = live ? A[(size_t)d * N + n] : 0.f;
  float h = (live && h0 != nullptr) ? h0[((size_t)b * dI + d) * N + n] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int tn = min(kChunk, S - t0);
    // dt and x of this block's channels: consecutive threads read
    // consecutive channels of one time step
    for (int i = tid; i < kChunk * CH; i += kThreads) {
      const int t = i / CH;
      const int cc = i % CH;
      const int dd = d0 + cc;
      float vdt = 0.f, vx = 0.f;
      if (t < tn && dd < dI) {
        const size_t off = (row0 + t0 + t) * dI + dd;
        vdt = dt[off];
        vx = to_f32(x[off]);
      }
      s_dt[t][cc] = vdt;
      s_x[t][cc] = vx;
    }
    for (int i = tid; i < kChunk * NL; i += kThreads) {
      const int t = i / NL;
      const int nn = i % NL;
      float vb = 0.f, vc = 0.f;
      if (t < tn && nn < N) {
        const size_t off = (row0 + t0 + t) * N + nn;
        vb = to_f32(Bc[off]);
        vc = to_f32(Cc[off]);
      }
      s_b[t][nn] = vb;
      s_c[t][nn] = vc;
    }
    __syncthreads();
    // tn is the same for every thread, so every lane reaches each shuffle
    for (int t = 0; t < tn; ++t) {
      const float dtv = s_dt[t][c];
      const float a = expf(dtv * a_dn);
      const float dx = dtv * s_x[t][c];
      h = fmaf(a, h, dx * s_b[t][n]);
      float p = h * s_c[t][n];
#pragma unroll
      for (int o = NL / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (n == 0) s_y[t][c] = p;
    }
    __syncthreads();
    for (int i = tid; i < tn * CH; i += kThreads) {
      const int t = i / CH;
      const int cc = i % CH;
      const int dd = d0 + cc;
      if (dd < dI) y[(row0 + t0 + t) * dI + dd] = s_y[t][cc];
    }
    // the next chunk's staging writes s_dt..s_c only; s_y is rewritten
    // after that chunk's first barrier, which orders it after these reads
  }
  if (live) hT[((size_t)b * dI + d) * N + n] = h;
}

template <typename T>
cudaError_t launch(const void* dt, const void* x, const void* Bc,
                   const void* Cc, const void* A, const void* h0, void* y,
                   void* hT, int B, int S, int dI, int N,
                   cudaStream_t stream) {
  const float* dtp = static_cast<const float*>(dt);
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(Bc);
  const T* cp = static_cast<const T*>(Cc);
  const float* ap = static_cast<const float*>(A);
  const float* hp = static_cast<const float*>(h0);
  float* yp = static_cast<float*>(y);
  float* tp = static_cast<float*>(hT);
  if (N <= 16) {
    constexpr int CH = kThreads / 16;
    const dim3 grid((dI + CH - 1) / CH, B);
    mamba_scan_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
        dtp, xp, bp, cp, ap, hp, yp, tp, S, dI, N);
  } else {
    constexpr int CH = kThreads / 32;
    const dim3 grid((dI + CH - 1) / CH, B);
    mamba_scan_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
        dtp, xp, bp, cp, ap, hp, yp, tp, S, dI, N);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes (kernels/mamba_scan.py). dtype is the
// type of x, B and C (dt, A, h0, y and hT are fp32); h0 may be null (zero
// initial state). Returns the launch's cudaError_t (0 on success); the
// wrapper raises on anything else.
extern "C" int repro_mamba_scan(int dtype, const void* dt, const void* x,
                                const void* Bc, const void* Cc,
                                const void* A, const void* h0, void* y,
                                void* hT, int B, int S, int dI, int N,
                                void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || dI <= 0 || N <= 0 || N > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro_torch::kBFloat16)
    return (int)launch<__nv_bfloat16>(dt, x, Bc, Cc, A, h0, y, hT, B, S, dI,
                                      N, s);
  if (dtype == repro_torch::kFloat32)
    return (int)launch<float>(dt, x, Bc, Cc, A, h0, y, hT, B, S, dI, N, s);
  return (int)cudaErrorInvalidValue;
}

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
// type) and are widened when staged.
//
// What bounds it on the H100: at falcon-mamba's prefill shape (B = 1,
// S = 300, dI = 8192, N = 16) the bytes are ~25.6 MB (dt and y in fp32,
// x in bf16, A and hT), 7.6 us at 3.35 TB/s, and the work is B*S*dI*N =
// 39.3 M exponentials, 9.4 us at the SFU's 16 results per clock per SM.
// A kernel meets neither first: each (b, d, n) element is a chain of S
// dependent steps, and every element-step costs an `expf` (9 instructions
// with its argument, one of them on the SFU) and a few FMAs. A first
// design with one state per thread spent ~35-40 warp instructions per
// element-step (a 4-level shuffle sum over n, four shared loads and dt * x
// recomputed by every lane of a channel) and stored each y from a branch.
//
// Design: the TPU grid (B, dI / block_d, S / chunk) walked the sequence
// axis in order with a (block_d, N) state resident in VMEM. Here each
// thread owns kStates = 4 states of one channel and keeps them in
// registers for the whole sequence: 4 lanes cover N <= 16 (8 lanes
// N <= 32), so a block of 256 threads serves 64 (or 32) channels and the
// grid is (ceil(dI / 64 or 32), B). The steps go in groups of 16: a thread
// first forms the group's 64 factors exp(dt * A) and (dt * x) * B, all
// independent of h, from one 8-byte load of (dt, dt * x) and a 16-byte
// load of B per step; then it runs its four chains (one FMA a step) and
// sums its four products with C (a 16-byte load) in registers. The sum
// over the channel's lanes is done once per group and transposed: at each
// halving of the lane distance a lane keeps half of its 16 partial sums
// and swaps the other half with its partner (12 shuffles per 16 steps
// instead of 32), after which every lane holds 4 finished y values and
// stores them; no store sits in a branch. That is ~14 warp instructions
// per element-step, 9 of them the `expf`. The sequence goes by in chunks
// of 32 steps through a 2-stage ring in shared memory: while a chunk's
// steps run, the next chunk's dt, x, B and C are in flight into registers
// (16-byte global loads); after the steps they are widened to fp32, dt * x
// is formed once per channel, and they land in the other stage; one
// barrier per chunk. A chunk's ragged tail is padded with dt = x = B = C =
// 0 steps, which leave h exactly as it is (exp(0) = 1, 1 * h + 0 = h) and
// store no y. Ragged dI (masked channels, whose h stays 0) and N < 16
// (masked states: A = B = C = 0) are handled in the kernel, where the TPU
// kernel asserted dI % block_d == 0 and S % chunk == 0. exp is expf, not
// __expf, to stay close to the plain version. Shared memory is at most
// 40 KB, static.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStates = 4;     // states of one channel per thread
constexpr int kChunk = 32;     // time steps per stage of the ring
constexpr int kGroup = 16;     // steps unrolled together
static_assert(kChunk % kGroup == 0, "a group never crosses a chunk");

// raw bits of one value of x, B or C, widened to fp32 only when staged so
// that the load stays in flight across a chunk's steps
__device__ __forceinline__ unsigned ld_bits(const float* p) {
  return __float_as_uint(__ldg(p));
}
__device__ __forceinline__ unsigned ld_bits(const __nv_bfloat16* p) {
  return (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p));
}
template <typename T>
__device__ __forceinline__ float bits_f32(unsigned u) {
  return sizeof(T) == 4 ? __uint_as_float(u) : __uint_as_float(u << 16);
}

// 8 consecutive values at p as raw 16-byte words (W = 2 for fp32, 1 for
// bf16); values at or past n (0 <= n <= 8) are zeros and not read. One
// load per word when `vec` (p 16-byte aligned and n == 8).
template <typename T, int W>
__device__ __forceinline__ void load8(const T* p, int n, bool vec,
                                      uint4 (&r)[W]) {
  if (vec && n == 8) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      r[w] = __ldg(reinterpret_cast<const uint4*>(p) + w);
    return;
  }
  unsigned e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = i < n ? ld_bits(p + i) : 0u;
  if (W == 2) {
    r[0] = make_uint4(e[0], e[1], e[2], e[3]);
    r[W - 1] = make_uint4(e[4], e[5], e[6], e[7]);
  } else {
    r[0] = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                      e[4] | (e[5] << 16), e[6] | (e[7] << 16));
  }
}

template <typename T, int W>
__device__ __forceinline__ void unpack8(const uint4 (&r)[W], float (&f)[8]) {
  if (W == 2) {
    const uint4 a = r[0], b = r[W - 1];
    const unsigned u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __uint_as_float(u[i]);
  } else {
    const unsigned u[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// a thread's kStates consecutive floats of shared memory, 16 (or 8) bytes
// at a time
__device__ __forceinline__ void lds_states(const float* p,
                                           float (&v)[kStates]) {
  if (kStates % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kStates; k += 4) {
      const float4 w = *reinterpret_cast<const float4*>(p + k);
      v[k] = w.x;
      v[(k + 1) % kStates] = w.y;
      v[(k + 2) % kStates] = w.z;
      v[(k + 3) % kStates] = w.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kStates; k += 2) {
      const float2 w = *reinterpret_cast<const float2*>(p + k);
      v[k] = w.x;
      v[(k + 1) % kStates] = w.y;
    }
  }
}

// Sum each of a lane's kGroup values over the NL lanes of its channel and
// spread the results over those lanes: at every halving of the lane
// distance a lane keeps one half of its values, sends the other half to its
// partner and adds what it gets back (log2(NL) rounds, kGroup - kGroup / NL
// shuffles in all instead of kGroup * log2(NL)). Afterwards lane r holds
// the sums of values r * kGroup / NL + i, i < kGroup / NL, in v[i].
template <int W, int NV>
__device__ __forceinline__ void sum_round(float (&v)[kGroup], int r) {
  if constexpr (W > 0) {
    constexpr int n = NV / 2;          // values kept this round
    const bool hi = (r & W) != 0;      // W: the partner's lane distance
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = hi ? v[i] : v[i + n];
      const float keep = hi ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
    }
    sum_round<W / 2, n>(v, r);
  }
}

template <int NL>
__device__ __forceinline__ void sum_lanes(float (&v)[kGroup], int r) {
  sum_round<NL / 2, kGroup>(v, r);
}

// NL: lanes per channel (N <= NL * kStates); CH = kThreads / NL channels.
template <typename T, int NL>
__global__ void __launch_bounds__(kThreads, 1)
    mamba_scan_kernel(const float* __restrict__ dt, const T* __restrict__ x,
                      const T* __restrict__ Bc, const T* __restrict__ Cc,
                      const float* __restrict__ A,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int S, int dI, int N,
                      bool vec) {
  constexpr int CH = kThreads / NL;          // channels per block
  constexpr int NP = NL * kStates;           // states, padded
  constexpr int XW = sizeof(T) == 4 ? 2 : 1; // 16-byte words of 8 x values
  constexpr int ROWS = kChunk * CH / 8;      // 8-channel rows of a chunk
  constexpr int NBC = kChunk * NP / kThreads;  // B (and C) values per thread
  static_assert(ROWS <= kThreads && NBC * kThreads == kChunk * NP, "");
  static_assert(kGroup % NL == 0, "every lane stores part of a group's y");
  __shared__ __align__(16) float2 s_dx[2][kChunk][CH];   // (dt, dt * x)
  __shared__ __align__(16) float s_b[2][kChunk][NP];
  __shared__ __align__(16) float s_c[2][kChunk][NP];

  constexpr int kPer = kGroup / NL;          // y values a lane stores per group
  const int tid = threadIdx.x;
  const int c = tid / NL;          // channel within the block
  const int r = tid % NL;          // lane within the channel's group
  const int n0 = r * kStates;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const size_t row0 = (size_t)b * S;   // row b's first time step

  // a masked element has A = 0 and sees dt = x = B = 0: h stays 0
  float a_n[kStates], h[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const bool live = d < dI && n0 + k < N;
    a_n[k] = live ? A[(size_t)d * N + n0 + k] : 0.f;
    h[k] = (live && h0 != nullptr) ? h0[((size_t)b * dI + d) * N + n0 + k]
                                   : 0.f;
  }

  // this thread's share of a chunk's staging: one 8-channel row of dt and
  // x (step tr, channels d0 + cr .. + 7) and NBC values of B and of C
  const int tr = tid / (CH / 8);
  const int cr = (tid % (CH / 8)) * 8;
  uint4 dt_r[2], x_r[XW];
  unsigned b_r[NBC], c_r[NBC];
  auto load = [&](int t0) {
    const int t = t0 + tr;
    const int n = (tid < ROWS && t < S) ? min(max(dI - d0 - cr, 0), 8) : 0;
    const size_t off = (row0 + t) * dI + d0 + cr;
    load8<float, 2>(dt + off, n, vec, dt_r);
    load8<T, XW>(x + off, n, vec, x_r);
#pragma unroll
    for (int k = 0; k < NBC; ++k) {
      const int i = tid + k * kThreads;
      const int tt = t0 + i / NP;
      const int nn = i % NP;
      const bool ok = tt < S && nn < N;
      const size_t o = (row0 + tt) * N + nn;
      b_r[k] = ok ? ld_bits(Bc + o) : 0u;
      c_r[k] = ok ? ld_bits(Cc + o) : 0u;
    }
  };
  auto stage = [&](int st) {
    if (tid < ROWS) {
      float vdt[8], vx[8];
      unpack8<float, 2>(dt_r, vdt);
      unpack8<T, XW>(x_r, vx);
      float4* dst = reinterpret_cast<float4*>(&s_dx[st][tr][cr]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[i] = make_float4(vdt[2 * i], vdt[2 * i] * vx[2 * i],
                             vdt[2 * i + 1], vdt[2 * i + 1] * vx[2 * i + 1]);
    }
#pragma unroll
    for (int k = 0; k < NBC; ++k) {
      const int i = tid + k * kThreads;
      s_b[st][i / NP][i % NP] = bits_f32<T>(b_r[k]);
      s_c[st][i / NP][i % NP] = bits_f32<T>(c_r[k]);
    }
  };

  load(0);
  stage(0);
  __syncthreads();
  for (int t0 = 0, st = 0; t0 < S; t0 += kChunk, st ^= 1) {
    const bool more = t0 + kChunk < S;
    if (more) load(t0 + kChunk);   // in flight during this chunk's steps
    const int tn = min(kChunk, S - t0);
    // tn is the same for every thread, so every lane reaches each shuffle
    for (int g = 0; g < tn; g += kGroup) {
      // first the group's factors, which do not depend on h: kGroup x
      // kStates independent exponentials in flight at once
      float ea[kGroup][kStates], bx[kGroup][kStates];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float2 v = s_dx[st][g + u][c];
        float bb[kStates];
        lds_states(&s_b[st][g + u][n0], bb);
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          ea[u][k] = expf(v.x * a_n[k]);
          bx[u][k] = v.y * bb[k];
        }
      }
      // then the chains, one FMA a step, and this lane's part of each y
      float p[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        float cc[kStates];
        lds_states(&s_c[st][g + u][n0], cc);
        p[u] = 0.f;
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          h[k] = fmaf(ea[u][k], h[k], bx[u][k]);
          p[u] = fmaf(h[k], cc[k], p[u]);
        }
      }
      sum_lanes<NL>(p, r);
      // lane r now holds y at steps g + r * kPer + i, i < kPer
      float* yp = y + (row0 + t0 + g + r * kPer) * dI + d;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (g + r * kPer + i < tn && d < dI) yp[(size_t)i * dI] = p[i];
    }
    if (more) stage(st ^ 1);
    // the staged chunk is visible, and this chunk's stage is free to
    // refill, once everyone is past this barrier
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kStates; ++k)
    if (d < dI && n0 + k < N) hT[((size_t)b * dI + d) * N + n0 + k] = h[k];
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
  // 16-byte loads of dt and x rows: both aligned, and every 8-channel row
  // starts on a 16-byte boundary
  const bool vec = dI % 8 == 0 && ((reinterpret_cast<uintptr_t>(dt) |
                                    reinterpret_cast<uintptr_t>(x)) & 15) == 0;
  if (N <= 16) {
    constexpr int NL = 16 / kStates;
    const dim3 grid((dI + kThreads / NL - 1) / (kThreads / NL), B);
    mamba_scan_kernel<T, NL><<<grid, kThreads, 0, stream>>>(
        dtp, xp, bp, cp, ap, hp, yp, tp, S, dI, N, vec);
  } else {
    constexpr int NL = 32 / kStates;
    const dim3 grid((dI + kThreads / NL - 1) / (kThreads / NL), B);
    mamba_scan_kernel<T, NL><<<grid, kThreads, 0, stream>>>(
        dtp, xp, bp, cp, ap, hp, yp, tp, S, dI, N, vec);
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

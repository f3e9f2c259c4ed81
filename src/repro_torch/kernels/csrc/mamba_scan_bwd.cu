// The backward of K3 (the Mamba1 selective scan) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains Mamba1 through `_m1_scan`
// (src/repro/models/mamba.py), an associative scan that XLA differentiates,
// and its Pallas `_scan_kernel` has no backward. This kernel is the
// gradient of K3 (csrc/mamba_scan.cu), so that training keeps the forward
// on K3. With a_t = exp(dt_t A), b_t = dt_t x_t B_t, h_t = a_t h_{t-1} + b_t
// and y_t = <h_t, C_t>, the state's gradient runs backwards in time,
//
//   g_t = C_t dy_t + a_{t+1} g_{t+1}        (g_{S-1} = C dy + dhT)
//
// and for every batch row b, time step t, channel d and state n
//
//   d(dt)_t[d] = x_t sum_n g_t B_t + sum_n g_t h_{t-1} a_t A[d, n]
//   dx_t[d]    = dt_t sum_n g_t B_t
//   dB_t[n]    = sum_d g_t dt_t x_t          dC_t[n] = sum_d h_t dy_t
//   dA[d, n]   = sum_b sum_t g_t h_{t-1} a_t dt_t
//
// The states h_t are not kept: K3's training entry point writes the state
// before every 32-step chunk (hs, B x ceil(S / 32) x dI x N fp32, 33.5 MB a
// layer at falcon-mamba's training shape B = 1, S = 2048, dI = 8192,
// N = 16), and this kernel walks the chunks in reverse, recomputes a
// chunk's 32 states from its saved one with K3's own arithmetic (the same
// bits), then runs the chunk's steps backwards.
//
// What bounds it on the H100: the bytes are ~0.30 GB at that shape (dt,
// dy and d(dt) in fp32; x and dx in x's type, bf16 in training; hs),
// 0.09 ms at 3.35 TB/s; the 268 M exponentials it needs take 0.064 ms on
// the SFUs. The gradients of x, B and C are written in their inputs' type
// (the sums behind them stay fp32 and are rounded once). A simple design
// first: each thread owns 4 states of one channel, as in K3 (4 lanes a
// channel, N <= 16, 64 channels a block, grid (ceil(dI / 64), B)), holds
// its chunk's 33 states in registers (236 of them: one block of 8 warps
// an SM) and recomputes exp(dt A) in the reverse pass (two exponentials
// per element-step where one would do). At the start of each chunk the
// block copies the chunk's dt, x, dy (64 channels x 32 steps, one
// coalesced row a step) and B, C into shared memory, widened to fp32; the
// steps then read only shared memory (a first version read every step's
// inputs from global memory and waited on each: 3.87 ms at that shape on
// an H100).
//
// The sums, and their order (fixed: the same bits from run to run):
// * over n (d(dt), dx): a butterfly over the channel's 4 lanes;
// * over d (dB, dC): per step, a halving tree over the 8 channels of a warp
//   (at each halving a lane keeps half of its values and swaps the other
//   half, so 7 shuffles leave every lane one finished sum), then the 8
//   warps in order through shared memory, into a per-block partial; a
//   second kernel sums the blocks' partials in block order;
// * over b and t (dA): t in order in registers, a per-row partial, rows
//   summed in order by the second kernel.
// Ragged S is padded inside the last chunk with dt = x = B = C = dy = 0
// steps (a = 1, b = 0: g and h pass through unchanged, nothing is stored);
// ragged dI and N < 16 are masked (A = B = C = 0 there: every sum gets 0).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStates = 4;                 // states of one channel a thread
constexpr int kLanes = 4;                  // lanes a channel: N <= 16
constexpr int kMaxN = kLanes * kStates;
constexpr int kCh = kThreads / kLanes;     // channels a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // K3's chunk: steps between saved states
constexpr int kPart = 2 * kMaxN;           // (dB, dC) x n of one step

template <typename T>
__device__ __forceinline__ float ld(const T* p) {
  return repro_torch::to_f32<T>(*p);
}

// v[i], i < 8, summed over the warp's 8 channels (lanes l ^ 4, l ^ 8,
// l ^ 16): lane l ends with the sum of v[l >> 2].
__device__ __forceinline__ float sum_channels(float (&v)[8], int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool hi = (lane & 16) != 0;
    const float send = hi ? v[i] : v[i + 4];
    const float keep = hi ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool hi = (lane & 8) != 0;
    const float send = hi ? v[i] : v[i + 2];
    const float keep = hi ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const bool hi = (lane & 4) != 0;
  return (hi ? v[1] : v[0]) +
         __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[1], 4);
}

// dynamic shared memory (60 KB): the chunk's inputs, then the per-step
// sums of each warp
struct Smem {
  float dt[kChunk][kCh];
  float x[kChunk][kCh];
  float dy[kChunk][kCh];
  float b[kChunk][kMaxN];
  float c[kChunk][kMaxN];
  float part[kWarps][kChunk][32];
};

// part: (gridDim.x, B, S, kPart) per-block sums over the block's channels
// of dB (n) and dC (kMaxN + n) per step; dA_part: (B, dI, N), row b's sum
// over t.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mamba_scan_bwd_kernel(const float* __restrict__ dt,
                          const T* __restrict__ x, const T* __restrict__ Bc,
                          const T* __restrict__ Cc,
                          const float* __restrict__ A,
                          const float* __restrict__ hs,
                          const float* __restrict__ dy,
                          const float* __restrict__ dhT,
                          float* __restrict__ ddt, T* __restrict__ dx,
                          float* __restrict__ part,
                          float* __restrict__ dA_part, int S, int dI, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = tid % kLanes;       // lane within the channel
  const int n0 = r * kStates;
  const int b = blockIdx.y;
  const int c = tid / kLanes;       // channel within the block
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + c;
  const bool dlive = d < dI;
  const int B = gridDim.y;
  const int nch = (S + kChunk - 1) / kChunk;
  const size_t row0 = (size_t)b * S;

  float a_n[kStates], g[kStates], da[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const bool live = dlive && n0 + k < N;
    a_n[k] = live ? A[(size_t)d * N + n0 + k] : 0.f;
    g[k] = (live && dhT != nullptr) ? dhT[((size_t)b * dI + d) * N + n0 + k]
                                    : 0.f;
    da[k] = 0.f;
  }

  for (int ch = nch - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk;
    const int tn = min(kChunk, S - t0);
    // the chunk's inputs into shared memory (zeros past S, dI and N)
    for (int i = tid; i < kChunk * kCh; i += kThreads) {
      const int u = i / kCh, cc = i % kCh;
      const bool ok = u < tn && d0 + cc < dI;
      const size_t o = (row0 + t0 + u) * dI + d0 + cc;
      sm.dt[u][cc] = ok ? dt[o] : 0.f;
      sm.x[u][cc] = ok ? ld(x + o) : 0.f;
      sm.dy[u][cc] = ok ? dy[o] : 0.f;
    }
    for (int i = tid; i < kChunk * kMaxN; i += kThreads) {
      const int u = i / kMaxN, n = i % kMaxN;
      const bool ok = u < tn && n < N;
      const size_t o = (row0 + t0 + u) * N + n;
      sm.b[u][n] = ok ? ld(Bc + o) : 0.f;
      sm.c[u][n] = ok ? ld(Cc + o) : 0.f;
    }
    // hc[0]: the saved state before the chunk; hc[u + 1]: after step u
    float hc[kChunk + 1][kStates];
    const float* hp = hs + (((size_t)b * nch + ch) * dI + d) * N + n0;
#pragma unroll
    for (int k = 0; k < kStates; ++k)
      hc[0][k] = (dlive && n0 + k < N) ? hp[k] : 0.f;
    __syncthreads();   // the chunk's inputs are staged
    // the chunk's states again, with K3's arithmetic
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float vdt = sm.dt[u][c], vx = sm.x[u][c];
      const float4 bq = *reinterpret_cast<const float4*>(&sm.b[u][n0]);
      const float bb[kStates] = {bq.x, bq.y, bq.z, bq.w};
      const float dxv = vdt * vx;
#pragma unroll
      for (int k = 0; k < kStates; ++k)
        hc[u + 1][k] = fmaf(expf(vdt * a_n[k]), hc[u][k], dxv * bb[k]);
    }
    // the chunk's steps backwards; g holds a_{t+1} g_{t+1} on entry
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      const size_t t = row0 + t0 + u;
      const float vdt = sm.dt[u][c], vx = sm.x[u][c], vdy = sm.dy[u][c];
      const float4 bq = *reinterpret_cast<const float4*>(&sm.b[u][n0]);
      const float4 cq = *reinterpret_cast<const float4*>(&sm.c[u][n0]);
      const float bb[kStates] = {bq.x, bq.y, bq.z, bq.w};
      const float cc[kStates] = {cq.x, cq.y, cq.z, cq.w};
      const float dxv = vdt * vx;
      float s1 = 0.f, s2 = 0.f, v[8];
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        const float a = expf(vdt * a_n[k]);
        g[k] = fmaf(cc[k], vdy, g[k]);              // g_t
        const float w = g[k] * hc[u][k] * a;        // dL/da_t * a_t
        s1 = fmaf(g[k], bb[k], s1);
        s2 = fmaf(w, a_n[k], s2);
        da[k] = fmaf(w, vdt, da[k]);
        v[k] = g[k] * dxv;                          // dB_t, this channel
        v[kStates + k] = hc[u + 1][k] * vdy;        // dC_t, this channel
        g[k] *= a;                                  // a_t g_t, for t - 1
      }
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
      if (r == 0 && u < tn && dlive) {
        ddt[t * dI + d] = fmaf(vx, s1, s2);
        dx[t * dI + d] = repro_torch::from_f32<T>(vdt * s1);
      }
      sm.part[warp][u][lane] = sum_channels(v, lane);
    }
    __syncthreads();
    // the block's sum over its 8 warps, warp by warp: lane l of a warp
    // holds value l >> 2 of states 4 (l & 3) .. + 3, i.e. dB (l >> 2 < 4)
    // or dC of state 4 (l & 3) + (l >> 2) % 4
    for (int i = tid; i < kChunk * 32; i += kThreads) {
      const int u = i / 32, l = i % 32;
      if (u < tn) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += sm.part[w][u][l];
        const int ci = l >> 2;
        const int n = (l & 3) * kStates + (ci & 3);
        part[(((size_t)blockIdx.x * B + b) * S + t0 + u) * kPart +
             (ci >> 2) * kMaxN + n] = sum;
      }
    }
    __syncthreads();   // the stage and the sums are free for the next chunk
  }
#pragma unroll
  for (int k = 0; k < kStates; ++k)
    if (dlive && n0 + k < N)
      dA_part[((size_t)b * dI + d) * N + n0 + k] = da[k];
}

// The fixed-order sums: dB, dC (B, S, N) over the nblk blocks' partials in
// block order, rounded once to T; dA (dI, N) over the B rows in row order.
template <typename T>
__global__ void __launch_bounds__(256)
    mamba_scan_bwd_sum_kernel(const float* __restrict__ part,
                              const float* __restrict__ dA_part,
                              T* __restrict__ dB, T* __restrict__ dC,
                              float* __restrict__ dA, int nblk, int B, int S,
                              int dI, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nbc = (size_t)B * S * kPart;
  if (i < nbc) {
    const int n = (int)(i % kMaxN);
    const int kind = (int)(i / kMaxN % 2);
    const size_t bt = i / kPart;
    if (n >= N) return;
    float sum = 0.f;
    for (int k = 0; k < nblk; ++k) sum += part[(size_t)k * nbc + i];
    (kind == 0 ? dB : dC)[bt * N + n] = repro_torch::from_f32<T>(sum);
    return;
  }
  const size_t j = i - nbc;
  if (j >= (size_t)dI * N) return;
  float sum = 0.f;
  for (int b = 0; b < B; ++b) sum += dA_part[(size_t)b * dI * N + j];
  dA[j] = sum;
}

template <typename T>
cudaError_t launch(const void* dt, const void* x, const void* Bc,
                   const void* Cc, const void* A, const void* hs,
                   const void* dy, const void* dhT, void* ddt, void* dx,
                   void* dB, void* dC, void* dA, void* part, void* dA_part,
                   int B, int S, int dI, int N, cudaStream_t stream) {
  const int nblk = (dI + kCh - 1) / kCh;
  mamba_scan_bwd_kernel<T><<<dim3(nblk, B), kThreads, sizeof(Smem),
                             stream>>>(
      static_cast<const float*>(dt), static_cast<const T*>(x),
      static_cast<const T*>(Bc), static_cast<const T*>(Cc),
      static_cast<const float*>(A), static_cast<const float*>(hs),
      static_cast<const float*>(dy), static_cast<const float*>(dhT),
      static_cast<float*>(ddt), static_cast<T*>(dx),
      static_cast<float*>(part), static_cast<float*>(dA_part), S, dI, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)B * S * kPart + (size_t)dI * N;
  mamba_scan_bwd_sum_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0,
                                 stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(dA_part),
      static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), nblk, B, S, dI, N);
  return cudaGetLastError();
}

}  // namespace

// Opt the reverse scan in to its 60 KB of dynamic shared memory; run once
// per device by kernels/_build.py before any launch.
extern "C" int repro_mamba_scan_bwd_init() {
  cudaError_t err = repro_torch::allow_smem(
      mamba_scan_bwd_kernel<float>, sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  return (int)repro_torch::allow_smem(mamba_scan_bwd_kernel<__nv_bfloat16>,
                                      sizeof(Smem));
}

// C entry point bound with ctypes (kernels/mamba_scan_bwd.py). dtype is the
// type of x, B and C and of their gradients dx, dB and dC; dt, A, hs (the
// states before each 32-step chunk, from repro_mamba_scan_states), dy, dhT,
// d(dt) and dA are fp32; dhT may be null (no gradient on the final state). part (ceil(dI / 64), B, S, 32) and
// dA_part (B, dI, N) are scratch. Two launches: the reverse scan, then the
// fixed-order sums into dB, dC (B, S, N) and dA (dI, N). Returns the
// launches' cudaError_t (0 on success); the wrapper raises on anything else.
extern "C" int repro_mamba_scan_bwd(int dtype, const void* dt, const void* x,
                                    const void* Bc, const void* Cc,
                                    const void* A, const void* hs,
                                    const void* dy, const void* dhT,
                                    void* ddt, void* dx, void* dB, void* dC,
                                    void* dA, void* part, void* dA_part,
                                    int B, int S, int dI, int N,
                                    void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || dI <= 0 || N <= 0 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro_torch::kBFloat16)
    return (int)launch<__nv_bfloat16>(dt, x, Bc, Cc, A, hs, dy, dhT, ddt, dx,
                                      dB, dC, dA, part, dA_part, B, S, dI, N,
                                      s);
  if (dtype == repro_torch::kFloat32)
    return (int)launch<float>(dt, x, Bc, Cc, A, hs, dy, dhT, ddt, dx, dB, dC,
                              dA, part, dA_part, B, S, dI, N, s);
  return (int)cudaErrorInvalidValue;
}

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
// N = 16), and this kernel recomputes a chunk's 32 states from its saved
// one with K3's own arithmetic (expf, then fmaf(a, h, (dt x) B): the same
// bits as K3's states), then runs the chunk's steps backwards.
//
// What bounds it on the H100: the bytes are ~0.30 GB at that shape (dt,
// dy and d(dt) in fp32; x and dx in x's type, bf16 in training; hs),
// 0.09 ms at 3.35 TB/s; the 268 M exponentials take 0.064 ms on the SFUs.
// Neither is reached first. Every element-step costs the recompute (an
// `expf` of 8 instructions, its argument, (dt x) B and the FMA: 11, as in
// K3) and the reverse step (8), so the work is ~1.6 times K3's forward
// (0.18 ms at that shape) before any sum across lanes; and each step moves
// its exponentials (16 bytes a thread, written and read back), its B and C,
// and the d-sum tile below through shared memory, whose bandwidth the
// reverse steps share with their instruction issue.
//
// The design (the previous design recomputed every exponential in the
// reverse step, held its chunk's 33 states in 236 registers, staged each
// chunk with plain loads between barriers and summed dB and dC across its
// warp with a 28-instruction shuffle tree every step):
// * One exponential per element-step: the recompute keeps a_t = exp(dt_t
//   A) in shared memory (a[32][256] float4, 128 KB, the thread's own 16
//   bytes a step), and the reverse step reads it back. The reverse step is
//   ga = g a_t (the next step's carry), w = ga h_{t-1}.
// * States in half-chunk windows: the recompute runs over the whole chunk
//   and keeps the second half's 17 states in registers (hh[17][4]); the
//   first half's are recomputed from the saved state with the kept a_t
//   (an FMUL and an FMA, no exponential: the same bits) just before its
//   reverse steps. The compiler still fills the 255 registers that one
//   block an SM leaves it, but keeps the loads ahead of their use.
// * Staging that overlaps the steps: while chunk c runs, chunk c - 1's dt
//   and dy are in flight into the other stage of a 2-stage ring by
//   cp.async (16-byte copies where dI % 8 == 0 and the rows are aligned, a
//   template parameter, else 4-byte), its x, B and C (any type) and its
//   saved state into registers; they land after the steps. Two barriers a
//   chunk.
// * Sums across lanes without a shuffle tree on the hot path:
//   - over n (d(dt), dx): a lane's 4 states in registers, then the 4 lanes
//     of the channel in one transposed exchange every 4 steps (xor 2, then
//     xor 1: 6 shuffles), after which lane r holds step u + r's two sums
//     and stores its d(dt) and dx;
//   - over d (dB, dC): each lane writes its 8 products of a step into its
//     warp's tile in shared memory (2 x 16 bytes, swizzled so that no two
//     lanes of a phase share a bank); every 2 steps, lane l sums values
//     2 (l & 15), +1 of step (l >> 4) over the warp's 8 channels (8 loads
//     of 8 bytes), into the block's per-warp partials; at the chunk's end
//     the 8 warps' partials are summed in warp order into the block's
//     partial `part`; a last kernel sums the blocks' partials in block
//     order.
// * Parallel over channels and rows only: a block a (64 channels, row).
//   At the training shape (128 blocks) every SM already holds about as
//   many elements as its shared memory and registers can recompute
//   (~1,000: 32 kept exponentials and 17 states each), so cutting S into
//   segments that start from a carry folded from the later ones would add
//   a second wave and a pass of exponentials for the carries (on an H100,
//   2 and 4 segments at that shape took 2.3 and 1.7 times one segment).
// The reverse scan's shared memory (220 KB) keeps one block of 8 warps an
// SM, as K3.
//
// The sums, and their order (fixed: the same bits from run to run):
// * over n (d(dt), dx): the lane's 4 states in order, then lanes r and
//   r ^ 2 (the receiving lane's own sum first), then r and r ^ 1;
// * over d (dB, dC): the warp's 8 channels in order, then the block's 8
//   warps in order (per-block partials `part`), then the blocks in order
//   by the sum kernel;
// * over t (dA): steps in reverse order, into per-row partials that the
//   sum kernel adds row by row.
// Ragged S is padded inside the last chunk with dt = x = B = C = dy = 0
// steps (a = 1, b = 0: g and h pass through unchanged, nothing is stored);
// ragged dI and N < 16 are masked (A = B = C = 0 there: every sum gets 0).
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::cp_async16;
using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::smem_addr;

constexpr int kThreads = 256;
constexpr int kStates = 4;                 // states of one channel a thread
constexpr int kLanes = 4;                  // lanes a channel: N <= 16
constexpr int kMaxN = kLanes * kStates;
constexpr int kCh = kThreads / kLanes;     // channels a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // K3's chunk: steps between saved states
constexpr int kPart = 2 * kMaxN;           // (dB, dC) x n of one step
constexpr int kTile = 2;                   // steps a warp's d-sum tile holds
constexpr int kGroup = 4;                  // steps of one n-sum exchange
constexpr int kHalf = kChunk / 2;          // steps of a state window
static_assert(kChunk == 2 * kHalf && kHalf % kGroup == 0 &&
                  kGroup % kTile == 0, "");

// raw bits of one value of x, B or C, widened to fp32 when staged
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
// bf16); values at or past n (0 <= n <= 8) are zeros and not read.
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

__device__ __forceinline__ void unpack4(const float4 q, float (&v)[4]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// dynamic shared memory (220 KB): the recompute's exponentials, the warps'
// d-sum tiles and partials, then the chunk's inputs (dt and dy in a 2-stage
// ring, x, B and C in one stage written between the chunk's two barriers)
struct Smem {
  float4 a[kChunk][kThreads];              // a_t of the thread's 4 states
  float tile[kWarps][kTile][8][kPart];     // (step, channel, swizzled value)
  float part[kWarps][kChunk][kPart];       // each warp's sum over its channels
  float dt[2][kChunk][kCh];
  float dy[2][kChunk][kCh];
  float x[kChunk][kCh];
  float b[kChunk][kMaxN];
  float c[kChunk][kMaxN];
};

// The reverse scan of one (channel block, row). part: (gridDim.x, B, S,
// kPart) per-block sums over the block's channels of dB (n) and dC
// (kMaxN + n) per step; dA_part: (B, dI, N), the per-row sums over t.
template <typename T, bool kVec>
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
  constexpr int XW = sizeof(T) == 4 ? 2 : 1;   // 16-byte words of 8 x values
  constexpr int NBC = kChunk * kMaxN / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = tid % kLanes;       // lane within the channel
  const int n0 = r * kStates;
  const int c = tid / kLanes;       // channel within the block
  const int cw = lane / kLanes;     // channel within the warp
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + c;
  const bool dlive = d < dI;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  const int nch = (S + kChunk - 1) / kChunk;
  const size_t row0 = (size_t)b * S;

  // the carry into the last step: dhT
  float a_n[kStates], g[kStates], da[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const bool live = dlive && n0 + k < N;
    a_n[k] = live ? A[(size_t)d * N + n0 + k] : 0.f;
    g[k] = (live && dhT != nullptr) ? dhT[((size_t)b * dI + d) * N + n0 + k]
                                    : 0.f;
    da[k] = 0.f;
  }

  // staging of chunk ch: dt and dy by cp.async into stage ch & 1; x, B, C
  // and the saved state into registers (written after the current chunk).
  // Each thread's offsets at chunk 0; a chunk adds t0 rows.
  uint4 x_r[XW];
  unsigned b_r[NBC], c_r[NBC];
  float h_r[kStates];
  const int xu = tid / (kCh / 8);             // x row (step) of this thread
  const int xc = (tid % (kCh / 8)) * 8;       // its first channel
  const int nx = min(max(dI - d0 - xc, 0), 8);
  const size_t x_off = (row0 + xu) * dI + d0 + xc;
  constexpr int kCp = kVec ? 4 : 1;           // floats a copy
  constexpr int kCps = kChunk * kCh / kCp / kThreads;   // copies an array
  constexpr int kRow = kCh / kCp;             // copies a row
  auto prefetch = [&](int ch) {
    const int t0 = ch * kChunk;
    const int st = ch & 1;
    const size_t rows = (size_t)t0 * dI;
#pragma unroll
    for (int k = 0; k < kCps; ++k) {
      const int u = tid / kRow + k * (kThreads / kRow);
      const int q = (tid % kRow) * kCp;
      const bool ok = t0 + u < S && d0 + q < dI;
      const size_t o = ok ? rows + (row0 + u) * dI + d0 + q : 0;
      if (kVec) {
        cp_async16(smem_addr(&sm.dt[st][u][q]), dt + o, ok);
        cp_async16(smem_addr(&sm.dy[st][u][q]), dy + o, ok);
      } else {
        cp_async4(smem_addr(&sm.dt[st][u][q]), dt + o, ok);
        cp_async4(smem_addr(&sm.dy[st][u][q]), dy + o, ok);
      }
    }
    cp_async_commit();
    load8<T, XW>(x + rows + x_off, t0 + xu < S ? nx : 0, kVec, x_r);
#pragma unroll
    for (int k = 0; k < NBC; ++k) {
      const int i = tid + k * kThreads;
      const int u = i / kMaxN, n = i % kMaxN;
      const bool ok = t0 + u < S && n < N;
      const size_t o = (row0 + t0 + u) * N + n;
      b_r[k] = ok ? ld_bits(Bc + o) : 0u;
      c_r[k] = ok ? ld_bits(Cc + o) : 0u;
    }
    const float* hp = hs + (((size_t)b * nch + ch) * dI + d) * N + n0;
#pragma unroll
    for (int k = 0; k < kStates; ++k)
      h_r[k] = (dlive && n0 + k < N) ? hp[k] : 0.f;
  };
  auto stage_xbc = [&]() {
    float v[8];
    unpack8<T, XW>(x_r, v);
    float4* dst = reinterpret_cast<float4*>(&sm.x[xu][xc]);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
#pragma unroll
    for (int k = 0; k < NBC; ++k) {
      const int i = tid + k * kThreads;
      sm.b[i / kMaxN][i % kMaxN] = bits_f32<T>(b_r[k]);
      sm.c[i / kMaxN][i % kMaxN] = bits_f32<T>(c_r[k]);
    }
  };

  prefetch(nch - 1);
  cp_async_wait<0>();
  stage_xbc();
  __syncthreads();
  const int sw = (cw & 1) << 4;   // tile swizzle: odd channels swap halves
  for (int ch = nch - 1; ch >= 0; --ch) {
    const int st = ch & 1;
    const int t0 = ch * kChunk;
    const int tn = min(kChunk, S - t0);
    float h0[kStates];
#pragma unroll
    for (int k = 0; k < kStates; ++k) h0[k] = h_r[k];
    const bool more = ch > 0;
    if (more) prefetch(ch - 1);   // in flight during this chunk's steps

    // the chunk's states again, with K3's arithmetic, a_t kept; hh ends
    // with the second half's 17 states (the first half's pass through it)
    float hh[kHalf + 1][kStates];
#pragma unroll
    for (int k = 0; k < kStates; ++k) hh[0][k] = h0[k];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int i = u % kHalf;
      if (i == 0 && u > 0) {
#pragma unroll
        for (int k = 0; k < kStates; ++k) hh[0][k] = hh[kHalf][k];
      }
      const float vdt = sm.dt[st][u][c];
      const float dxv = vdt * sm.x[u][c];
      float bb[kStates], ea[kStates];
      unpack4(*reinterpret_cast<const float4*>(&sm.b[u][n0]), bb);
#pragma unroll
      for (int k = 0; k < kStates; ++k) {
        ea[k] = expf(vdt * a_n[k]);
        hh[i + 1][k] = fmaf(ea[k], hh[i][k], dxv * bb[k]);
      }
      sm.a[u][tid] = make_float4(ea[0], ea[1], ea[2], ea[3]);
    }

    // the halves' steps backwards, the second half first; g holds a_{t+1}
    // g_{t+1} on entry
#pragma unroll
    for (int half = 1; half >= 0; --half) {
      const int ub = half * kHalf;
      if (half == 0) {
        // the first half's states again, from the saved state and the kept
        // a_t (the same bits)
#pragma unroll
        for (int k = 0; k < kStates; ++k) hh[0][k] = h0[k];
#pragma unroll
        for (int i = 0; i < kHalf; ++i) {
          const float dxv = sm.dt[st][i][c] * sm.x[i][c];
          float bb[kStates], aa[kStates];
          unpack4(*reinterpret_cast<const float4*>(&sm.b[i][n0]), bb);
          unpack4(sm.a[i][tid], aa);
#pragma unroll
          for (int k = 0; k < kStates; ++k)
            hh[i + 1][k] = fmaf(aa[k], hh[i][k], dxv * bb[k]);
        }
      }
      float svx[kGroup], svdt[kGroup];   // x, dt of steps u0 .. u0 + 3
      float sv[2 * kGroup];   // (d(dt)'s, dx's) sums of steps u0 .. u0 + 3
#pragma unroll
      for (int i = kHalf - 1; i >= 0; --i) {
        const int u = ub + i;
        const float vdt = sm.dt[st][u][c], vdy = sm.dy[st][u][c];
        const float vx = sm.x[u][c];
        const float dxv = vdt * vx;
        float bb[kStates], cc[kStates], aa[kStates];
        unpack4(*reinterpret_cast<const float4*>(&sm.b[u][n0]), bb);
        unpack4(*reinterpret_cast<const float4*>(&sm.c[u][n0]), cc);
        unpack4(sm.a[u][tid], aa);
        float s1 = 0.f, s2 = 0.f, vb[kStates], vc[kStates];
#pragma unroll
        for (int k = 0; k < kStates; ++k) {
          g[k] = fmaf(cc[k], vdy, g[k]);              // g_t
          const float ga = g[k] * aa[k];              // a_t g_t, for t - 1
          const float w = ga * hh[i][k];              // dL/da_t * a_t
          s1 = fmaf(g[k], bb[k], s1);
          s2 = fmaf(w, a_n[k], s2);
          da[k] = fmaf(w, vdt, da[k]);
          vb[k] = g[k] * dxv;                         // dB_t, this channel
          vc[k] = hh[i + 1][k] * vdy;                 // dC_t, this channel
          g[k] = ga;
        }
        sv[2 * (i % kGroup)] = s1;
        sv[2 * (i % kGroup) + 1] = s2;
        svx[i % kGroup] = vx;
        svdt[i % kGroup] = vdt;
        float* row = sm.tile[warp][i % kTile][cw];
        *reinterpret_cast<float4*>(row + ((kStates * r) ^ sw)) =
            make_float4(vb[0], vb[1], vb[2], vb[3]);
        *reinterpret_cast<float4*>(row + ((kMaxN + kStates * r) ^ sw)) =
            make_float4(vc[0], vc[1], vc[2], vc[3]);
        if (i % kTile == 0) {
          // lane l: values j, j + 1 of step u + (l >> 4), over the warp's 8
          // channels in order
          __syncwarp();
          const int s = lane >> 4, j = 2 * (lane & 15);
          float2 acc = make_float2(0.f, 0.f);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float2 v = *reinterpret_cast<const float2*>(
                &sm.tile[warp][s][q][j ^ ((q & 1) << 4)]);
            acc.x += v.x;
            acc.y += v.y;
          }
          *reinterpret_cast<float2*>(&sm.part[warp][u + s][j]) = acc;
          __syncwarp();
        }
        if (i % kGroup == 0) {
          // the sums over the channel's 4 lanes, transposed: lane r keeps
          // steps u + 2 (r >> 1) .. + 1, then step u + r
          {
            const bool hi = (r & 2) != 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float send = hi ? sv[j] : sv[j + 4];
              const float keep = hi ? sv[j + 4] : sv[j];
              sv[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
            }
          }
          {
            const bool hi = (r & 1) != 0;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float send = hi ? sv[j] : sv[j + 2];
              const float keep = hi ? sv[j + 2] : sv[j];
              sv[j] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
            }
          }
          const float xr = r == 0 ? svx[0] : r == 1 ? svx[1]
                         : r == 2 ? svx[2] : svx[3];
          const float dtr = r == 0 ? svdt[0] : r == 1 ? svdt[1]
                          : r == 2 ? svdt[2] : svdt[3];
          if (u + r < tn && dlive) {
            const size_t t = row0 + t0 + u + r;
            ddt[t * dI + d] = fmaf(xr, sv[0], sv[1]);
            dx[t * dI + d] = repro_torch::from_f32<T>(dtr * sv[0]);
          }
        }
      }
    }
    if (more) cp_async_wait<0>();
    __syncthreads();   // the warps' partials are complete; x, B, C are free
    // the block's sum over its 8 warps, warp by warp
    for (int i = tid; i < kChunk * kPart; i += kThreads) {
      const int u = i / kPart, j = i % kPart;
      if (u < tn) {
        float sum = sm.part[0][u][j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += sm.part[w][u][j];
        part[(((size_t)blockIdx.x * B + b) * S + t0 + u) * kPart + j] = sum;
      }
    }
    if (more) stage_xbc();
    __syncthreads();   // the next chunk is staged; the partials are free
  }
#pragma unroll
  for (int k = 0; k < kStates; ++k)
    if (dlive && n0 + k < N)
      dA_part[((size_t)b * dI + d) * N + n0 + k] = da[k];
}

// The fixed-order sums: dB, dC (B, S, N) over the nblk blocks' partials in
// block order, rounded once to T; dA (dI, N) over the rows' partials, row
// by row.
template <typename T>
__global__ void __launch_bounds__(256)
    mamba_scan_bwd_sum_kernel(const float* __restrict__ part,
                              const float* __restrict__ dA_part,
                              T* __restrict__ dB, T* __restrict__ dC,
                              float* __restrict__ dA, int nblk, int B, int S,
                              int dI, int N, int nrows) {
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
  for (int q = 0; q < nrows; ++q) sum += dA_part[(size_t)q * dI * N + j];
  dA[j] = sum;
}

template <typename T>
cudaError_t launch(const void* dt, const void* x, const void* Bc,
                   const void* Cc, const void* A, const void* hs,
                   const void* dy, const void* dhT, void* ddt, void* dx,
                   void* dB, void* dC, void* dA, void* part, void* dA_part,
                   int B, int S, int dI, int N, cudaStream_t stream) {
  const int nblk = (dI + kCh - 1) / kCh;
  // 16-byte staging of dt, dy and x: every row 16-byte aligned
  const bool vec = dI % 8 == 0 && ((reinterpret_cast<uintptr_t>(dt) |
                                    reinterpret_cast<uintptr_t>(dy) |
                                    reinterpret_cast<uintptr_t>(x)) & 15) == 0;
  auto kernel = vec ? mamba_scan_bwd_kernel<T, true>
                    : mamba_scan_bwd_kernel<T, false>;
  kernel<<<dim3(nblk, B), kThreads, sizeof(Smem), stream>>>(
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
      static_cast<float*>(dA), nblk, B, S, dI, N, B);
  return cudaGetLastError();
}

}  // namespace

// Opt the reverse scan in to its 220 KB of dynamic shared memory; run once
// per device by kernels/_build.py before any launch.
extern "C" int repro_mamba_scan_bwd_init() {
  const void* kernels[] = {
      (const void*)mamba_scan_bwd_kernel<float, true>,
      (const void*)mamba_scan_bwd_kernel<float, false>,
      (const void*)mamba_scan_bwd_kernel<__nv_bfloat16, true>,
      (const void*)mamba_scan_bwd_kernel<__nv_bfloat16, false>};
  for (const void* k : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Resident blocks per SM of the reverse scan and the sum kernel for x's
// dtype (cudaOccupancyMaxActiveBlocksPerMultiprocessor at their launch
// sizes), into out[0..1]; run after the init entry point.
extern "C" int repro_mamba_scan_bwd_occupancy(int dtype, int* out) {
  cudaError_t err;
  if (dtype == repro_torch::kBFloat16) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, mamba_scan_bwd_kernel<__nv_bfloat16, true>, kThreads,
        sizeof(Smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out + 1, mamba_scan_bwd_sum_kernel<__nv_bfloat16>, 256, 0);
  } else if (dtype == repro_torch::kFloat32) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, mamba_scan_bwd_kernel<float, true>, kThreads, sizeof(Smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out + 1, mamba_scan_bwd_sum_kernel<float>, 256, 0);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// C entry point bound with ctypes (kernels/mamba_scan_bwd.py). dtype is the
// type of x, B and C and of their gradients dx, dB and dC; dt, A, hs (the
// states before each 32-step chunk, from repro_mamba_scan_states), dy, dhT,
// d(dt) and dA are fp32; dhT may be null (no gradient on the final state).
// Scratch: part (ceil(dI / 64), B, S, 32), dA_part (B, dI, N). Launches
// the reverse scan, then the fixed-order sums into dB, dC (B, S, N) and dA
// (dI, N). Returns the launches' cudaError_t (0 on success); the wrapper
// raises on anything else.
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

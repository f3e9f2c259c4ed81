// K4: one LSDNN inference layer for Hopper (sm_90a).
//
// Replaces the TPU kernel `_lsdnn_kernel` (public `lsdnn_layer`) in
// src/repro/kernels/lsdnn_layer.py: out = clamp(relu(y @ w + b), 0, cap)
// for y (T, F), w (F, G), b (G,), the layer of the HPEC sparse-DNN
// inference challenge (paper §5.3). Operands are fp32 or bf16 (bf16 is
// upcast on load), products and sums are exact fp32 FMAs, the output is
// written in the operands' dtype.
//
// What bounds it on the H100: at the challenge's shape (T = 60000 rows,
// F = G = 1024) a layer is 2 * T * F * G = 126 GFLOP against 0.5 GB of
// bytes, so the floor is compute: 1.88 ms at the fp32 (non-tensor) peak of
// 67 TFLOP/s against 0.15 ms of bytes at 3.35 TB/s. The tensor cores (TF32
// at 495 TFLOP/s, bf16 at 989) round the operands, which the reference's
// exact fp32 products do not, so the kernel is an SGEMM on the CUDA cores
// and its whole game is keeping the FFMA pipes fed.
//
// Design: the TPU grid (T/bm, G/bn, F/bk) ran the K axis sequentially with
// the fp32 accumulator in VMEM and the epilogue on the last K step. Here a
// persistent grid (SM count x resident blocks per SM, read from the device
// when the library is loaded) walks the 128 x 128 output tiles, tile
// b, b + P, b + 2P, ... for block b, so the P tiles in flight are adjacent:
// the G tiles of one row tile run together, y comes from device memory once
// and w (4 MB) stays in L2. Tiles left over after the last full round (the
// 21%-full last wave of a one-tile-per-block grid at the HPEC shape) are cut
// into 2 or 4 row strips of 64 or 32 rows, one per block, so the tail costs
// a fraction of a round. A block of 256 threads keeps an 8 x 8 register
// micro-tile per thread (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
// likewise with tx; 2 x 8 or 4 x 8 on the strips) and multiplies K steps of
// 32 out of a 3-stage ring in dynamic shared memory (99,840 B, two blocks
// per SM), one barrier per K step (2,048 FFMAs per thread between
// barriers). The ring is filled with cp.async and runs across tile
// boundaries, so the next tile's first K steps load during this tile's last
// ones and its epilogue. The prologue fills kStages - 1 stages; K step s
// then waits for its own copy group only (wait_group 1, or 0 for the last
// step: no empty groups are committed) before the barrier. y lands
// k-major: each 4-byte copy puts its element at its transposed place (a
// warp copies 4 rows x 8 k, full 32-byte sectors; the k-major rows are
// padded to 132 floats so the 32 stores hit 32 banks), which makes every
// read of the inner loop a float4 (16:1 FFMA to shared-memory loads) with
// no transposing pass and no extra barrier.
// w lands row-major in 16-byte copies. The bias + relu + clamp epilogue runs
// in registers after a tile's last K step, as the TPU kernel's
// `pl.when(ki == nk - 1)`, and stores float4s. The TPU kernel asserted tile
// multiples; here ragged T, F and G are masked (copies outside the matrix
// zero-fill, stores are skipped), so T = 60000 needs no padding. G not a
// multiple of 4, or a misaligned w, takes 4-byte copies of w; bf16 operands
// are loaded, converted and stored to the same fp32 ring by the threads.
#include <limits.h>

#include "common.cuh"

namespace {

using repro_torch::allow_smem;
using repro_torch::cp_async16;
using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::from_f32;
using repro_torch::smem_addr;
using repro_torch::to_f32;

constexpr int kBM = 128;   // output rows of a full tile
constexpr int kBN = 128;   // output columns of a tile
constexpr int kBK = 32;    // K step
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kAS = kBM + 4;            // k-major y row: 132 floats
constexpr int kAStage = kBK * kAS;      // floats
constexpr int kBStage = kBK * kBN;
constexpr int kStageFloats = kAStage + kBStage;
constexpr size_t kSmemBytes = (size_t)kStages * kStageFloats * sizeof(float);
constexpr int kMaxDevices = 64;

// persistent grid size per device and instantiation, set by the init entry
int g_blocks[kMaxDevices][4];

// The schedule of one launch: `rounds` full tiles per block (tile b + j*P
// in round j), then, for blocks b < tail, one strip: leftover tile
// rounds*P + b / split, rows part * 128/split .. of it, part = b % split.
struct Sched {
  int ntn;     // column tiles
  int P;       // blocks of the full rounds
  int rounds;
  int split;   // 1, 2 or 4
  int tail;    // strips
};

struct Unit {
  int m0, n0, mi;  // first row, first column, rows per thread (8, 4, 2)
};

__device__ __forceinline__ Unit unit_of(int j, const Sched& sc) {
  int t, off = 0, mi = 8;
  if (j < sc.rounds) {
    t = blockIdx.x + j * sc.P;
  } else {
    t = sc.rounds * sc.P + blockIdx.x / sc.split;
    mi = 8 / sc.split;
    off = (blockIdx.x % sc.split) * (16 * mi);
  }
  return Unit{(t / sc.ntn) * kBM + off, (t % sc.ntn) * kBN, mi};
}

// row of the unit held in accumulator row i by thread row ty
template <int MI>
__device__ __forceinline__ int row_of(int i, int ty) {
  if constexpr (MI == 8) return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
  return ty * MI + i;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// This thread's copy sources for one unit, set once per unit so that a K
// step's copies are a pointer plus immediate offsets. Thread (warp, lane)
// copies rows r + 32 j (j < MI/2) of y at columns k0 + ka + 8 i (i < 4),
// each element to As[ka + 8 i][r + 32 j]: a warp copies 4 rows x 8 k, full
// 32-byte sectors, and its 32 stores hit 32 banks (row stride 132). Of w it
// copies row k0 + r at columns cb + 32 i (i < 4, 16-byte chunks, VEC) or
// cb + 8 i (i < 16, elements), rows of 128 columns per 8 lanes.
template <typename T>
struct Feed {
  const T* y;     // &y[m0 + r][ka]
  const T* w;     // &w[r][n0 + cb]
  int y_rows;     // rows r + 32 j < y_rows lie inside y
  int w_cols;     // columns cb + c < w_cols lie inside w
  bool inside;    // every row and column of the unit lies inside
};

template <typename T, bool VEC>
__device__ __forceinline__ Feed<T> feed_of(const Unit& u, const T* y,
                                           const T* w, int Tn, int F, int G,
                                           int tid) {
  const int lane = tid & 31;
  const int r = (tid >> 5) * 4 + (lane >> 3);
  const int cb = VEC ? (lane & 7) * 4 : lane & 7;
  Feed<T> f;
  f.y = y + (size_t)(u.m0 + r) * F + (lane & 7);
  f.w = w + (size_t)r * G + u.n0 + cb;
  f.y_rows = Tn - u.m0 - r;
  f.w_cols = G - u.n0 - cb;
  f.inside = Tn - u.m0 >= 16 * u.mi && G - u.n0 >= kBN;
  return f;
}

// one element (4-byte cp.async for fp32; load, convert, store for bf16)
template <typename T>
__device__ __forceinline__ void copy1(float* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) == 4)
    cp_async4(smem_addr(dst), src, ok);
  else
    *dst = ok ? to_f32(*src) : 0.f;
}

// four consecutive elements of w (16-byte cp.async for fp32)
template <typename T>
__device__ __forceinline__ void copy4(float* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) == 4) {
    cp_async16(smem_addr(dst), src, ok);
  } else {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(src);
      const float2 lo = __bfloat1622float2(p[0]);
      const float2 hi = __bfloat1622float2(p[1]);
      x = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
    *reinterpret_cast<float4*>(dst) = x;
  }
}

// One K step (columns k0 .. k0 + 31 of y, rows k0 .. k0 + 31 of w) of one
// unit into a ring stage; INSIDE: no element of it lies outside y or w.
template <typename T, bool VEC, int MI, bool INSIDE>
__device__ __forceinline__ void load_step(float* As, float* Bs,
                                          const Feed<T>& f, const T* y,
                                          const T* w, int F, int G, int k0,
                                          int tid) {
  const int lane = tid & 31;
  const int r = (tid >> 5) * 4 + (lane >> 3);
  const int ka = lane & 7;
  const int cb = VEC ? (lane & 7) * 4 : lane & 7;
  const int k_left = F - k0 - ka;      // columns ka + 8 i < k_left inside
  const T* ys = f.y + k0;
  float* ad = As + ka * kAS + r;
#pragma unroll
  for (int j = 0; j < MI / 2; ++j) {
    const T* yr = ys + (size_t)(32 * j) * F;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = INSIDE || (32 * j < f.y_rows && 8 * i < k_left);
      copy1<T>(ad + 8 * i * kAS + 32 * j, ok ? yr + 8 * i : y, ok);
    }
  }
  const bool k_ok = INSIDE || r < F - k0;
  const T* ws = f.w + (size_t)k0 * G;
  float* bd = Bs + r * kBN + cb;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = INSIDE || (k_ok && 32 * i < f.w_cols);
      copy4<T>(bd + 32 * i, ok ? ws + 32 * i : w, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool ok = INSIDE || (k_ok && 8 * i < f.w_cols);
      copy1<T>(bd + 8 * i, ok ? ws + 8 * i : w, ok);
    }
  }
}

template <typename T, bool VEC, int MI>
__device__ __forceinline__ void load_step(float* As, float* Bs,
                                          const Feed<T>& f, const T* y,
                                          const T* w, int F, int G, int k0,
                                          int tid) {
  if (f.inside && k0 + kBK <= F)
    load_step<T, VEC, MI, true>(As, Bs, f, y, w, F, G, k0, tid);
  else
    load_step<T, VEC, MI, false>(As, Bs, f, y, w, F, G, k0, tid);
}

// one K step into the ring stage at `stage`, for a unit of `mi` rows per
// thread
template <typename T, bool VEC>
__device__ __forceinline__ void produce_step(float* stage, const Feed<T>& f,
                                             int mi, const T* y, const T* w,
                                             int F, int G, int k0, int tid) {
  float* Bs = stage + kAStage;
  if (mi == 8)
    load_step<T, VEC, 8>(stage, Bs, f, y, w, F, G, k0, tid);
  else if (mi == 4)
    load_step<T, VEC, 4>(stage, Bs, f, y, w, F, G, k0, tid);
  else
    load_step<T, VEC, 2>(stage, Bs, f, y, w, F, G, k0, tid);
}

// acc[i][j] += y[row_of(i)][k] * w[k][col j] over the stage's 32 k.
// Unrolled by 8, not 32: fully unrolled (times three row variants) it
// measured slower on an H100, likely from instruction-cache misses
template <int MI>
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs,
                                          float (&acc)[8][8], int ty,
                                          int tx) {
#pragma unroll 8
  for (int k = 0; k < kBK; ++k) {
    float a[MI];
    if constexpr (MI == 8) {
      const float4 a0 = lds4(As + k * kAS + ty * 4);
      const float4 a1 = lds4(As + k * kAS + 64 + ty * 4);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    } else if constexpr (MI == 4) {
      const float4 a0 = lds4(As + k * kAS + ty * 4);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    } else {
      const float2 a0 = *reinterpret_cast<const float2*>(As + k * kAS + ty * 2);
      a[0] = a0.x; a[1] = a0.y;
    }
    const float4 b0 = lds4(Bs + k * kBN + tx * 4);
    const float4 b1 = lds4(Bs + k * kBN + 64 + tx * 4);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const uint32_t*>(&lo);
  x.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}

// bias, relu, clamp at cap (NaN propagates, as torch.clamp), store
template <typename T, int MI>
__device__ __forceinline__ void epilogue(const float (&acc)[8][8],
                                         const T* __restrict__ b,
                                         T* __restrict__ out, int Tn, int G,
                                         float cap, const Unit& u, int ty,
                                         int tx) {
  const int c0 = u.n0 + tx * 4;       // columns c0 + {0..3}, c0 + 64 + {0..3}
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = c0 + (j < 4 ? j : 60 + j);
    bias[j] = col < G ? to_f32(b[col]) : 0.f;
  }
  const bool vec = (G & 3) == 0;      // whole groups of 4 in or out
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = u.m0 + row_of<MI>(i, ty);
    if (row >= Tn) continue;
    T* orow = out + (size_t)row * G;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = acc[i][half * 4 + j] + bias[half * 4 + j];
        x = x < 0.f ? 0.f : x;
        v[j] = x > cap ? cap : x;
      }
      const int col = c0 + half * 64;
      if (vec) {
        if (col < G) store4(orow + col, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < G) orow[col + j] = from_f32<T>(v[j]);
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
lsdnn_layer_kernel(const T* __restrict__ y,  // (T, F)
                   const T* __restrict__ w,  // (F, G)
                   const T* __restrict__ b,  // (G,)
                   T* __restrict__ out,      // (T, G)
                   int Tn, int F, int G, float cap, Sched sc) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int nk = (F + kBK - 1) / kBK;
  const int nunits = sc.rounds + (blockIdx.x < sc.tail ? 1 : 0);
  const int nsteps = nunits * nk;

  // producer: the next K step to copy (unit p_j, K step p_k), kStages - 1
  // steps ahead of the consumer; ring stages advance with the steps
  int p_k = 0, p_j = 0;
  Unit pu = unit_of(0, sc);
  Feed<T> feed = feed_of<T, VEC>(pu, y, w, Tn, F, G, tid);
  const int ahead = min(kStages - 1, nsteps);
  for (int s = 0; s < ahead; ++s) {
    produce_step<T, VEC>(smem + s * kStageFloats, feed, pu.mi, y, w, F, G,
                         p_k * kBK, tid);
    cp_async_commit();
    if (++p_k == nk) {
      p_k = 0;
      pu = unit_of(++p_j, sc);
      feed = feed_of<T, VEC>(pu, y, w, Tn, F, G, tid);
    }
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  Unit cu = unit_of(0, sc);
  int c_k = 0, c_j = 0, c_st = 0, p_st = ahead % kStages;
  for (int step = 0; step < nsteps; ++step) {
    // this thread's copies of `step` have landed: the groups in flight
    // cover steps step .. min(step + kStages - 2, nsteps - 1)
    if (step + kStages - 2 < nsteps)
      cp_async_wait<kStages - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();  // everyone's have; step - 1's stage is free to refill
    if (step + kStages - 1 < nsteps) {
      produce_step<T, VEC>(smem + p_st * kStageFloats, feed, pu.mi, y, w, F,
                           G, p_k * kBK, tid);
      cp_async_commit();
      p_st = p_st + 1 == kStages ? 0 : p_st + 1;
      if (++p_k == nk) {
        p_k = 0;
        pu = unit_of(++p_j, sc);
        feed = feed_of<T, VEC>(pu, y, w, Tn, F, G, tid);
      }
    }
    const float* As = smem + c_st * kStageFloats;
    const float* Bs = As + kAStage;
    if (cu.mi == 8)
      mma_stage<8>(As, Bs, acc, ty, tx);
    else if (cu.mi == 4)
      mma_stage<4>(As, Bs, acc, ty, tx);
    else
      mma_stage<2>(As, Bs, acc, ty, tx);
    c_st = c_st + 1 == kStages ? 0 : c_st + 1;
    if (++c_k == nk) {  // the unit's last K step: epilogue, next unit
      if (cu.mi == 8)
        epilogue<T, 8>(acc, b, out, Tn, G, cap, cu, ty, tx);
      else if (cu.mi == 4)
        epilogue<T, 4>(acc, b, out, Tn, G, cap, cu, ty, tx);
      else
        epilogue<T, 2>(acc, b, out, Tn, G, cap, cu, ty, tx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      c_k = 0;
      cu = unit_of(++c_j, sc);
    }
  }
}

template <typename T, bool VEC>
constexpr int variant() {
  return (sizeof(T) == 2 ? 2 : 0) + (VEC ? 1 : 0);
}

template <typename T, bool VEC>
cudaError_t init_one(int dev, int sms) {
  auto kern = lsdnn_layer_kernel<T, VEC>;
  cudaError_t e = allow_smem(kern, kSmemBytes);
  // all of the SM's 256 KB of L1 / shared memory as shared: otherwise the
  // driver may size the carve-out for one block of 99,840 B, not two
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    kSmemBytes);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  g_blocks[dev][variant<T, VEC>()] = sms * per_sm;
  return cudaSuccess;
}

template <typename T, bool VEC>
cudaError_t launch(const void* y, const void* w, const void* b, void* out,
                   int Tn, int F, int G, float cap, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || g_blocks[dev][variant<T, VEC>()] <= 0)
    return cudaErrorInitializationError;  // init entry point not run
  Sched sc;
  const int P = g_blocks[dev][variant<T, VEC>()];
  sc.ntn = (G + kBN - 1) / kBN;
  const long long tiles = (long long)((Tn + kBM - 1) / kBM) * sc.ntn;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  sc.P = P;
  sc.rounds = (int)(tiles / P);
  const int rem = (int)(tiles % P);
  sc.split = 4 * rem <= P ? 4 : 2 * rem <= P ? 2 : 1;
  sc.tail = rem * sc.split;
  const int grid = sc.rounds > 0 ? P : sc.tail;
  lsdnn_layer_kernel<T, VEC><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), Tn, F, G, cap, sc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* y, const void* w, const void* b, void* out,
                     int Tn, int F, int G, float cap, cudaStream_t stream) {
  // 16-byte (fp32) or 8-byte (bf16) groups of 4 w elements; y is copied
  // element by element and needs no alignment beyond its element's
  const bool vec = G % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % (4 * sizeof(T)) == 0;
  return vec ? launch<T, true>(y, w, b, out, Tn, F, G, cap, stream)
             : launch<T, false>(y, w, b, out, Tn, F, G, cap, stream);
}

}  // namespace

// Opts the four instantiations in to 99,840 B of dynamic shared memory and
// records their persistent grid (SM count x resident blocks per SM) on the
// current device. Run once per device by kernels/_build.py when it loads
// the library, so no launch, and no CUDA-graph capture of one, sets an
// attribute.
extern "C" int repro_lsdnn_layer_init() {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = init_one<float, true>(dev, sms);
  if (e == cudaSuccess) e = init_one<float, false>(dev, sms);
  if (e == cudaSuccess) e = init_one<__nv_bfloat16, true>(dev, sms);
  if (e == cudaSuccess) e = init_one<__nv_bfloat16, false>(dev, sms);
  return (int)e;
}

// C entry point bound with ctypes (kernels/lsdnn_layer.py). A 1-D
// persistent grid walks the ceil(T / 128) x ceil(G / 128) output tiles, the
// reference's (T / bm, G / bn) grid, G tiles of one row tile adjacent.
// Returns the launch's cudaError_t (0 on success); the wrapper raises on
// anything else.
extern "C" int repro_lsdnn_layer(int dtype, const void* y, const void* w,
                                 const void* b, void* out, int T, int F,
                                 int G, float cap, void* stream) {
  if (T <= 0 || F <= 0 || G <= 0 || (T + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro_torch::kBFloat16)
    return (int)launch_t<__nv_bfloat16>(y, w, b, out, T, F, G, cap, s);
  if (dtype == repro_torch::kFloat32)
    return (int)launch_t<float>(y, w, b, out, T, F, G, cap, s);
  return (int)cudaErrorInvalidValue;
}

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
// `wgmma` at 495 TFLOP/s, bf16 at 989) round the operands, which the
// reference's exact fp32 products do not; they, TMA loads and a persistent
// schedule are later work.
//
// Design: the TPU grid (T/bm, G/bn, F/bk) ran the K axis sequentially with
// the fp32 accumulator in VMEM and the epilogue on the last K step. Here one
// thread block of 256 threads owns one 128 x 128 output tile and loops over
// K in steps of 8 inside the block: a classic 2-D tiled SGEMM. Each thread
// keeps an 8 x 8 register micro-tile of the accumulator (two 4-row by two
// 4-column strips, so its shared-memory reads are float4 and free of bank
// conflicts). The y tile is stored k-major (transposed) in shared memory,
// the w tile row-major; both are double-buffered, and the next K step's
// operands are loaded into registers while the current one is multiplied,
// so one barrier per K step suffices. The bias + relu + clamp epilogue runs
// in registers after the last K step, as the TPU kernel's `pl.when(ki ==
// nk - 1)`. The TPU kernel asserted tile multiples; here ragged T, F and G
// are masked (loads outside the matrix read zeros, stores are skipped), so
// T = 60000 needs no padding. Blocks sweep the G tiles of one row tile
// together (gridDim.x is the G axis), so each y tile comes from device
// memory once and the w matrix (4 MB) stays in L2. Shared memory is
// 16,640 bytes of static arrays: no opt-in attribute, nothing to set while
// a CUDA graph is being captured.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kBM = 128;   // output rows per block
constexpr int kBN = 128;   // output columns per block
constexpr int kBK = 8;     // K step
constexpr int kThreads = 256;
constexpr int kAS = kBM + 4;  // y tile row stride: k-major, padded

// Four consecutive elements as fp32: one 16-byte load of fp32, two 4-byte
// loads of bf16 pairs.
__device__ __forceinline__ float4 load4_vec(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4_vec(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// p[c .. c+3] as fp32, each element masked by `c + i < limit` and the whole
// group by `ok`. VEC: the caller guarantees limit % 4 == 0 and 16-byte (fp32)
// or 8-byte (bf16) alignment, so the group is wholly inside or outside.
template <bool VEC, typename T>
__device__ __forceinline__ float4 load4(const T* p, int c, int limit,
                                        bool ok) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!ok) return r;
  if (VEC) {
    if (c < limit) r = load4_vec(p + c);
  } else {
    if (c + 0 < limit) r.x = to_f32(p[c + 0]);
    if (c + 1 < limit) r.y = to_f32(p[c + 1]);
    if (c + 2 < limit) r.z = to_f32(p[c + 2]);
    if (c + 3 < limit) r.w = to_f32(p[c + 3]);
  }
  return r;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
lsdnn_layer_kernel(const T* __restrict__ y,  // (T, F)
                   const T* __restrict__ w,  // (F, G)
                   const T* __restrict__ b,  // (G,)
                   T* __restrict__ out,      // (T, G)
                   int Tn, int F, int G, float cap) {
  __shared__ __align__(16) float a_s[2][kBK][kAS];
  __shared__ __align__(16) float b_s[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  // loader roles: y tile 128 rows x 8 k (4 k per thread), w tile 8 k x 128
  // columns (4 columns per thread)
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int b_k = tid >> 5;
  const int b_col = (tid & 31) * 4;
  const bool a_ok = m0 + a_row < Tn;
  const T* a_ptr = y + (size_t)(a_ok ? m0 + a_row : 0) * F;

  // compute roles: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, likewise
  // columns with tx
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto load_a = [&](int k0) {
    return load4<VEC>(a_ptr, k0 + a_k, F, a_ok);
  };
  auto load_b = [&](int k0) {
    const int k = k0 + b_k;
    const bool ok = k < F;
    return load4<VEC>(w + (size_t)(ok ? k : 0) * G, n0 + b_col, G, ok);
  };
  auto store = [&](int buf, float4 ra, float4 rb) {
    a_s[buf][a_k + 0][a_row] = ra.x;
    a_s[buf][a_k + 1][a_row] = ra.y;
    a_s[buf][a_k + 2][a_row] = ra.z;
    a_s[buf][a_k + 3][a_row] = ra.w;
    *reinterpret_cast<float4*>(&b_s[buf][b_k][b_col]) = rb;
  };

  store(0, load_a(0), load_b(0));
  __syncthreads();

  const int nk = (F + kBK - 1) / kBK;
  int buf = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    float4 na = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 nb = na;
    if (more) {  // next K step into registers while this one is multiplied
      na = load_a((kt + 1) * kBK);
      nb = load_b((kt + 1) * kBK);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store(buf ^ 1, na, nb);
    __syncthreads();  // the other buffer is full, this one is consumed
    buf ^= 1;
  }

  // epilogue: bias, relu, clamp at cap (NaN propagates, as torch.clamp)
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    bias[j] = col < G ? to_f32(b[col]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= Tn) continue;
    T* orow = out + (size_t)row * G;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < G) {
        float v = acc[i][j] + bias[j];
        v = v < 0.f ? 0.f : v;
        v = v > cap ? cap : v;
        orow[col] = from_f32<T>(v);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* y, const void* w, const void* b, void* out,
                   int Tn, int F, int G, float cap, cudaStream_t stream) {
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = F % 4 == 0 && G % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % align == 0 &&
                   reinterpret_cast<uintptr_t>(w) % align == 0;
  const dim3 grid((G + kBN - 1) / kBN, (Tn + kBM - 1) / kBM);
  const T* yp = static_cast<const T*>(y);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  if (vec)
    lsdnn_layer_kernel<T, true>
        <<<grid, kThreads, 0, stream>>>(yp, wp, bp, op, Tn, F, G, cap);
  else
    lsdnn_layer_kernel<T, false>
        <<<grid, kThreads, 0, stream>>>(yp, wp, bp, op, Tn, F, G, cap);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes (kernels/lsdnn_layer.py). Grid is
// (ceil(G / 128), ceil(T / 128)): the reference's (T / bm, G / bn) with the
// G axis first, so that one row tile's column blocks run together. Returns
// the launch's cudaError_t (0 on success); the wrapper raises on anything
// else.
extern "C" int repro_lsdnn_layer(int dtype, const void* y, const void* w,
                                 const void* b, void* out, int T, int F,
                                 int G, float cap, void* stream) {
  if (T <= 0 || F <= 0 || G <= 0 || (T + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro_torch::kBFloat16)
    return (int)launch<__nv_bfloat16>(y, w, b, out, T, F, G, cap, s);
  if (dtype == repro_torch::kFloat32)
    return (int)launch<float>(y, w, b, out, T, F, G, cap, s);
  return (int)cudaErrorInvalidValue;
}

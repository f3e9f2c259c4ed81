// K2: causal / non-causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` (public `flash_attention`) in
// src/repro/kernels/flash_attention.py: q (B, S, H, hd) attends over k/v
// (B, T, KV, hd), query head h reading kv head h // (H / KV), with an fp32
// online softmax over kv tiles. Causal kv tiles wholly above the diagonal
// are pruned (the reference's `_last_kv_block`), which here is simply the
// bound of the kv loop; the output equals the fully masked one.
//
// What bounds it on the H100: at the serving engine's window-0 prefill
// shapes (S = T <= 128, hd = 64) the work is a few hundred MFLOP against a
// few MB, so the floor is max(causal flops / 989 TFLOP/s, bytes / 3.35 TB/s)
// and both are microseconds: launch latency and, for this simple version,
// fp32 CUDA-core arithmetic out of shared memory dominate.
//
// Design: the TPU grid (B, H, S/bq, T/bk) ran the kv axis sequentially with
// (acc, m, l) in VMEM. Here one thread block owns one (q tile, head, batch)
// and loops over kv tiles up to the causal last tile. Q, K and V tiles are
// staged in shared memory as fp32 (rows padded by one float so the score
// loop is free of bank conflicts), scores and probabilities live in a
// shared (bq, bk) tile, the per-row running max and denominator in shared
// memory, and each thread keeps its slice of the (bq, hd) accumulator in
// registers. Unlike the TPU kernel, which asserts S % bq == T % bk == 0,
// ragged S and T are handled by masking: out-of-range keys score NEG_INF,
// out-of-range query rows are computed on zeros and never stored, so
// S < bq (the engine's short windows) is fine. Tensor cores (wgmma) and
// TMA pipelining are later work.
#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::kNegInf;
using repro_torch::to_f32;

constexpr int kBQ = 32;       // query rows per block
constexpr int kBK = 32;       // keys per kv tile
constexpr int kThreads = 128;

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD +
                  kBQ * (kBK + 1) + 3 * kBQ) *
         sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q,  // (B, S, H, HD)
                       const T* __restrict__ k,  // (B, Tk, KV, HD)
                       const T* __restrict__ v,  // (B, Tk, KV, HD)
                       T* __restrict__ o,        // (B, S, H, HD)
                       int S, int Tk, int H, int KV, int causal, float scale) {
  constexpr int HDP = HD + 1;          // padded smem row stride
  constexpr int SP = kBK + 1;
  constexpr int ACC = kBQ * HD / kThreads;  // accumulator entries / thread
  extern __shared__ float smem[];
  float* q_s = smem;                   // (BQ, HDP)
  float* k_s = q_s + kBQ * HDP;        // (BK, HDP)
  float* v_s = k_s + kBK * HDP;        // (BK, HD)
  float* s_s = v_s + kBK * HD;         // (BQ, SP) scores -> probabilities
  float* m_s = s_s + kBQ * SP;         // (BQ,) running max
  float* l_s = m_s + kBQ;              // (BQ,) running denominator
  float* a_s = l_s + kBQ;              // (BQ,) rescale factor of this tile

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e - r * HD;
    const int s = q0 + r;
    q_s[r * HDP + d] =
        s < S ? to_f32(q[(((size_t)b * S + s) * H + h) * HD + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int nk = (Tk + kBK - 1) / kBK;
  int last = nk - 1;
  if (causal) {  // last kv tile holding a position <= the tile's last row
    const int q_end = min(q0 + kBQ, S) - 1;
    last = min(q_end / kBK, nk - 1);
  }
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile consumed; q tile and init visible
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      const int t = k0 + r;
      float kk = 0.f, vv = 0.f;
      if (t < Tk) {
        const size_t off = (((size_t)b * Tk + t) * KV + kvh) * HD + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[r * HDP + d] = kk;
      v_s[r * HD + d] = vv;
    }
    __syncthreads();
    for (int p = tid; p < kBQ * kBK; p += kThreads) {
      const int r = p / kBK;
      const int c = p - r * kBK;
      float d = 0.f;
#pragma unroll 16
      for (int i = 0; i < HD; ++i) d += q_s[r * HDP + i] * k_s[c * HDP + i];
      const int qpos = q0 + r;
      const int kpos = k0 + c;
      const bool ok = kpos < Tk && (!causal || qpos >= kpos);
      s_s[r * SP + c] = ok ? d * scale : kNegInf;
    }
    __syncthreads();
    if (tid < kBQ) {
      float* row = s_s + tid * SP;
      const float m_prev = m_s[tid];
      float mx = kNegInf;
      for (int c = 0; c < kBK; ++c) mx = fmaxf(mx, row[c]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < kBK; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = alpha * l_s[tid] + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / HD;
      const int d = e - r * HD;
      const float* row = s_s + r * SP;
      float a = acc[i] * a_s[r];
#pragma unroll 8
      for (int c = 0; c < kBK; ++c) a += row[c] * v_s[c * HD + d];
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / HD;
    const int d = e - r * HD;
    const int s = q0 + r;
    if (s < S) {
      float l = l_s[r];
      if (l == 0.f) l = 1.f;  // fully-masked rows
      o[(((size_t)b * S + s) * H + h) * HD + d] = from_f32<T>(acc[i] / l);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int KV, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, KV, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int S, int Tk, int H, int KV,
                        int causal, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tk, H, KV, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, S, Tk, H, KV, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tk, H, KV, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tk, H, KV, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/flash_attention.py). Grid is
// (ceil(S / bq), H, B): the reference's (B, H, S / bq) with the q-tile axis
// first, since only gridDim.x may exceed 65535. Returns the launch's
// cudaError_t (0 on success); the wrapper raises on anything else.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int Tk, int H, int KV, int hd,
                                     int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro_torch::kBFloat16)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, Tk, H, KV,
                                           causal, scale, s);
  if (dtype == repro_torch::kFloat32)
    return (int)dispatch_hd<float>(hd, q, k, v, o, B, S, Tk, H, KV, causal,
                                   scale, s);
  return (int)cudaErrorInvalidValue;
}

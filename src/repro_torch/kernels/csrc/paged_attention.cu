// K1: paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel`, driven by
// `_paged_attention_pallas`, in src/repro/kernels/paged_attention.py: one
// new token per batch row attends over that row's KV pages, read in place
// through its block table (no gathered copy), with an online softmax over
// pages, pages at or past `lengths[b] // bs + 1` skipped, keys masked by
// `kpos <= pos`, and `l == 0 -> 1` for fully-masked rows.
//
// What bounds it on the H100: memory. Per (row, kv head) the kernel reads
// G query vectors and the row's active K/V pages once and does
// 4 * G * hd flops per key: well under the ~295 flop/byte ridge of the
// card, so its floor is (active page bytes + q + out) / 3.35 TB/s. At
// decode batch sizes the work is small (a few MB per layer), so launch and
// memory latency dominate.
//
// Design: the TPU grid (B, KV, max_blocks) carried (acc, m, l) in VMEM
// across the sequential page axis; CUDA blocks run in no order, so the page
// axis becomes a loop INSIDE one thread block per (b, kv_head). The block
// loads its own `tables[b, j]` and `lengths[b]` (no scalar prefetch), stages
// one K page and one V page in shared memory as fp32, computes the G x bs
// scores one warp per (g, t) pair, updates the per-head running max and
// denominator, and folds the page into an fp32 accumulator in shared memory.
// The output (G, hd) is written once, in q's dtype. Simple and right first:
// no cp.async/TMA double buffering and no tensor cores yet (the G x bs x hd
// products are tiny); those belong to a later, faster version.
#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::kNegInf;
using repro_torch::to_f32;
using repro_torch::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,          // (B, H, HD)
                       const T* __restrict__ pool,       // (2, N, KV, bs, HD)
                       const int* __restrict__ tables,   // (B, mb)
                       const int* __restrict__ lengths,  // (B,)
                       T* __restrict__ out,              // (B, H, HD)
                       int H, int KV, int N, int bs, int mb, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;  // kv head; query heads h*G .. h*G+G-1
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;             // (G, HD)
  float* acc_s = q_s + G * HD;   // (G, HD)
  float* k_s = acc_s + G * HD;   // (bs, HD)
  float* v_s = k_s + bs * HD;    // (bs, HD)
  float* p_s = v_s + bs * HD;    // (G, bs) scores, then probabilities
  float* m_s = p_s + G * bs;     // (G,) running max
  float* l_s = m_s + G;          // (G,) running denominator
  float* a_s = l_s + G;          // (G,) rescale factor of this page

  const int pos = lengths[b];
  // active pages: ceil((pos + 1) / bs), never past the table's width
  const int nb = min(pos / bs + 1, mb);
  const size_t q_off = ((size_t)b * H + (size_t)h * G) * HD;
  for (int e = tid; e < G * HD; e += kThreads) {
    q_s[e] = to_f32(q[q_off + e]);
    acc_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const size_t page = (size_t)bs * HD;
  const size_t half = (size_t)N * KV * page;  // K pages, then V pages
  for (int j = 0; j < nb; ++j) {
    const int blk = tables[(size_t)b * mb + j];
    const T* kp = pool + ((size_t)blk * KV + h) * page;
    const T* vp = kp + half;
    __syncthreads();  // the previous page is consumed; init is visible
    for (int e = tid; e < bs * HD; e += kThreads) {
      k_s[e] = to_f32(kp[e]);
      v_s[e] = to_f32(vp[e]);
    }
    __syncthreads();
    for (int pr = warp; pr < G * bs; pr += kWarps) {
      const int g = pr / bs;
      const int t = pr - g * bs;
      float d = 0.f;
      for (int i = lane; i < HD; i += 32) d += q_s[g * HD + i] * k_s[t * HD + i];
      d = warp_sum(d);
      if (lane == 0) p_s[pr] = (j * bs + t <= pos) ? d * scale : kNegInf;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      const float m_prev = m_s[g];
      float mx = kNegInf;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, p_s[g * bs + t]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(p_s[g * bs + t] - m_new);
        p_s[g * bs + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[g] = alpha * l_s[g] + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < G * HD; e += kThreads) {
      const int g = e / HD;
      const int d = e - g * HD;
      float a = acc_s[e] * a_s[g];
      for (int t = 0; t < bs; ++t) a += p_s[g * bs + t] * v_s[t * HD + d];
      acc_s[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += kThreads) {
    float l = l_s[e / HD];
    if (l == 0.f) l = 1.f;  // fully-masked rows
    out[q_off + e] = from_f32<T>(acc_s[e] / l);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pool, const void* tables,
                   const void* lengths, void* out, int B, int H, int KV, int N,
                   int bs, int mb, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      (size_t)(2 * G * HD + 2 * bs * HD + G * bs + 3 * G) * sizeof(float);
  auto kern = paged_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, KV, N, bs, mb, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* pool,
                        const void* tables, const void* lengths, void* out,
                        int B, int H, int KV, int N, int bs, int mb,
                        float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, pool, tables, lengths, out, B, H, KV, N, bs, mb, scale, s);
    case 32: return launch<T, 32>(q, pool, tables, lengths, out, B, H, KV, N, bs, mb, scale, s);
    case 64: return launch<T, 64>(q, pool, tables, lengths, out, B, H, KV, N, bs, mb, scale, s);
    case 128: return launch<T, 128>(q, pool, tables, lengths, out, B, H, KV, N, bs, mb, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/paged_attention.py). Returns the
// launch's cudaError_t (0 on success); the wrapper raises on anything else.
extern "C" int repro_paged_attention(int dtype, const void* q,
                                     const void* pool, const void* tables,
                                     const void* lengths, void* out, int B,
                                     int H, int KV, int N, int bs, int hd,
                                     int mb, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || bs <= 0 || mb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro_torch::kBFloat16)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, pool, tables, lengths, out,
                                           B, H, KV, N, bs, mb, scale, s);
  if (dtype == repro_torch::kFloat32)
    return (int)dispatch_hd<float>(hd, q, pool, tables, lengths, out, B, H,
                                   KV, N, bs, mb, scale, s);
  return (int)cudaErrorInvalidValue;
}

// K2: causal / non-causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` (public `flash_attention`) in
// src/repro/kernels/flash_attention.py: q (B, S, H, hd) attends over k/v
// (B, T, KV, hd), query head h reading kv head h // (H / KV), with an fp32
// online softmax over kv tiles. Causal kv tiles wholly above the diagonal
// are pruned (the reference's `_last_kv_block`), which here is simply the
// bound of the kv loop; the output equals the fully masked one. Unlike the
// TPU kernel, which asserts S % bq == T % bk == 0, ragged S and T are
// masked: out-of-range keys score NEG_INF, out-of-range query rows are
// computed on zeros and never stored.
//
// What bounds it on the H100: at the serving engine's window-0 prefill
// shapes (B = 4, S = T = 128, H = 32, hd = 64) the work is 0.27 GFLOP
// against 8.4 MB, so the floor is the bytes, 2.5 us at 3.35 TB/s; the
// kernel lives on latency (loads, the dependent QK^T -> softmax -> PV chain
// of one or two kv tiles) and on instruction count.
//
// Design: bf16 operands (the serving path) run on the tensor cores,
// FlashAttention-2 style. A block of 4 warps owns 64 query rows (16 per
// warp) of one (head, batch); kv tiles are 64 keys. Q, then K/V tiles
// through a 2-stage ring, are copied with 16-byte cp.async (rows past S or T
// zero-filled by the src-size-0 form) into shared memory whose rows are
// padded by 16 bytes, so the 8 rows an ldmatrix reads fall in 8 different
// bank groups. Q's fragments are read once into registers. S = Q K^T is
// mma.sync m16n8k16 bf16 x bf16 -> fp32 (exact products, as the fp32 upcast
// of the TPU kernel), K fragments from ldmatrix. The online softmax stays in
// registers: each row's max and sum need two __shfl_xor_sync within the 4
// lanes that hold it, no score tile in shared memory. P is rounded to bf16
// in registers and fed back as the A operand of P V (the accumulator layout
// of m16n8k16 is its A-fragment layout), V fragments from ldmatrix.trans;
// the O accumulator stays in registers. One barrier per kv tile; the element
// mask runs only on a tile that straddles the diagonal or the end of T, and
// a warp skips the 16-key groups of the diagonal tile that lie wholly above
// its rows. Rounding P to bf16 before P V departs from the TPU kernel, which
// keeps P in fp32; the plain version (kernels/ref.py: flash_attention_ref)
// rounds its probabilities to bf16 the same way. The scores are scaled into
// the exp2 domain (x log2 e) and exponentiated with ex2.approx (relative
// error ~2^-22).
//
// fp32 operands keep an exact CUDA-core path (no TF32: the fp32 CUDA engine
// must emit the CPU engine's greedy tokens): one block of 128 threads per 32
// query rows, fp32 tiles of 32 keys in shared memory, scores and the
// running max / sum in shared memory, expf.
#include "common.cuh"

namespace {

using repro_torch::allow_smem;
using repro_torch::cp_async16;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::kNegInf;
using repro_torch::smem_addr;

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ bf16: mma.sync
constexpr int kBQ = 64;       // query rows per block (4 warps x 16)
constexpr int kBK = 64;       // keys per kv tile
constexpr int kWarps = 4;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
constexpr size_t bf16_smem_bytes() {  // Q, then K and V in two stages each
  return (size_t)(kBQ + 4 * kBK) * (HD + 8) * sizeof(bf16);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_bf16_kernel(const bf16* __restrict__ q,  // (B, S, H, HD)
                            const bf16* __restrict__ k,  // (B, Tk, KV, HD)
                            const bf16* __restrict__ v,  // (B, Tk, KV, HD)
                            bf16* __restrict__ o,        // (B, S, H, HD)
                            int S, int Tk, int H, int KV, int causal,
                            float scale_log2) {
  constexpr int LD = HD + 8;       // padded smem row (elements)
  constexpr int CPR = HD / 8;      // 16-byte chunks per row
  constexpr int KS = HD / 16;      // k-steps of Q K^T
  constexpr int ND = HD / 8;       // 8-wide column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // (BQ, LD)
  bf16* k_s = q_s + kBQ * LD;                     // 2 x (BK, LD)
  bf16* v_s = k_s + 2 * kBK * LD;                 // 2 x (BK, LD)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t q_rs = (size_t)H * HD;   // row strides (elements)
  const size_t kv_rs = (size_t)KV * HD;
  const bf16* qg = q + (size_t)b * S * q_rs + (size_t)h * HD;
  const bf16* kg = k + (size_t)b * Tk * kv_rs + (size_t)kvh * HD;
  const bf16* vg = v + (size_t)b * Tk * kv_rs + (size_t)kvh * HD;
  // every row starts a multiple of 32 bytes past its base, so 16-byte
  // copies need only 16-byte-aligned bases; otherwise plain loads
  const bool vec = ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;

  // rows r0 .. r0 + 63 of src (row stride rs) into dst; rows >= n are zeros
  auto load_tile = [&](bf16* dst, const bf16* src, size_t rs, int r0,
                       int n) {
#pragma unroll
    for (int i = 0; i < kBQ * CPR / (kWarps * 32); ++i) {
      const int c = tid + i * kWarps * 32;
      const int r = c / CPR;
      const int col = (c % CPR) * 8;
      const bool ok = r0 + r < n;
      const bf16* g = src + (size_t)(ok ? r0 + r : 0) * rs + col;
      bf16* s = dst + r * LD + col;
      if (vec) {
        cp_async16(smem_addr(s), g, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e] = ok ? g[e] : __float2bfloat16(0.f);
      }
    }
  };

  const int nk = (Tk + kBK - 1) / kBK;
  int last = nk - 1;
  if (causal) {  // last kv tile holding a position <= the tile's last row
    const int q_end = min(q0 + kBQ, S) - 1;
    last = min(q_end / kBK, nk - 1);
  }
  load_tile(q_s, qg, q_rs, q0, S);
  load_tile(k_s, kg, kv_rs, 0, Tk);
  load_tile(v_s, vg, kv_rs, 0, Tk);
  cp_async_commit();

  const int row_w = q0 + warp * 16;    // this warp's first query row
  const bool live = row_w < S;         // a warp wholly past S only loads
  const int g = lane >> 2;             // fragment row (and row + 8)
  const int t = lane & 3;              // fragment column pair
  uint32_t qf[KS][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;    // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;            // this lane's share of the sums

  for (int kt = 0; kt <= last; ++kt) {
    cp_async_wait<0>();   // this thread's copies of tile kt have landed
    __syncthreads();      // everyone's have; tile kt - 1 is consumed
    if (kt < last) {      // tile kt + 1 into the other stage, overlapping
      const int st = (kt + 1) & 1;
      load_tile(k_s + st * kBK * LD, kg, kv_rs, (kt + 1) * kBK, Tk);
      load_tile(v_s + st * kBK * LD, vg, kv_rs, (kt + 1) * kBK, Tk);
    }
    cp_async_commit();
    if (!live) continue;
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(smem_addr(q_s + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                          (lane >> 4) * 8),
                qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3]);
    }
    const bf16* ks_ = k_s + (kt & 1) * kBK * LD;
    const bf16* vs_ = v_s + (kt & 1) * kBK * LD;
    const int k0 = kt * kBK;
    // 16-key groups this warp needs: on the diagonal tile, those holding
    // a key <= the warp's last row
    int groups = kBK / 16;
    if (causal) groups = min(groups, max(0, (row_w + 15 - k0) / 16 + 1));

    // ---- S = Q K^T: 8 column blocks of 8 keys, fp32
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int np = 0; np < kBK / 16; ++np) {
      if (np >= groups) break;
      // matrices: keys +0..7 / d +0..7, keys +0..7 / d +8..15,
      // keys +8..15 / d +0..7, keys +8..15 / d +8..15
      const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_addr(ks_ + key * LD + ks * 16 + ((lane >> 3) & 1) * 8),
                b0, b1, b2, b3);
        mma_bf16(s[2 * np], qf[ks], b0, b1);
        mma_bf16(s[2 * np + 1], qf[ks], b2, b3);
      }
    }

    // ---- mask (diagonal or ragged tile only), online softmax in registers
    const bool masked = k0 + kBK > Tk || (causal && k0 + kBK - 1 > row_w);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row_w + g + (e >> 1) * 8;
          if (key >= Tk || (causal && key > row)) x = kNegInf;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = ex2(m0 - mn0);
    const float alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = ex2(s[j][0] - mn0);
      s[j][1] = ex2(s[j][1] - mn0);
      s[j][2] = ex2(s[j][2] - mn1);
      s[j][3] = ex2(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // ---- O += P V: P's accumulator fragments are the A fragments
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kk >= groups) break;
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // matrices: keys +0..7 / d +0..7, keys +8..15 / d +0..7,
      // keys +0..7 / d +8..15, keys +8..15 / d +8..15 (transposed)
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(smem_addr(vs_ + key * LD + dp * 16 + (lane >> 4) * 8),
                      b0, b1, b2, b3);
        mma_bf16(acc[2 * dp], a, b0, b1);
        mma_bf16(acc[2 * dp + 1], a, b2, b3);
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;

  float l_0 = quad_sum(l0);
  float l_1 = quad_sum(l1);
  if (l_0 == 0.f) l_0 = 1.f;  // fully-masked rows write 0, as the reference
  if (l_1 == 0.f) l_1 = 1.f;
  const float inv0 = 1.f / l_0;
  const float inv1 = 1.f / l_1;
  const int r0 = row_w + g;
  const int r1 = r0 + 8;
  bf16* o0 = o + ((size_t)b * S + r0) * q_rs + (size_t)h * HD + 2 * t;
  bf16* o1 = o0 + 8 * q_rs;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o0 + 8 * n) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(o1 + 8 * n) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ------------------------------------------------------- fp32: CUDA cores
constexpr int kFBQ = 32;       // query rows per block
constexpr int kFBK = 32;       // keys per kv tile
constexpr int kFThreads = 128;

template <int HD>
constexpr size_t f32_smem_bytes() {
  return (size_t)(kFBQ * (HD + 1) + kFBK * (HD + 1) + kFBK * HD +
                  kFBQ * (kFBK + 1) + 3 * kFBQ) *
         sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kFThreads)
flash_attention_f32_kernel(const float* __restrict__ q,  // (B, S, H, HD)
                           const float* __restrict__ k,  // (B, Tk, KV, HD)
                           const float* __restrict__ v,  // (B, Tk, KV, HD)
                           float* __restrict__ o,        // (B, S, H, HD)
                           int S, int Tk, int H, int KV, int causal,
                           float scale) {
  constexpr int HDP = HD + 1;          // padded smem row stride
  constexpr int SP = kFBK + 1;
  constexpr int ACC = kFBQ * HD / kFThreads;  // accumulator entries / thread
  extern __shared__ float smem[];
  float* q_s = smem;                   // (BQ, HDP)
  float* k_s = q_s + kFBQ * HDP;       // (BK, HDP)
  float* v_s = k_s + kFBK * HDP;       // (BK, HD)
  float* s_s = v_s + kFBK * HD;        // (BQ, SP) scores -> probabilities
  float* m_s = s_s + kFBQ * SP;        // (BQ,) running max
  float* l_s = m_s + kFBQ;             // (BQ,) running denominator
  float* a_s = l_s + kFBQ;             // (BQ,) rescale factor of this tile

  const int q0 = blockIdx.x * kFBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;

  for (int e = tid; e < kFBQ * HD; e += kFThreads) {
    const int r = e / HD;
    const int d = e - r * HD;
    const int s = q0 + r;
    q_s[r * HDP + d] = s < S ? q[(((size_t)b * S + s) * H + h) * HD + d] : 0.f;
  }
  if (tid < kFBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const int nk = (Tk + kFBK - 1) / kFBK;
  int last = nk - 1;
  if (causal) {  // last kv tile holding a position <= the tile's last row
    const int q_end = min(q0 + kFBQ, S) - 1;
    last = min(q_end / kFBK, nk - 1);
  }
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kFBK;
    __syncthreads();  // previous tile consumed; q tile and init visible
    for (int e = tid; e < kFBK * HD; e += kFThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      const int t = k0 + r;
      float kk = 0.f, vv = 0.f;
      if (t < Tk) {
        const size_t off = (((size_t)b * Tk + t) * KV + kvh) * HD + d;
        kk = k[off];
        vv = v[off];
      }
      k_s[r * HDP + d] = kk;
      v_s[r * HD + d] = vv;
    }
    __syncthreads();
    for (int p = tid; p < kFBQ * kFBK; p += kFThreads) {
      const int r = p / kFBK;
      const int c = p - r * kFBK;
      float d = 0.f;
#pragma unroll 16
      for (int i = 0; i < HD; ++i) d += q_s[r * HDP + i] * k_s[c * HDP + i];
      const int qpos = q0 + r;
      const int kpos = k0 + c;
      const bool ok = kpos < Tk && (!causal || qpos >= kpos);
      s_s[r * SP + c] = ok ? d * scale : kNegInf;
    }
    __syncthreads();
    if (tid < kFBQ) {
      float* row = s_s + tid * SP;
      const float m_prev = m_s[tid];
      float mx = kNegInf;
      for (int c = 0; c < kFBK; ++c) mx = fmaxf(mx, row[c]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < kFBK; ++c) {
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
      const int e = tid + i * kFThreads;
      const int r = e / HD;
      const int d = e - r * HD;
      const float* row = s_s + r * SP;
      float a = acc[i] * a_s[r];
#pragma unroll 8
      for (int c = 0; c < kFBK; ++c) a += row[c] * v_s[c * HD + d];
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * kFThreads;
    const int r = e / HD;
    const int d = e - r * HD;
    const int s = q0 + r;
    if (s < S) {
      float l = l_s[r];
      if (l == 0.f) l = 1.f;  // fully-masked rows
      o[(((size_t)b * S + s) * H + h) * HD + d] = acc[i] / l;
    }
  }
}

// ------------------------------------------------------------ launch
template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, int B, int S, int Tk, int H, int KV, int causal,
                   float scale, cudaStream_t stream) {
  if (dtype == repro_torch::kBFloat16) {
    const dim3 grid((S + kBQ - 1) / kBQ, H, B);
    flash_attention_bf16_kernel<HD>
        <<<grid, kWarps * 32, bf16_smem_bytes<HD>(), stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Tk, H, KV,
            causal, scale * kLog2e);
  } else {
    const dim3 grid((S + kFBQ - 1) / kFBQ, H, B);
    flash_attention_f32_kernel<HD>
        <<<grid, kFThreads, f32_smem_bytes<HD>(), stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H,
            KV, causal, scale);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t init_hd() {
  cudaError_t e = allow_smem(flash_attention_bf16_kernel<HD>,
                             bf16_smem_bytes<HD>());
  if (e != cudaSuccess) return e;
  return allow_smem(flash_attention_f32_kernel<HD>, f32_smem_bytes<HD>());
}

}  // namespace

// Opts every instantiation above 48 KB of shared memory in (bf16 hd = 128:
// 87,040 B; fp32 hd = 128: 54,016 B) on the current device. Run once per
// device by kernels/_build.py when it loads the library.
extern "C" int repro_flash_attention_init() {
  cudaError_t e = init_hd<16>();
  if (e == cudaSuccess) e = init_hd<32>();
  if (e == cudaSuccess) e = init_hd<64>();
  if (e == cudaSuccess) e = init_hd<128>();
  return (int)e;
}

// C entry point bound with ctypes (kernels/flash_attention.py). Grid is
// (ceil(S / bq), H, B), bq = 64 for bf16 and 32 for fp32: the reference's
// (B, H, S / bq) with the q-tile axis first, since only gridDim.x may
// exceed 65535. Returns the launch's cudaError_t (0 on success); the
// wrapper raises on anything else.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int Tk, int H, int KV, int hd,
                                     int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 ||
      H > 65535 ||
      (dtype != repro_torch::kBFloat16 && dtype != repro_torch::kFloat32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch<16>(dtype, q, k, v, o, B, S, Tk, H, KV, causal, scale, s);
    case 32: return (int)launch<32>(dtype, q, k, v, o, B, S, Tk, H, KV, causal, scale, s);
    case 64: return (int)launch<64>(dtype, q, k, v, o, B, S, Tk, H, KV, causal, scale, s);
    case 128: return (int)launch<128>(dtype, q, k, v, o, B, S, Tk, H, KV, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

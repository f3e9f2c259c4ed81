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
// decode batch sizes that is a few MB per layer (2.5 us at the serve
// path's shape), so what a kernel meets first is latency: the chain of
// dependent loads and softmax steps of the longest row. A first design
// walked that row's pages one after the other in one block, each page
// behind four barriers and a softmax run by one thread.
//
// Design: the TPU grid (B, KV, max_blocks) carried (acc, m, l) in VMEM
// across the sequential page axis. Here one block of 8 warps serves one
// (row, kv head) and up to GC = 1 or 4 of its G query heads (a third grid
// axis covers the rest of G), one launch per call. A row's pages are cut
// into tiles of 4 warp-wide loads, which never cross a page (16 keys at
// hd = 64 in bf16: one tile per page at bs = 16), and tile i goes to warp
// i % 8, so a long row's pages are spread over the block. Each lane copies
// 16 bytes of a key row at a time (8 bf16 or 4 fp32; hd * size / 16 lanes
// cover a row, so one copy instruction covers 32 * 16 / (hd * size) keys)
// with cp.async into its warp's ring of 3 tiles in shared memory, so up to
// 3 tiles of every warp are in flight at once; keys past the row's end are
// zero-filled. A score is reduced over the lanes of its row only
// (log2(hd * size / 16) shuffles: 3 at hd = 64 in bf16). Every group of
// lanes that shares a key position keeps its own running max, denominator
// and accumulator in registers (fp32), so the page loop needs no shuffle
// for the softmax and no barrier at all. At the end each warp folds its
// lane groups together, the 8 warps' (m, l, acc) meet once in shared
// memory (each warp's ring holds its accumulator then), and the output is
// written once in q's dtype. The block table's first 1,024 entries are
// staged in shared memory while the row's length is read, so a tile's
// copies wait for no global load. No tensor cores: at G = 1 (MHA) an mma
// tile would be 15/16 empty. exp is expf, and every product and sum is
// fp32, so the fp32 path stays exact fp32 arithmetic. The rings take 96 KB
// of dynamic shared memory (two blocks per SM), opted in by
// repro_paged_attention_init, never inside a launch.
#include "common.cuh"

namespace {

using repro_torch::allow_smem;
using repro_torch::cp_async16;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;
using repro_torch::from_f32;
using repro_torch::kNegInf;
using repro_torch::smem_addr;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLoads = 4;       // 16-byte copies of K (and V) per lane per tile
constexpr int kStages = 3;      // tiles a warp keeps in flight
constexpr int kTabCap = 1024;   // block-table entries staged in shared memory
constexpr unsigned kFull = 0xffffffffu;
// one tile of one warp: K and V, kLoads x 32 lanes x 16 bytes each (4 KB
// whatever the dtype and head dim)
constexpr int kTileWords = 2 * kLoads * 32;             // uint4 words
constexpr size_t kSmemBytes = (size_t)kWarps * kStages * kTileWords * 16;

// 16 bytes at p element by element (a view that starts inside its storage,
// which 16-byte copies cannot read)
__device__ __forceinline__ uint4 load16_scalar(const float* p) {
  const unsigned* u = reinterpret_cast<const unsigned*>(p);
  return make_uint4(__ldg(u), __ldg(u + 1), __ldg(u + 2), __ldg(u + 3));
}

__device__ __forceinline__ uint4 load16_scalar(const __nv_bfloat16* p) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (unsigned)__ldg(u + 2 * i) | ((unsigned)__ldg(u + 2 * i + 1) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the 16 bytes as fp32 values (bf16 -> fp32 is exact: the high half)
__device__ __forceinline__ void unpack(uint4 r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(uint4 r, float (&f)[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int HD>
struct Layout {
  static constexpr int V = 16 / (int)sizeof(T);  // values per 16-byte load
  static constexpr int LPK = HD / V;             // lanes per key row
  static constexpr int KPW = 32 / LPK;           // keys per warp-wide load
  static constexpr int TK = kLoads * KPW;        // keys per tile
};

// Where a tile lies: tiles never cross a page, so page j holds tiles
// j * tpp .. j * tpp + tpp - 1 (tpp = ceil(bs / TK)); this lane's keys of
// the tile are its page's keys q0 + i * KPW, i < kLoads, and those below
// `lim` attend (the page's end, or the row's last key).
struct TileAt {
  int j, q0, lim;
  __device__ __forceinline__ TileAt(int tile, int tpp, int tk, int kl, int bs,
                                    int n_keys) {
    j = tpp == 1 ? tile : tile / tpp;
    q0 = (tile - j * tpp) * tk + kl;
    lim = min(bs, n_keys - j * bs);
  }
};

// Start the copies of one tile's K and V rows into a stage of the warp's
// ring: this lane's 16 bytes of its keys to words [kv][i][lane] of the
// stage, i < kLoads. Keys that do not attend are zero-filled and not read.
// `base`: this lane's 16 bytes of block 0's page of head h. `vec`: 16-byte
// cp.async; else element loads, synchronous.
template <typename T, int HD>
__device__ __forceinline__ void issue_tile(
    uint4* stage, const T* base, const int* s_tab, const int* __restrict__ tab,
    const TileAt& at, int lane, size_t page_stride, size_t half, bool vec) {
  using L = Layout<T, HD>;
  const int blk = at.j < kTabCap ? s_tab[at.j] : __ldg(tab + at.j);
  const T* src = base + (size_t)blk * page_stride + at.q0 * HD;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const bool ok = at.q0 + i * L::KPW < at.lim;
    const T* kp = ok ? src + i * L::KPW * HD : base;
    uint4* dk = stage + i * 32 + lane;
    uint4* dv = dk + kLoads * 32;
    if (vec) {
      cp_async16(smem_addr(dk), kp, ok);
      cp_async16(smem_addr(dv), kp + half, ok);
    } else {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *dk = ok ? load16_scalar(kp) : z;
      *dv = ok ? load16_scalar(kp + half) : z;
    }
  }
}

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads, GC == 1 ? 2 : 1)
paged_attention_kernel(const T* __restrict__ q,          // (B, H, HD)
                       const T* __restrict__ pool,       // (2, N, KV, bs, HD)
                       const int* __restrict__ tables,   // (B, mb)
                       const int* __restrict__ lengths,  // (B,)
                       T* __restrict__ out,              // (B, H, HD)
                       int H, int KV, int N, int bs, int mb, float scale,
                       bool vec) {
  using L = Layout<T, HD>;
  constexpr int V = L::V;
  constexpr int LPK = L::LPK;
  static_assert(GC * HD <= kStages * kTileWords * 4, "merge fits the ring");
  // each warp's ring of kStages tiles; after the page loop, the warp's
  // accumulator (GC, HD) for the merge
  extern __shared__ uint4 ring_all[];
  __shared__ float m_s[kWarps][GC];
  __shared__ float l_s[kWarps][GC];
  __shared__ float w_s[kWarps][GC];
  __shared__ int s_tab[kTabCap];

  const int b = blockIdx.x;
  const int h = blockIdx.y;               // kv head
  const int G = H / KV;
  const int g0 = blockIdx.z * GC;         // first query head of this block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPK;             // which 16 bytes of a row
  const int kl = lane / LPK;              // which key of a warp-wide load
  uint4* ring = ring_all + (size_t)warp * kStages * kTileWords;

  // the row's length and its block table, read side by side (the table up
  // to its width or kTabCap entries, whatever the length)
  const int* tab = tables + (size_t)b * mb;
  for (int j = threadIdx.x; j < min(mb, kTabCap); j += kThreads)
    s_tab[j] = tab[j];
  const int pos = lengths[b];
  // keys 0..pos of the row's first mb pages (pages past pos // bs + 1 and
  // past the table's width are skipped)
  const int n_keys = min(pos + 1, mb * bs);
  const int tpp = (bs + L::TK - 1) / L::TK;   // tiles per page
  const int n_tiles = n_keys > 0 ? (n_keys + bs - 1) / bs * tpp : 0;

  float qf[GC][V];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g0 + g < G) {
      const T* qp = q + ((size_t)b * H + (size_t)h * G + g0 + g) * HD;
      unpack(vec ? __ldg(reinterpret_cast<const uint4*>(qp + sub * V))
                 : load16_scalar(qp + sub * V),
             qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) qf[g][e] = 0.f;
    }
  }
  float m[GC], l[GC], acc[GC][V];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }
  __syncthreads();  // s_tab is filled (the only barrier before the merge)

  // the warp's first kStages tiles go in flight at once; one copy group per
  // tile, committed even when empty, so group i is always tile i's
  const size_t page_stride = (size_t)KV * bs * HD;  // one block's pages
  const size_t half = (size_t)N * page_stride;      // K pages, then V pages
  const T* base = pool + (size_t)h * bs * HD + sub * V;
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    const int tile = warp + st * kWarps;
    if (tile < n_tiles)
      issue_tile<T, HD>(ring + st * kTileWords, base, s_tab, tab,
                        TileAt(tile, tpp, L::TK, kl, bs, n_keys), lane,
                        page_stride, half, vec);
    cp_async_commit();
  }
  int st = 0;
  for (int tile = warp; tile < n_tiles; tile += kWarps) {
    cp_async_wait<kStages - 1>();   // this tile's group has landed
    const TileAt at(tile, tpp, L::TK, kl, bs, n_keys);
    const uint4* kt = ring + st * kTileWords + lane;
    const uint4* vt = kt + kLoads * 32;
    float s[GC][kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      float kf[V];
      unpack(kt[i * 32], kf);
      const bool ok = at.q0 + i * L::KPW < at.lim;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1) d += __shfl_xor_sync(kFull, d, o);
        s[g][i] = ok ? d * scale : kNegInf;
      }
    }
    // online softmax of this lane group's keys, in registers
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = m[g];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) mx = fmaxf(mx, s[g][i]);
      const float alpha = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const bool ok = at.q0 + i * L::KPW < at.lim;
        s[g][i] = ok ? expf(s[g][i] - mx) : 0.f;
        l[g] += s[g][i];
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      float vf[V];
      unpack(vt[i * 32], vf);
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] = fmaf(s[g][i], vf[e], acc[g][e]);
    }
    // the stage is consumed (its values are in registers): refill it with
    // the tile kStages rounds ahead, if the row has one
    const int next = tile + kStages * kWarps;
    if (next < n_tiles)
      issue_tile<T, HD>(ring + st * kTileWords, base, s_tab, tab,
                        TileAt(next, tpp, L::TK, kl, bs, n_keys), lane,
                        page_stride, half, vec);
    cp_async_commit();
    st = st + 1 == kStages ? 0 : st + 1;
  }
  cp_async_wait<0>();  // no copy still lands in the ring reused below

  // fold the warp's lane groups (lanes with the same `sub` hold partials
  // over different keys), then the warps, through shared memory
  float* acc_w = reinterpret_cast<float*>(ring);   // (GC, HD)
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    float mw = m[g];
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(kFull, mw, o));
    const float f = expf(m[g] - mw);
    float lw = l[g] * f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] *= f;
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
      lw += __shfl_xor_sync(kFull, lw, o);
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], o);
    }
    if (lane < LPK) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc_w[g * HD + lane * V + e] = acc[g][e];
    }
    if (lane == 0) {
      m_s[warp][g] = mw;
      l_s[warp][g] = lw;
    }
  }
  __syncthreads();
  // each query head's weight of each warp, exp(m_w - m) / l, once
  if (threadIdx.x < kWarps * GC) {
    const int w = threadIdx.x / GC;
    const int g = threadIdx.x % GC;
    float mx = kNegInf;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, m_s[v][g]);
    float lsum = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      lsum = fmaf(expf(m_s[v][g] - mx), l_s[v][g], lsum);
    if (lsum == 0.f) lsum = 1.f;  // fully-masked rows
    w_s[w][g] = expf(m_s[w][g] - mx) / lsum;
  }
  __syncthreads();
  const float* acc_all = reinterpret_cast<const float*>(ring_all);
  constexpr int kWarpFloats = kStages * kTileWords * 4;
  for (int e = threadIdx.x; e < GC * HD; e += kThreads) {
    const int g = e / HD;
    if (g0 + g >= G) continue;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      o = fmaf(w_s[w][g], acc_all[w * kWarpFloats + e], o);
    out[((size_t)b * H + (size_t)h * G + g0) * HD + e] = from_f32<T>(o);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pool, const void* tables,
                   const void* lengths, void* out, int B, int H, int KV, int N,
                   int bs, int mb, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const bool vec = ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(pool)) & 15) == 0;
  const T* qp = static_cast<const T*>(q);
  const T* pp = static_cast<const T*>(pool);
  const int* tp = static_cast<const int*>(tables);
  const int* lp = static_cast<const int*>(lengths);
  T* op = static_cast<T*>(out);
  if (G == 1) {
    paged_attention_kernel<T, HD, 1>
        <<<dim3(B, KV, 1), kThreads, kSmemBytes, stream>>>(
            qp, pp, tp, lp, op, H, KV, N, bs, mb, scale, vec);
  } else {
    constexpr int GC = 4;
    paged_attention_kernel<T, HD, GC>
        <<<dim3(B, KV, (G + GC - 1) / GC), kThreads, kSmemBytes, stream>>>(
            qp, pp, tp, lp, op, H, KV, N, bs, mb, scale, vec);
  }
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t init_hd() {
  cudaError_t e = allow_smem(paged_attention_kernel<T, HD, 1>, kSmemBytes);
  if (e != cudaSuccess) return e;
  return allow_smem(paged_attention_kernel<T, HD, 4>, kSmemBytes);
}

template <typename T>
cudaError_t init_type() {
  cudaError_t e = init_hd<T, 16>();
  if (e == cudaSuccess) e = init_hd<T, 32>();
  if (e == cudaSuccess) e = init_hd<T, 64>();
  if (e == cudaSuccess) e = init_hd<T, 128>();
  return e;
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

// Opt every instantiation in to its 96 KB ring of dynamic shared memory;
// kernels/_build.py runs this once per device before any launch.
extern "C" int repro_paged_attention_init() {
  cudaError_t e = init_type<__nv_bfloat16>();
  if (e == cudaSuccess) e = init_type<float>();
  return (int)e;
}

// C entry point bound with ctypes (kernels/paged_attention.py). Returns the
// launch's cudaError_t (0 on success); the wrapper raises on anything else.
extern "C" int repro_paged_attention(int dtype, const void* q,
                                     const void* pool, const void* tables,
                                     const void* lengths, void* out, int B,
                                     int H, int KV, int N, int bs, int hd,
                                     int mb, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || KV > 65535 || H % KV != 0 || H / KV > 4 * 65535 ||
      bs <= 0 || mb <= 0)
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

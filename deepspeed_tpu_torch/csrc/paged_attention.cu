// Paged attention over the serving layer's shared KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/transformer/paged_attention.py:
//   paged_attention_online      <- _online_kernel (paged_attention.py:180-272, via _online_call 275-318)
//   paged_attention_exact_sm90  <- _exact_kernel  (paged_attention.py:90-132,  via _exact_call  135-176)
//   paged_attention_exact       <- the same: the first design of it, kept as the yardstick
//
// All compute, for every slot b, head h and window row w (W <= 8 query tokens per slot),
// masked attention of q[b, w, h, :] over the slot's cached keys at positions
// k_pos <= lengths[b] + w, reading K/V blocks straight from the pool through the slot's
// block-table row (no gathered copy).  Layouts (one layer's slice of the pool):
//   q, out     (B, W, H, HD)              compute dtype T (fp32 | bf16 | fp16)
//   k, v       (num_blocks, bs, H, HD)    T, or int8 payloads
//   k/v scales (num_blocks, bs, H, HD/qb) fp32 (int8 pools only)
//   tables     (B, nb_max) int32, lengths (B,) int32
//
// What bounds them on this card: KV bytes.  A decode step reads every live K/V row once
// and does 4·HD flops per row per window row -- about 2 flops per byte at W = 1, far
// below the ~295 flops/byte where the H100's compute would become the limit.  So the
// design spends nothing on tensor cores and everything on reading each live row once:
//   * the grid is (B, H); one block walks only the slot's live rows, min(len + W, S),
//     through its table row -- rows past the window's last position are never read;
//   * each K/V row of one head (HD contiguous elements, 128 B at bf16 and HD = 64) is read
//     by HD/8 neighbouring lanes with one 16-byte vector load each (8 bytes for int8),
//     so a warp reads whole rows with coalesced transactions;
//   * int8 pools are dequantized in registers from the fp32 scales with
//     dequantize_blockwise's formula (float(q) * scale, rounded to the compute dtype),
//     so an int8 pool moves half the bytes of a bf16 one;
//   * the 32 row groups of a block (8 lanes each at HD = 64) walk disjoint rows in
//     parallel, each with its own running max / denominator / accumulator in fp32, and
//     merge at the end (warp shuffles, then shared memory): blocks carry no state from one
//     another, unlike the TPU grid, which ran the slots in order.
// (The online kernel: later work, wgmma, TMA, a split across blocks for long contexts, is not
// done here.)
//
// The exact kernels mirror GPT2._masked_attend op for op: score rounded to the compute
// dtype, then fp32, divided by sqrt(HD), masked with finfo(float32).min, full-row softmax
// (the full row's max, and its full sum before the division), probabilities rounded to
// the compute dtype before AV.  The online kernel mirrors _online_kernel: fp32 scores
// multiplied by 1/sqrt(HD), online softmax, probabilities rounded to the compute dtype
// only for AV.
//
// paged_attention_exact (exact_kernel, the first design) gives each (b, h) one block of 256
// threads that walks the slot's rows in three serial passes (scores into a full score row
// in shared memory, W * S * 4 bytes; the softmax; AV), each row group loading one row per
// iteration: a (B, H) grid of such blocks keeps a few KB in flight per SM and waits on one
// load round trip after another, so it is bound by latency, not by the bytes.
//
// paged_attention_exact_sm90 (exact_split_kernel) splits each (b, h) over a thread-block
// cluster of C blocks (C <= 8, the portable limit; chosen on the host from S alone, so the
// launch reads no device value and allocates nothing): rank r takes the contiguous live rows
// [r c, min((r + 1) c, n_rows)), c = ceil(n_rows / C), n_rows = min(len + W, S).  A rank
// issues every K and V row of its chunk up front with 16-byte cp.async copies into shared
// memory (with the int8 scales), so V is in flight while the scores and the softmax run and
// a rank waits on one load round trip, not one per row.  The slot's block-table row is read
// beside lengths[b] and the queries, before any K/V address is formed.  The row max and the
// row sum are reduced over the cluster through distributed shared memory: each rank stores its
// partial into every peer's shared memory (stores, no round trip), and after a cluster barrier
// each combines them in rank order, so every rank divides by the full row's sum; each rank
// forms its rows' P = round(e / sum) and its partial AV in fp32 and stores each output's
// partial into the rank that writes it, which sums them in rank order after a third barrier.
// No rank reads a peer's shared memory, so none waits for its peers before it exits.  One
// launch a call, no global scratch and no atomics; only the order of the fp32 sums differs
// from exact_kernel.  A chunk longer than the staging buffer (R rows, a fixed budget) streams
// its K rows, then its V rows, through it in pieces.
//
// C interface for ctypes: each entry returns cudaGetLastError() after the launch
// (0 on success), or -1 for a combination of dtype / head dim it was not built for.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEpt = 8;           // elements of a row each lane owns
constexpr int kMaxW = 8;          // largest query window
constexpr float kMaskValue = -FLT_MAX;   // finfo(float32).min, the oracle's mask

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* lengths;
  void* out;
  int W, H, bs, nb_max, num_blocks, n_scales, scale_attn;
  float sm_scale;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to the compute dtype T and read back as fp32 (an astype round trip)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// kEpt contiguous elements of P at src -> fp32, with 16-byte (or 8-byte) vector loads, from
// global memory through the read-only path or (kShared) from shared memory
template <typename P, bool kShared = false>
__device__ __forceinline__ void load_vec(const P* __restrict__ src, float (&out)[kEpt]) {
  constexpr int kBytes = kEpt * static_cast<int>(sizeof(P));
  static_assert(kBytes % 8 == 0, "a lane's slice must be a multiple of 8 bytes");
  if constexpr (kBytes % 16 == 0) {
    uint4 buf[kBytes / 16];
    const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) buf[i] = kShared ? v[i] : __ldg(v + i);
    const P* e = reinterpret_cast<const P*>(buf);
#pragma unroll
    for (int j = 0; j < kEpt; ++j) out[j] = to_f<P>(e[j]);
  } else {
    uint2 buf[kBytes / 8];
    const uint2* v = reinterpret_cast<const uint2*>(src);
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i) buf[i] = kShared ? v[i] : __ldg(v + i);
    const P* e = reinterpret_cast<const P*>(buf);
#pragma unroll
    for (int j = 0; j < kEpt; ++j) out[j] = to_f<P>(e[j]);
  }
}

// One lane's slice of pool row `row` (block * bs + offset, head h folded in), read as the
// attention compute dtype T: 16-bit pools as they are, int8 pools through the block scales.
template <typename T, typename P, int HD>
__device__ __forceinline__ void load_kv(const P* __restrict__ pool, const float* __restrict__ scale,
                                        size_t row, int d0, int n_scales, float (&out)[kEpt]) {
  load_vec<P>(pool + row * HD + d0, out);
  if constexpr (std::is_same<P, int8_t>::value) {
    const float* s = scale + row * n_scales;
    const int qb = HD / n_scales;
#pragma unroll
    for (int j = 0; j < kEpt; ++j) out[j] = round_to<T>(out[j] * __ldg(s + (d0 + j) / qb));
  }
}

// Sum over the lanes of one row group (kLanes neighbouring lanes, a power of two <= 32).
template <int kLanes>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Pool row index of position r of slot b (head h folded in).  A block id outside the
// pool is clamped into it, as the gather oracle's clamped jnp indexing does, so a bad
// table never reads outside the pool.
__device__ __forceinline__ size_t pool_row(const Args& a, int b, int h, int r) {
  const int j = r / a.bs;
  const int blk =
      min(max(__ldg(a.tables + static_cast<size_t>(b) * a.nb_max + j), 0), a.num_blocks - 1);
  return (static_cast<size_t>(blk) * a.bs + (r - j * a.bs)) * a.H + h;
}

// ------------------------------------------------------------------------ online kernel
template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kThreads) online_kernel(Args a) {
  constexpr int kLanes = HD / kEpt;              // lanes per row
  constexpr int kGroups = kThreads / kLanes;     // rows in flight per block
  __shared__ float red_m[kWarps][kMaxW];
  __shared__ float red_l[kWarps][kMaxW];
  __shared__ float red_acc[kWarps][kMaxW][HD];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = tid / kLanes, d0 = (tid % kLanes) * kEpt;
  const int W = a.W;
  const int len = __ldg(a.lengths + b);
  const int n_rows = min(len + W, a.nb_max * a.bs);
  const T* q = static_cast<const T*>(a.q);
  const P* kp = static_cast<const P*>(a.k);
  const P* vp = static_cast<const P*>(a.v);

  float qr[kMaxW][kEpt];
  float m[kMaxW], l[kMaxW], acc[kMaxW][kEpt];
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) {
    m[w] = -INFINITY;
    l[w] = 0.f;
#pragma unroll
    for (int j = 0; j < kEpt; ++j) acc[w][j] = 0.f;
    if (w < W) load_vec<T>(q + ((static_cast<size_t>(b) * W + w) * a.H + h) * HD + d0, qr[w]);
  }

  // uniform trip count across the block: the group shuffles need every lane
  for (int r0 = 0; r0 < n_rows; r0 += kGroups) {
    const int r = r0 + group;
    const bool live = r < n_rows;
    float kr[kEpt], vr[kEpt];
    if (live) {
      const size_t row = pool_row(a, b, h, r);
      load_kv<T, P, HD>(kp, a.k_scale, row, d0, a.n_scales, kr);
      load_kv<T, P, HD>(vp, a.v_scale, row, d0, a.n_scales, vr);
    } else {
#pragma unroll
      for (int j = 0; j < kEpt; ++j) kr[j] = vr[j] = 0.f;
    }
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
      if (w >= W) break;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kEpt; ++j) s = fmaf(qr[w][j], kr[j], s);
      s = group_sum<kLanes>(s) * a.sm_scale;
      if (live && r <= len + w) {
        const float m_new = fmaxf(m[w], s);
        const float alpha = expf(m[w] - m_new);      // 0 while m is still -inf
        const float p = expf(s - m_new);
        const float pv = round_to<T>(p);              // p.astype(compute) for AV only
        l[w] = l[w] * alpha + p;
#pragma unroll
        for (int j = 0; j < kEpt; ++j) acc[w][j] = fmaf(pv, vr[j], acc[w][j] * alpha);
        m[w] = m_new;
      }
    }
  }

  // merge the row groups of each warp (groups that saw no live row hold m = -inf)
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
      if (w >= W) break;
      const float mo = __shfl_xor_sync(0xffffffffu, m[w], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[w], off);
      const float mn = fmaxf(m[w], mo);
      const float fa = m[w] == -INFINITY ? 0.f : expf(m[w] - mn);
      const float fb = mo == -INFINITY ? 0.f : expf(mo - mn);
      l[w] = l[w] * fa + lo * fb;
#pragma unroll
      for (int j = 0; j < kEpt; ++j) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[w][j], off);
        acc[w][j] = acc[w][j] * fa + ao * fb;
      }
      m[w] = mn;
    }
  }
  if (lane < kLanes) {
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
      if (w >= W) break;
#pragma unroll
      for (int j = 0; j < kEpt; ++j) red_acc[warp][w][d0 + j] = acc[w][j];
      if (lane == 0) {
        red_m[warp][w] = m[w];
        red_l[warp][w] = l[w];
      }
    }
  }
  __syncthreads();

  // merge the warps; row 0 is live for every window row, so some warp has a finite max
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < W * HD; i += kThreads) {
    const int w = i / HD, d = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) mx = fmaxf(mx, red_m[k][w]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const float mk = red_m[k][w];
      const float f = mk == -INFINITY ? 0.f : expf(mk - mx);
      lsum += red_l[k][w] * f;
      osum += red_acc[k][w][d] * f;
    }
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    out[((static_cast<size_t>(b) * W + w) * a.H + h) * HD + d] = from_f<T>(osum / l_safe);
  }
}

// ------------------------------------------------------------------------- exact kernel
// Dynamic shared memory: scores [W][S] fp32, then the AV reduction [kWarps][kMaxW][HD].
template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kThreads) exact_kernel(Args a) {
  constexpr int kLanes = HD / kEpt;
  constexpr int kGroups = kThreads / kLanes;
  extern __shared__ float smem[];
  __shared__ float red[kWarps][kMaxW];
  __shared__ float row_max[kMaxW], row_sum[kMaxW];

  const int S = a.nb_max * a.bs;
  float* sc = smem;
  float* red_acc = smem + static_cast<size_t>(a.W) * S;
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = tid / kLanes, sub = tid % kLanes, d0 = sub * kEpt;
  const int W = a.W;
  const int len = __ldg(a.lengths + b);
  // rows past the window's last position are masked for every window row: their
  // exp(finfo.min - max) is exactly 0, so they are neither read nor scored
  const int n_rows = min(len + W, S);
  const T* q = static_cast<const T*>(a.q);
  const P* kp = static_cast<const P*>(a.k);
  const P* vp = static_cast<const P*>(a.v);
  const float root = sqrtf(static_cast<float>(HD));

  float qr[kMaxW][kEpt];
#pragma unroll
  for (int w = 0; w < kMaxW; ++w)
    if (w < W) load_vec<T>(q + ((static_cast<size_t>(b) * W + w) * a.H + h) * HD + d0, qr[w]);

  // 1. scores, as _masked_attend forms them
  for (int r0 = 0; r0 < n_rows; r0 += kGroups) {
    const int r = r0 + group;
    const bool live = r < n_rows;
    float kr[kEpt];
    if (live) {
      load_kv<T, P, HD>(kp, a.k_scale, pool_row(a, b, h, r), d0, a.n_scales, kr);
    } else {
#pragma unroll
      for (int j = 0; j < kEpt; ++j) kr[j] = 0.f;
    }
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
      if (w >= W) break;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kEpt; ++j) s = fmaf(qr[w][j], kr[j], s);
      s = group_sum<kLanes>(s);
      if (live && sub == 0) {
        float sv = round_to<T>(s);                 // einsum result in the input dtype
        if (a.scale_attn) sv = sv / root;
        sc[static_cast<size_t>(w) * S + r] = r <= len + w ? sv : kMaskValue;
      }
    }
  }
  __syncthreads();

  // 2. full-row softmax per window row: max, exp, sum, divide, round to T
  float lmax[kMaxW];
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) {
    lmax[w] = -INFINITY;
    if (w < W)
      for (int r = tid; r < n_rows; r += kThreads) lmax[w] = fmaxf(lmax[w], sc[w * S + r]);
  }
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) {
    if (w >= W) break;
    float x = lmax[w];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    if (lane == 0) red[warp][w] = x;
  }
  __syncthreads();
  if (tid < W) {
    float x = -INFINITY;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) x = fmaxf(x, red[k][tid]);
    row_max[tid] = x;
  }
  __syncthreads();
  float lsum[kMaxW];
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) {
    lsum[w] = 0.f;
    if (w < W) {
      const float mx = row_max[w];
      for (int r = tid; r < n_rows; r += kThreads) {
        const float e = expf(sc[w * S + r] - mx);
        sc[w * S + r] = e;
        lsum[w] += e;
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) {
    if (w >= W) break;
    float x = lsum[w];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][w] = x;
  }
  __syncthreads();
  if (tid < W) {
    float x = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) x += red[k][tid];
    row_sum[tid] = x;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) {
    if (w >= W) break;
    const float sum = row_sum[w];
    for (int r = tid; r < n_rows; r += kThreads)
      sc[w * S + r] = round_to<T>(sc[w * S + r] / sum);
  }
  __syncthreads();

  // 3. AV with fp32 accumulation, rounded to T at the end
  float acc[kMaxW][kEpt];
#pragma unroll
  for (int w = 0; w < kMaxW; ++w)
#pragma unroll
    for (int j = 0; j < kEpt; ++j) acc[w][j] = 0.f;
  for (int r = group; r < n_rows; r += kGroups) {
    float vr[kEpt];
    load_kv<T, P, HD>(vp, a.v_scale, pool_row(a, b, h, r), d0, a.n_scales, vr);
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
      if (w >= W) break;
      const float p = sc[w * S + r];
#pragma unroll
      for (int j = 0; j < kEpt; ++j) acc[w][j] = fmaf(p, vr[j], acc[w][j]);
    }
  }
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1)
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
      if (w >= W) break;
#pragma unroll
      for (int j = 0; j < kEpt; ++j) acc[w][j] += __shfl_xor_sync(0xffffffffu, acc[w][j], off);
    }
  if (lane < kLanes) {
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
      if (w >= W) break;
#pragma unroll
      for (int j = 0; j < kEpt; ++j) red_acc[(warp * kMaxW + w) * HD + d0 + j] = acc[w][j];
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < W * HD; i += kThreads) {
    const int w = i / HD, d = i % HD;
    float o = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) o += red_acc[(k * kMaxW + w) * HD + d];
    out[((static_cast<size_t>(b) * W + w) * a.H + h) * HD + d] = from_f<T>(o);
  }
}

// ------------------------------------------------------------ exact kernel, cluster split
constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kMaxRanks = 8;          // the portable cluster size
constexpr int kRankRows = 128;        // S / kRankRows ranks, at most kMaxRanks
constexpr int kStageBytes = 24576;    // K + V rows (and their scales) staged at once

// The split of one launch, from the shapes alone: C ranks a (b, h); cap = ceil(S / C), the
// most rows a rank takes (the stride of its score rows); R <= cap rows staged at once
struct Split {
  int C, cap, R;
};

__host__ __device__ __forceinline__ int round16(int bytes) { return (bytes + 15) & ~15; }

// Byte offsets of the dynamic shared memory of exact_split_kernel: the K staging rows (after
// the scores, the AV reduction), the V staging rows, the int8 scales of both, the score rows
// [W][cap], the slot's block-table row and the inbox of partial O's [C][per] (per = ceil(W HD /
// C): rank r's partial of the outputs this rank writes, stored there by rank r)
struct SplitLayout {
  int k, v, ks, vs, sc, tab, po, total;
};

__host__ __device__ __forceinline__ int split_per(int C, int W, int HD) {
  return (W * HD + C - 1) / C;
}

__host__ __device__ __forceinline__ SplitLayout split_layout(const Split& sp, int W, int HD,
                                                             int elem, int n_scales, int nb_max) {
  SplitLayout L;
  const int rows = sp.R * HD * elem;
  const int scales = n_scales > 0 ? round16(sp.R * n_scales * 4) : 0;
  const int red = (kSplitThreads / (HD / kEpt)) * HD * 4;   // row groups x HD floats
  L.k = 0;
  L.v = round16(rows > red ? rows : red);
  L.ks = L.v + round16(rows);
  L.vs = L.ks + scales;
  L.sc = L.vs + scales;
  L.tab = L.sc + round16(W * sp.cap * 4);
  L.po = L.tab + round16(nb_max * 4);
  L.total = L.po + sp.C * split_per(sp.C, W, HD) * 4;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

// v stored at `at` in the shared memory of each of the cluster's C ranks (distributed shared
// memory: stores, no round trip); a cluster.sync() makes them visible
__device__ __forceinline__ void push(cg::cluster_group cluster, float* at, float v, int C) {
#pragma unroll
  for (int r = 0; r < kMaxRanks; ++r)
    if (r < C) *cluster.map_shared_rank(at, r) = v;
}

// The C ranks' values v[0], v[stride], ... (rank r's at v[r stride]) combined in rank order:
// op(...op(init, v0)..., v(C-1))
template <typename Op>
__device__ __forceinline__ float in_rank_order(const float* v, int stride, int C, float init,
                                               Op op) {
  float acc = init;
#pragma unroll
  for (int r = 0; r < kMaxRanks; ++r)
    if (r < C) acc = op(acc, v[r * stride]);
  return acc;
}

// Grid (B, H, C), clusters of (1, 1, C): cluster rank r of (b, h) = (blockIdx.x, blockIdx.y).
// A thread belongs to row group gi = tid / kLanes (kLanes lanes of kEpt elements span a row);
// groups w G .. w G + G - 1 (G = kGroups / W) take window row w in the scores and in AV.
template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kSplitThreads) exact_split_kernel(Args a, Split sp) {
  constexpr int kLanes = HD / kEpt;
  constexpr int kGroups = kSplitThreads / kLanes;
  constexpr int kRowBytes = HD * static_cast<int>(sizeof(P));
  constexpr int kPieces = kRowBytes / 16;             // 16-byte copies a row
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  static_assert(kRowBytes % 16 == 0, "a pool row must be a whole number of 16-byte copies");
  static_assert(kGroups >= kMaxW, "every window row needs a row group (G = kGroups / W >= 1)");
  extern __shared__ __align__(16) unsigned char split_smem[];
  __shared__ float red[kSplitWarps][kMaxW];
  // the ranks' partial row max and row sum ([rank][window row]), each stored by its rank
  __shared__ float rank_max[kMaxRanks][kMaxW], rank_sum[kMaxRanks][kMaxW];
  __shared__ float row_max[kMaxW], row_sum[kMaxW];    // the cluster's

  cg::cluster_group cluster = cg::this_cluster();
  const int C = sp.C, rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = a.W, S = a.nb_max * a.bs, ns = kQuant ? a.n_scales : 0;
  const SplitLayout L = split_layout(sp, W, HD, static_cast<int>(sizeof(P)), ns, a.nb_max);
  P* sK = reinterpret_cast<P*>(split_smem + L.k);
  P* sV = reinterpret_cast<P*>(split_smem + L.v);
  float* sKs = reinterpret_cast<float*>(split_smem + L.ks);
  float* sVs = reinterpret_cast<float*>(split_smem + L.vs);
  float* sc = reinterpret_cast<float*>(split_smem + L.sc);
  int* tab = reinterpret_cast<int*>(split_smem + L.tab);
  float* inbox = reinterpret_cast<float*>(split_smem + L.po);
  float* red_acc = reinterpret_cast<float*>(split_smem + L.k);   // [kGroups][HD], after the scores

  const int gi = tid / kLanes, sub = tid % kLanes, d0 = sub * kEpt;
  const int G = kGroups / W;
  const int w = gi / G, g = gi - w * G;
  const bool active = w < W;       // groups past G W take no window row
  const T* q = static_cast<const T*>(a.q);
  const P* kp = static_cast<const P*>(a.k);
  const P* vp = static_cast<const P*>(a.v);
  const float root = sqrtf(static_cast<float>(HD));

  // arrive on the cluster barrier now and wait before the first store into a peer's shared
  // memory (after the scores): a peer is then known to be running
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the queries, lengths[b] and the slot's block-table row: independent loads, issued together
  float qr[kEpt];
  if (active) {
    load_vec<T>(q + ((static_cast<size_t>(b) * W + w) * a.H + h) * HD + d0, qr);
  } else {
#pragma unroll
    for (int j = 0; j < kEpt; ++j) qr[j] = 0.f;
  }
  const int len = __ldg(a.lengths + b);
  // a block id outside the pool is clamped into it, as the gather oracle's clamped indexing
  for (int t = tid; t < a.nb_max; t += kSplitThreads)
    tab[t] = min(max(__ldg(a.tables + static_cast<size_t>(b) * a.nb_max + t), 0),
                 a.num_blocks - 1);
  __syncthreads();

  // this rank's rows: rows past the window's last position are masked for every window row
  // (their exp(finfo.min - max) is exactly 0), so they are neither read nor scored
  const int n_rows = max(min(len + W, S), 0);
  const int c = (n_rows + C - 1) / C;
  const int r0 = min(rank * c, n_rows);
  const int nr = min(r0 + c, n_rows) - r0;
  const bool single = nr <= sp.R;  // the chunk's K and V rows fit the staging buffer at once

  // rows s0 .. s0 + n - 1 of the chunk (and their scales) into dst, 16 bytes a copy
  auto stage = [&](P* dst, float* dst_s, const P* pool, const float* scale, int s0, int n) {
    for (int p = tid; p < n * kPieces; p += kSplitThreads) {
      const int i = p / kPieces, x = p - i * kPieces, r = r0 + s0 + i, j = r / a.bs;
      const size_t row = (static_cast<size_t>(tab[j]) * a.bs + (r - j * a.bs)) * a.H + h;
      cp_async16(reinterpret_cast<unsigned char*>(dst) + i * kRowBytes + x * 16,
                 reinterpret_cast<const unsigned char*>(pool + row * HD) + x * 16);
    }
    if constexpr (kQuant) {
      for (int p = tid; p < n * ns; p += kSplitThreads) {
        const int i = p / ns, x = p - i * ns, r = r0 + s0 + i, j = r / a.bs;
        const size_t row = (static_cast<size_t>(tab[j]) * a.bs + (r - j * a.bs)) * a.H + h;
        cp_async4(dst_s + i * ns + x, scale + row * ns + x);
      }
    }
  };
  // one lane's slice of staged row i as the compute dtype T (int8: through its scales, with
  // dequantize_blockwise's formula)
  int sj[kQuant ? kEpt : 1];       // the scale of each of this lane's elements (int8)
  if constexpr (kQuant) {
#pragma unroll
    for (int j = 0; j < kEpt; ++j) sj[j] = (d0 + j) / (HD / ns);
  }
  auto staged = [&](const P* rows, const float* scales, int i, float (&out)[kEpt]) {
    load_vec<P, true>(rows + i * HD + d0, out);
    if constexpr (kQuant) {
      const float* s = scales + i * ns;
#pragma unroll
      for (int j = 0; j < kEpt; ++j) out[j] = round_to<T>(out[j] * s[sj[j]]);
    }
  };

  // 1. scores, as _masked_attend forms them; with a single piece, V's copies go out with K's
  for (int s0 = 0; s0 < nr; s0 += sp.R) {
    const int n = min(sp.R, nr - s0);
    if (s0 > 0) __syncthreads();   // the previous piece's K rows are read
    stage(sK, sKs, kp, a.k_scale, s0, n);
    cp_async_commit();
    if (single) {
      stage(sV, sVs, vp, a.v_scale, 0, n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // a trip count uniform over the block: the group sums shuffle across every lane
    for (int i0 = 0; i0 < n; i0 += G) {
      const int i = i0 + g;
      const bool live = active && i < n;
      float kr[kEpt];
      if (live) {
        staged(sK, sKs, i, kr);
      } else {
#pragma unroll
        for (int j = 0; j < kEpt; ++j) kr[j] = 0.f;
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kEpt; ++j) s = fmaf(qr[j], kr[j], s);
      s = group_sum<kLanes>(s);
      if (live && sub == 0) sc[w * sp.cap + s0 + i] = round_to<T>(s);   // einsum in the input dtype
    }
  }
  __syncthreads();

  // 2. the row max over the cluster: each rank's, stored into every rank, combined in rank order
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // (each score first scaled and masked as _masked_attend does: / sqrt(HD), finfo.min past the
  // window row's position; the divisions run in passes of their own, out of the row loops)
  float part[kMaxW];
#pragma unroll
  for (int x = 0; x < kMaxW; ++x) {
    part[x] = -INFINITY;
    if (x < W)
      for (int i = tid; i < nr; i += kSplitThreads) {
        float v = sc[x * sp.cap + i];
        if (a.scale_attn) v = v / root;
        v = r0 + i <= len + x ? v : kMaskValue;
        sc[x * sp.cap + i] = v;
        part[x] = fmaxf(part[x], v);
      }
  }
#pragma unroll
  for (int x = 0; x < kMaxW; ++x) {
    if (x >= W) break;
    float v = part[x];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[warp][x] = v;
  }
  __syncthreads();
  if (tid < W) {
    float v = -INFINITY;
#pragma unroll
    for (int k = 0; k < kSplitWarps; ++k) v = fmaxf(v, red[k][tid]);
    push(cluster, &rank_max[rank][tid], v, C);
  }
  cluster.sync();
  if (tid < W) row_max[tid] = in_rank_order(&rank_max[0][tid], kMaxW, C, -INFINITY, Max());
  __syncthreads();

  // 3. e = exp(score - max) and the row sum over the cluster, as the max
#pragma unroll
  for (int x = 0; x < kMaxW; ++x) {
    part[x] = 0.f;
    if (x < W) {
      const float mx = row_max[x];
      for (int i = tid; i < nr; i += kSplitThreads) {
        const float e = expf(sc[x * sp.cap + i] - mx);
        sc[x * sp.cap + i] = e;
        part[x] += e;
      }
    }
  }
#pragma unroll
  for (int x = 0; x < kMaxW; ++x) {
    if (x >= W) break;
    float v = part[x];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][x] = v;
  }
  __syncthreads();
  if (tid < W) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kSplitWarps; ++k) v += red[k][tid];
    push(cluster, &rank_sum[rank][tid], v, C);
  }
  cluster.sync();
  if (tid < W) row_sum[tid] = in_rank_order(&rank_sum[0][tid], kMaxW, C, 0.f, Add());
  __syncthreads();
  // P = round_to<T>(e / the full row sum)
#pragma unroll
  for (int x = 0; x < kMaxW; ++x) {
    if (x >= W) break;
    const float sum = row_sum[x];
    for (int i = tid; i < nr; i += kSplitThreads)
      sc[x * sp.cap + i] = round_to<T>(sc[x * sp.cap + i] / sum);
  }

  // 4. this rank's AV in fp32; V streamed when it did not fit
  float acc[kEpt];
#pragma unroll
  for (int j = 0; j < kEpt; ++j) acc[j] = 0.f;
  if (single) cp_async_wait<0>();
  __syncthreads();                 // P is written (and, with a single piece, V has landed)
  for (int s0 = 0; s0 < nr; s0 += sp.R) {
    const int n = min(sp.R, nr - s0);
    if (!single) {
      __syncthreads();             // the previous piece's V rows are read
      stage(sV, sVs, vp, a.v_scale, s0, n);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    for (int i = g; i < n; i += G) {
      float vr[kEpt];
      staged(sV, sVs, i, vr);
      const float p = sc[w * sp.cap + s0 + i];
#pragma unroll
      for (int j = 0; j < kEpt; ++j) acc[j] = fmaf(p, vr[j], acc[j]);
    }
  }
  // the window row's groups, summed in group order into this rank's partial O, each output
  // stored in the inbox of the rank that writes it (outputs q per .. q per + per - 1: rank q)
  if (active) {
#pragma unroll
    for (int j = 0; j < kEpt; ++j) red_acc[gi * HD + d0 + j] = acc[j];
  }
  __syncthreads();
  const int per = split_per(C, W, HD);
  for (int i = tid; i < W * HD; i += kSplitThreads) {
    const int x = i / HD, d = i - x * HD, q = i / per;
    float part_o[kGroups];         // the groups' partials, loaded at once, summed in order
#pragma unroll
    for (int k = 0; k < kGroups; ++k) part_o[k] = k < G ? red_acc[(x * G + k) * HD + d] : 0.f;
    float o = 0.f;
#pragma unroll
    for (int k = 0; k < kGroups; ++k)
      if (k < G) o += part_o[k];
    *cluster.map_shared_rank(inbox + rank * per + (i - q * per), q) = o;
  }
  cluster.sync();                  // every store into every inbox has landed

  // 5. the partial O's summed in rank order: each rank writes its slice of the W HD outputs;
  // after the last barrier no rank touches a peer's shared memory, so each may exit
  const int lo = rank * per, hi = min(lo + per, W * HD);
  T* out = static_cast<T*>(a.out);
  for (int i = lo + tid; i < hi; i += kSplitThreads) {
    const float o = in_rank_order(inbox + (i - lo), per, C, 0.f, Add());
    const int x = i / HD, d = i - x * HD;
    out[((static_cast<size_t>(b) * W + x) * a.H + h) * HD + d] = from_f<T>(o);
  }
}

// The split of a launch from S, the head dim and the pool's row bytes (ops/transformer/
// paged_attention.py exact_sm90_plan is the same rule)
Split split_plan(int S, int HD, int elem, int n_scales) {
  Split sp;
  sp.C = std::min(kMaxRanks, std::max(1, (S + kRankRows - 1) / kRankRows));
  sp.cap = (S + sp.C - 1) / sp.C;
  const int per_row = 2 * (HD * elem + 4 * n_scales);
  sp.R = std::min(sp.cap, std::max(1, kStageBytes / per_row));
  return sp;
}

enum Kind { kOnline, kExact, kExactSplit };

template <typename T, typename P, int HD>
int launch(Kind kind, const Args& a, int B, cudaStream_t stream) {
  const dim3 grid(B, a.H);
  if (kind == kExactSplit) {
    const int ns = std::is_same<P, int8_t>::value ? a.n_scales : 0;
    const Split sp = split_plan(a.nb_max * a.bs, HD, static_cast<int>(sizeof(P)), ns);
    const size_t smem =
        split_layout(sp, a.W, HD, static_cast<int>(sizeof(P)), ns, a.nb_max).total;
    cudaError_t e = cudaFuncSetAttribute(exact_split_kernel<T, P, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B, a.H, sp.C);
    cfg.blockDim = dim3(kSplitThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = sp.C;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, exact_split_kernel<T, P, HD>, a, sp);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (kind == kExact) {
    const size_t smem =
        (static_cast<size_t>(a.W) * a.nb_max * a.bs + static_cast<size_t>(kWarps) * kMaxW * HD) *
        sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        exact_kernel<T, P, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    exact_kernel<T, P, HD><<<grid, kThreads, smem, stream>>>(a);
  } else {
    online_kernel<T, P, HD><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int by_head_dim(int head_dim, Kind kind, const Args& a, int B, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<T, P, 64>(kind, a, B, stream);
    case 128: return launch<T, P, 128>(kind, a, B, stream);
    default: return -1;
  }
}

// compute_dtype: 0 fp32, 1 bf16, 2 fp16
int dispatch(Kind kind, int compute_dtype, int quantized, int head_dim, const Args& a, int B,
             cudaStream_t stream) {
  if (B == 0) return 0;
  if (a.W < 1 || a.W > kMaxW) return -1;
  if (quantized) {
    switch (compute_dtype) {
      case 0: return by_head_dim<float, int8_t>(head_dim, kind, a, B, stream);
      case 1: return by_head_dim<__nv_bfloat16, int8_t>(head_dim, kind, a, B, stream);
      case 2: return by_head_dim<__half, int8_t>(head_dim, kind, a, B, stream);
      default: return -1;
    }
  }
  switch (compute_dtype) {
    case 0: return by_head_dim<float, float>(head_dim, kind, a, B, stream);
    case 1: return by_head_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, kind, a, B, stream);
    case 2: return by_head_dim<__half, __half>(head_dim, kind, a, B, stream);
    default: return -1;
  }
}

int entry(Kind kind, int compute_dtype, int quantized, int head_dim, const void* q,
          const void* k, const void* v, const void* k_scale, const void* v_scale,
          const void* tables, const void* lengths, void* out, int B, int W, int H,
          int block_size, int nb_max, int num_blocks, int n_scales, int scale_attn,
          float sm_scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.W = W;
  a.H = H;
  a.bs = block_size;
  a.nb_max = nb_max;
  a.num_blocks = num_blocks;
  a.n_scales = n_scales;
  a.scale_attn = scale_attn;
  a.sm_scale = sm_scale;
  return dispatch(kind, compute_dtype, quantized, head_dim, a, B,
                  reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace

#define PAGED_ENTRY(name, kind)                                                                 \
  extern "C" int name(int compute_dtype, int quantized, int head_dim, const void* q,           \
                      const void* k, const void* v, const void* k_scale, const void* v_scale,  \
                      const void* tables, const void* lengths, void* out, int B, int W, int H, \
                      int block_size, int nb_max, int num_blocks, int n_scales,                \
                      int scale_attn, float sm_scale, void* stream) {                          \
    return entry(kind, compute_dtype, quantized, head_dim, q, k, v, k_scale, v_scale, tables,  \
                 lengths, out, B, W, H, block_size, nb_max, num_blocks, n_scales, scale_attn,  \
                 sm_scale, stream);                                                            \
  }

PAGED_ENTRY(paged_attention_online, kOnline)
PAGED_ENTRY(paged_attention_exact, kExact)
PAGED_ENTRY(paged_attention_exact_sm90, kExactSplit)

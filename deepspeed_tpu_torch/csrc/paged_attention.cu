// Paged attention over the serving layer's shared KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/transformer/paged_attention.py:
//   paged_attention_online_sm90 <- _online_kernel (paged_attention.py:180-272, via _online_call 275-318)
//   paged_attention_online      <- the same: the first design of it, kept as the yardstick
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
// below the ~295 flops/byte where the H100's compute would become the limit.  So the first
// design spent nothing on tensor cores and everything on reading each live row once (its
// redesign uses them to issue fewer instructions, not for their rate):
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
// That is paged_attention_online (online_kernel, the first design): a (B, H) grid of such blocks,
// each row group loading one row and waiting for it before the next, keeps little in flight,
// and the slot with the most rows sets the time.
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
// paged_attention_online_sm90 (online_split_kernel) splits each (b, h) over a cluster the same
// way (C ranks from S alone, rank r the contiguous live rows [r c, min((r + 1) c, n_rows))).  A
// rank stages its rows in pieces of at most 64 (one piece when the chunk fits a 16 KB buffer, or
// two halves in turn, the next piece's copies in flight while the current one is consumed), and
// each piece's rows go to the warps or row groups that copy them (16-byte cp.async) and alone
// read them, so between the block-table barrier and the merge no block barrier stands in the
// way: each waits on its own copies, one round trip when the chunk fits.
//   * 16-bit compute (bf16, fp16) runs on the tensor cores: warp w takes a 16-row tile of each
//     piece (swizzled in shared memory for ldmatrix; an int8 pool's rows first dequantized by
//     the warp into such a tile, dequantize_blockwise's formula), S = K_tile q^T is one
//     mma.sync m16n8k16 per 16 of HD (rows as M, the window as N = 8, fp32 accumulators), and
//     after the softmax O^T += V_tile^T P^T one more per 16 of HD (P rounded to the compute
//     dtype through shared memory);
//   * fp32 compute runs on FMAs: row group g (HD / 8 lanes) takes rows g, g + G, ... of each
//     piece, each lane multiplying 8 elements of a row (an int8 row dequantized first), the
//     group summing a score by shuffles.
// Either way a group scores all its rows of a piece for every window row (fp32, x sm_scale),
// takes their max, then forms p = exp(s - max), l += p (unrounded) and acc += round(p) V: rows
// are independent work, and the running (m, l, acc) is rescaled only between pieces.  The
// groups merge (warp shuffles, then the warps through shared memory) into the rank's partial
// (m, l, O); each rank stores m and l into every peer and each output's partial O into the
// shared memory of the rank that writes it (stores, no remote reads); after one cluster.sync()
// the writing rank combines the partials in rank order, each scaled by exp(m_r - m), and
// divides by l (l == 0 -> 1).  One launch a call, no global scratch and no atomics; only the
// order of the fp32 sums and the max each p is taken against differ from online_kernel.  What
// sets its time at a decode step is residency: the 16-bit W = 1, head-dim-64 instances are held
// to 64 registers and the buffer to 16 KB, so an SM holds 8 blocks and every cluster of a 125M
// decode step runs at once.
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
constexpr int kOnlineThreads = 128;   // online_split_kernel's block
constexpr int kOnlineWarps = kOnlineThreads / 32;
// blocks an SM must hold at W = 1 and head dim 64 on the tensor-core path (64 registers a
// thread): the 96 clusters of 8 ranks of a 125M decode step (8 slots x 12 heads) on the 124 SMs
// that take clusters of 8, all at once (at 6 blocks an SM, 12.7 us against 9.3 at phase 4's
// state; the FMA path, fp32 compute only, spilled at 64 and 73 and is left uncapped)
constexpr int kOnlineBlocks = 8;

template <typename T, int HD, int kW>
constexpr int online_min_blocks() {
  return kW == 1 && HD == 64 && !std::is_same<T, float>::value ? kOnlineBlocks : 1;
}
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
// the scores, the AV reduction `red`), the V staging rows, the int8 scales of both, the score
// rows [W][cap], the slot's block-table row and the inbox of partial O's [C][per] (per =
// ceil(W HD / C): rank r's partial of the outputs this rank writes, stored there by rank r)
struct SplitLayout {
  int k, v, ks, vs, sc, tab, red, po, tiles, total;
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
  L.red = 0;
  L.v = round16(rows > red ? rows : red);
  L.ks = L.v + round16(rows);
  L.vs = L.ks + scales;
  L.sc = L.vs + scales;
  L.tab = L.sc + round16(W * sp.cap * 4);
  L.po = L.tab + round16(nb_max * 4);
  L.tiles = L.total = L.po + sp.C * split_per(sp.C, W, HD) * 4;
  return L;
}

// Byte offsets of the dynamic shared memory of online_split_kernel: the K and V staging rows (R
// rows rounded up to whole 16-row tiles: one piece, or two halves when a chunk streams), the int8
// scales of both, the scores of a piece [W][R] (FMA path), the slot's block-table row, the warps'
// partial O's [kOnlineWarps][W][HD], the inbox of partial O's [C][per], as exact_split_kernel's,
// and with `tiles` (int8 pools on the tensor cores) each warp's K and V tiles dequantized to
// 16 bits, [kOnlineWarps][2][16][HD]
__host__ __device__ __forceinline__ SplitLayout online_layout(const Split& sp, int W, int HD,
                                                              int elem, int n_scales, int nb_max,
                                                              bool tiles) {
  SplitLayout L;
  const int rows = ((sp.R + 15) & ~15) * HD * elem;
  const int scales = n_scales > 0 ? round16(((sp.R + 15) & ~15) * n_scales * 4) : 0;
  L.k = 0;
  L.v = rows;
  L.ks = L.v + rows;
  L.vs = L.ks + scales;
  L.sc = L.vs + scales;
  L.tab = L.sc + round16(W * sp.R * 4);
  L.red = L.tab + round16(nb_max * 4);
  L.po = L.red + kOnlineWarps * W * HD * 4;
  L.tiles = round16(L.po + sp.C * split_per(sp.C, W, HD) * 4);
  L.total = L.tiles + (tiles ? kOnlineWarps * 2 * 16 * HD * 2 : 0);
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 16-byte copies to a shared-memory address; the second reads no byte of src and writes zeros
__device__ __forceinline__ void cp_async16_at(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16_zero(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(0)
               : "memory");
}

__device__ __forceinline__ void cp_async4_at(uint32_t dst, const void* src, bool zero) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(zero ? 0 : 4) : "memory");
}

__device__ __forceinline__ void sts128(uint32_t at, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(a), "r"(b), "r"(c),
               "r"(d) : "memory");
}

// two floats rounded to the 16-bit T, packed (the first in the low half)
template <typename T> __device__ __forceinline__ uint32_t pack2(float x, float y);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  const __half2 v = __floats2half2_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// four 8x8 b16 matrices from shared memory (lane l gives the address of row l % 8 of matrix
// l / 8), into the layout of an mma.sync operand; kTrans delivers each transposed
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t at) {
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(at) : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(at) : "memory");
  }
}

// d += A B for one m16n8k16 tile of 16-bit T, fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
                 "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
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
  float* red_acc = reinterpret_cast<float*>(split_smem + L.red);  // [kGroups][HD], after the scores

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

// ----------------------------------------------------------- online kernel, cluster split
// K + V rows (and their scales) staged at once: a block of ~18 KB, so an SM holds 12 and every
// cluster of a decode step is resident at once (at 32 KB, 6 an SM, some clusters waited for a
// second wave: 13.2 us against 10.5 at phase 4's state, examples/paged_exact_split.py)
constexpr int kOnlineStageBytes = 16384;

// Grid (B, H, C), clusters of (1, 1, C), as exact_split_kernel.  Row group gi = tid / kLanes
// (kLanes lanes of kEpt elements span a row) takes rows gi, gi + kGroups, ... of each piece of
// the rank's chunk, for every window row.  kW (1, or kMaxW for W > 1) sizes the registers a
// lane keeps per window row, so plain decode keeps its blocks' registers few.
template <typename T, typename P, int HD, int kW>
__global__ void __launch_bounds__(kOnlineThreads, online_min_blocks<T, HD, kW>())
    online_split_kernel(Args a, Split sp) {
  constexpr int kLanes = HD / kEpt;
  constexpr int kGroups = kOnlineThreads / kLanes;
  constexpr int kRowBytes = HD * static_cast<int>(sizeof(P));
  constexpr int kPieces = kRowBytes / 16;             // 16-byte copies a row
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  // QK^T and PV on the tensor cores (mma.sync m16n8k16, fp32 accumulators) for 16-bit compute
  // (int8 pools dequantized into 16-bit tiles first); fp32 compute takes FMAs
  constexpr bool kMma = !std::is_same<T, float>::value;
  constexpr int kRowT = HD * 2;                       // bytes of a 16-bit tile row
  static_assert(kRowBytes % 16 == 0, "a pool row must be a whole number of 16-byte copies");
  static_assert(!kMma || kRowT >= 128, "the swizzle spans 8 chunks: rows of 128 bytes or more");
  extern __shared__ __align__(16) unsigned char split_smem[];
  // the tensor-core path's P^T tile of each warp, [window row][tile row] in T
  __shared__ __align__(16) uint16_t p_t[kOnlineWarps][kMaxW * 16];
  // each warp's partial row max and sum, then each rank's (stored by that rank)
  __shared__ float warp_m[kOnlineWarps][kMaxW], warp_l[kOnlineWarps][kMaxW];
  __shared__ float rank_m[kMaxRanks][kMaxW], rank_l[kMaxRanks][kMaxW];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = sp.C, rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = a.W, S = a.nb_max * a.bs, ns = kQuant ? a.n_scales : 0;
  const SplitLayout L =
      online_layout(sp, W, HD, static_cast<int>(sizeof(P)), ns, a.nb_max, kMma && kQuant);
  unsigned char* sK = split_smem + L.k;
  unsigned char* sV = split_smem + L.v;
  float* sKs = reinterpret_cast<float*>(split_smem + L.ks);
  float* sVs = reinterpret_cast<float*>(split_smem + L.vs);
  float* sc = reinterpret_cast<float*>(split_smem + L.sc);
  int* tab = reinterpret_cast<int*>(split_smem + L.tab);
  float* red_acc = reinterpret_cast<float*>(split_smem + L.red);
  float* inbox = reinterpret_cast<float*>(split_smem + L.po);

  const int gi = tid / kLanes, sub = tid % kLanes, d0 = sub * kEpt;
  const T* q = static_cast<const T*>(a.q);
  const unsigned char* kp = static_cast<const unsigned char*>(a.k);
  const unsigned char* vp = static_cast<const unsigned char*>(a.v);

  // arrive on the cluster barrier now and wait before the first store into a peer's shared
  // memory (after the rows): a peer is then known to be running
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the queries, lengths[b] and the slot's block-table row: independent loads, issued together
  // (the tensor-core path: q^T as the B operand of QK^T, column n = window row lane / 4, its
  // elements 2 (lane % 4) + {0, 1} and + 8 of each 16-wide k step, two T to a register)
  float qr[kMma ? 1 : kW][kEpt];
  uint32_t qf[kMma ? HD / 8 : 1];
  if constexpr (kMma) {
    const int wq = lane >> 2;
    const T* qw = q + ((static_cast<size_t>(b) * W + wq) * a.H + h) * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      qf[j] = wq < W ? *reinterpret_cast<const uint32_t*>(qw + 8 * j) : 0u;
  } else {
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      if (w < W) {
        load_vec<T>(q + ((static_cast<size_t>(b) * W + w) * a.H + h) * HD + d0, qr[w]);
      } else {
#pragma unroll
        for (int j = 0; j < kEpt; ++j) qr[w][j] = 0.f;
      }
    }
  }
  const int len = __ldg(a.lengths + b);
  // a block id outside the pool is clamped into it, as the gather oracle's clamped indexing
  for (int t = tid; t < a.nb_max; t += kOnlineThreads)
    tab[t] = min(max(__ldg(a.tables + static_cast<size_t>(b) * a.nb_max + t), 0),
                 a.num_blocks - 1);
  __syncthreads();

  // this rank's rows: rows past the window's last position are masked for every window row,
  // so they are neither read nor scored; a chunk that fits the staging buffer is one piece,
  // a longer one streams through its two halves in turn
  const int n_rows = max(min(len + W, S), 0);
  const int c = (n_rows + C - 1) / C;
  const int r0 = min(rank * c, n_rows);
  const int nr = min(r0 + c, n_rows) - r0;
  // rows a piece (the tensor-core path's halves whole 16-row tiles: R is 32 or 64 there)
  const int pr = nr <= sp.R ? sp.R : kMma ? (sp.R / 2) & ~15 : sp.R / 2;
  const int np = (nr + pr - 1) / pr;

  if constexpr (kMma) {
    // ---- the tensor-core path (16-bit compute): warp w takes rows [16 w, 16 w + 16) of each
    // piece, a tile it copies itself (rows of the tile past the piece zeroed); 16-bit rows are
    // staged with 16-byte chunk x of buffer row i at chunk x ^ (i & 7), so ldmatrix reads 8 rows
    // without bank conflicts, int8 rows as they are and then dequantized into such a tile.
    // S = K_tile q^T is one m16n8k16 per 16 of HD (rows as M, the window as N = 8); O^T +=
    // V_tile^T P^T one per 16 of HD (HD as M, the window as N), so a lane keeps the same two
    // window rows, 2 t4 and 2 t4 + 1, through the scores, the softmax and O
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t sKu = smem_addr(sK), sVu = smem_addr(sV);
    // int8: the staged rows are plain (16-byte chunk x of buffer row i at x), the scales beside
    // them, and the warp's dequantized tiles swizzled; 16-bit: the staged rows swizzled
    const uint32_t tKu = smem_addr(split_smem + L.tiles) + warp * 2 * 16 * kRowT;
    const uint32_t tVu = tKu + 16 * kRowT;
    auto issue = [&](int k) {
      if (k < np) {
        const int s0 = k * pr, n = min(pr, nr - s0), off = (k & 1) * pr, i0 = 16 * warp;
        if (i0 < n) {
          for (int cidx = lane; cidx < 16 * kPieces; cidx += 32) {
            const int i = i0 + cidx / kPieces, x = cidx % kPieces, prow = off + i;
            const uint32_t at = prow * kRowBytes + ((kQuant ? x : x ^ (prow & 7)) * 16);
            if (i < n) {
              const int r = r0 + s0 + i, j = r / a.bs;
              const size_t row = (static_cast<size_t>(tab[j]) * a.bs + (r - j * a.bs)) * a.H + h;
              cp_async16_at(sKu + at, kp + row * kRowBytes + x * 16);
              cp_async16_at(sVu + at, vp + row * kRowBytes + x * 16);
            } else {
              cp_async16_zero(sKu + at, kp);
              cp_async16_zero(sVu + at, vp);
            }
          }
          if constexpr (kQuant) {   // the rows' scales, zeros past the piece
            for (int cidx = lane; cidx < 16 * ns; cidx += 32) {
              const int i = i0 + cidx / ns, x = cidx % ns, prow = off + i;
              size_t row = 0;
              if (i < n) {
                const int r = r0 + s0 + i, j = r / a.bs;
                row = (static_cast<size_t>(tab[j]) * a.bs + (r - j * a.bs)) * a.H + h;
              }
              cp_async4_at(smem_addr(sKs + prow * ns + x), a.k_scale + row * ns + x, i >= n);
              cp_async4_at(smem_addr(sVs + prow * ns + x), a.v_scale + row * ns + x, i >= n);
            }
          }
        }
      }
      cp_async_commit();
    };
    // int8: element d of a row takes scale d >> qshift (the quant block HD / ns, a power of 2)
    const int qshift = kQuant ? __ffs(HD / max(ns, 1)) - 1 : 0;
    // rows [lr0, lr0 + 16) of the staged int8 K or V (and their scales) into the tile at t,
    // dequantize_blockwise's formula (float(q) * scale, rounded to T), 8 elements a step
    auto dequant = [&](const unsigned char* rows, const float* scales, int lr0, uint32_t t) {
      for (int e = lane; e < 16 * (HD / 8); e += 32) {
        const int lr = e / (HD / 8), grp = e % (HD / 8), prow = lr0 + lr;
        const uint2 raw = *reinterpret_cast<const uint2*>(rows + prow * kRowBytes + grp * 8);
        const float* s = scales + prow * ns;
        float f[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t word = j < 4 ? raw.x : raw.y;
          f[j] = static_cast<float>(static_cast<int8_t>((word >> (8 * (j & 3))) & 0xff)) *
                 (qshift >= 3 ? s[(grp * 8) >> qshift] : s[(grp * 8 + j) >> qshift]);
        }
        sts128(t + lr * kRowT + ((grp ^ (lr & 7)) * 16), pack2<T>(f[0], f[1]), pack2<T>(f[2], f[3]),
               pack2<T>(f[4], f[5]), pack2<T>(f[6], f[7]));
      }
    };
    issue(0);
    issue(1);
    // the warp's running state for window rows 2 t4 + cc: max, this lane's share of the
    // denominator, and O^T rows 16 j + g (cc) and 16 j + g + 8 (2 + cc)
    float m2[2] = {-INFINITY, -INFINITY}, l2[2] = {0.f, 0.f};
    float o[HD / 16][4];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    T* pt = reinterpret_cast<T*>(p_t[warp]);     // P of the tile: [window row][tile row]
    for (int k = 0; k < np; ++k) {
      cp_async_wait<1>();          // this thread's copies of piece k have landed
      __syncwarp();                // and the warp's other lanes' too
      const int s0 = k * pr, n = min(pr, nr - s0), off = (k & 1) * pr, i0 = 16 * warp;
      if (i0 < n) {                // warp-uniform
        // the tile's 16 rows of T, row lr at tK + lr kRowT, 16-byte chunk x at x ^ (lr & 7)
        uint32_t tK = sKu + (off + i0) * kRowBytes, tV = sVu + (off + i0) * kRowBytes;
        if constexpr (kQuant) {
          dequant(sK, sKs, off + i0, tKu);
          dequant(sV, sVs, off + i0, tVu);
          __syncwarp();            // the tiles are in shared memory
          tK = tKu;
          tV = tVu;
        }
        // 1. S = K_tile q^T (16 rows x 8 window rows), fp32, x sm_scale; matrix l / 8 of a
        // ldmatrix: rows 8 (l / 8 % 2) .., columns 8 (l / 16) .. of the 16 x 16 step
        const int krow = ((lane >> 3) & 1) * 8 + (lane & 7);
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          uint32_t ka[4];
          ldsm_x4<false>(ka, tK + krow * kRowT + (((2 * ks + (lane >> 4)) ^ (krow & 7)) * 16));
          mma16816<T>(s, ka[0], ka[1], ka[2], ka[3], qf[2 * ks], qf[2 * ks + 1]);
        }
        // s[cc]: tile row g, window row 2 t4 + cc; s[2 + cc]: tile row g + 8
        float alpha[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int w = 2 * t4 + cc, ra = r0 + s0 + i0 + g;
          const bool la = i0 + g < n && w < W && ra <= len + w;
          const bool lb = i0 + g + 8 < n && w < W && ra + 8 <= len + w;
          const float sa = la ? s[cc] * a.sm_scale : -INFINITY;
          const float sb = lb ? s[cc + 2] * a.sm_scale : -INFINITY;
          float pm = fmaxf(sa, sb);
#pragma unroll
          for (int off2 = 4; off2 < 32; off2 <<= 1)
            pm = fmaxf(pm, __shfl_xor_sync(0xffffffffu, pm, off2));
          // 2. the running state rescaled to the tile's max: once a piece, never once a row
          const float m_new = fmaxf(m2[cc], pm);
          alpha[cc] = m2[cc] == -INFINITY ? 0.f : expf(m2[cc] - m_new);
          m2[cc] = m_new;
          const float pa = la ? expf(sa - m_new) : 0.f;
          const float pb = lb ? expf(sb - m_new) : 0.f;
          l2[cc] = l2[cc] * alpha[cc] + pa + pb;
          pt[w * 16 + g] = from_f<T>(pa);        // p.astype(compute) for AV only
          pt[w * 16 + g + 8] = from_f<T>(pb);
        }
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
          o[j][0] *= alpha[0];
          o[j][2] *= alpha[0];
          o[j][1] *= alpha[1];
          o[j][3] *= alpha[1];
        }
        __syncwarp();              // P is in shared memory
        // 3. O^T += V_tile^T P^T: A = V^T by ldmatrix.trans (matrix l / 8: tile rows
        // 8 (l / 16) .., HD columns 8 (l / 8 % 2) ..), B = P^T (window row g, tile rows 2 t4..)
        const uint32_t pb0 = *reinterpret_cast<const uint32_t*>(pt + g * 16 + 2 * t4);
        const uint32_t pb1 = *reinterpret_cast<const uint32_t*>(pt + g * 16 + 2 * t4 + 8);
        const int vrow = ((lane >> 4) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
          uint32_t va[4];
          const int chunk = (2 * j + ((lane >> 3) & 1)) ^ (vrow & 7);
          ldsm_x4<true>(va, tV + vrow * kRowT + chunk * 16);
          mma16816<T>(o[j], va[0], va[1], va[2], va[3], pb0, pb1);
        }
      }
      __syncwarp();                // the tile and P are read
      issue(k + 2);
    }
    // 4. the warp's partial: the denominator summed over the tile rows (the lanes of one t4),
    // then (m, l) and O of window rows 2 t4, 2 t4 + 1
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
#pragma unroll
      for (int off2 = 4; off2 < 32; off2 <<= 1)
        l2[cc] += __shfl_xor_sync(0xffffffffu, l2[cc], off2);
      const int w = 2 * t4 + cc;
      if (w < W) {
        if (g == 0) {
          warp_m[warp][w] = m2[cc];
          warp_l[warp][w] = l2[cc];
        }
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
          red_acc[(warp * W + w) * HD + 16 * j + g] = o[j][cc];
          red_acc[(warp * W + w) * HD + 16 * j + g + 8] = o[j][2 + cc];
        }
      }
    }
  } else {
    // ---- the FMA path (fp32 compute, fp32 or int8 pools)
    // this group's rows of piece k (and their scales) into the piece's half (k odd: the second),
    // 16 bytes a copy; one commit group a piece, empty past the last
    auto issue = [&](int k) {
      if (k < np) {
        const int s0 = k * pr, n = min(pr, nr - s0), off = (k & 1) * pr;
        for (int i = gi; i < n; i += kGroups) {
          const int r = r0 + s0 + i, j = r / a.bs;
          const size_t row = (static_cast<size_t>(tab[j]) * a.bs + (r - j * a.bs)) * a.H + h;
          for (int x = sub; x < kPieces; x += kLanes) {
            cp_async16(sK + (off + i) * kRowBytes + x * 16, kp + row * kRowBytes + x * 16);
            cp_async16(sV + (off + i) * kRowBytes + x * 16, vp + row * kRowBytes + x * 16);
          }
          if constexpr (kQuant) {
            for (int x = sub; x < ns; x += kLanes) {
              cp_async4(sKs + (off + i) * ns + x, a.k_scale + row * ns + x);
              cp_async4(sVs + (off + i) * ns + x, a.v_scale + row * ns + x);
            }
          }
        }
      }
      cp_async_commit();
    };
    issue(0);
    issue(1);

    // one lane's slice of staged row i as the compute dtype T (int8: through its scales, with
    // dequantize_blockwise's formula).  The quant block HD / ns divides HD, so it is a power of
    // two: element d takes scale d >> qshift
    const int qshift = kQuant ? __ffs(HD / max(ns, 1)) - 1 : 0;
    auto staged = [&](const unsigned char* rows, const float* scales, int i, float (&out)[kEpt]) {
      load_vec<P, true>(reinterpret_cast<const P*>(rows + i * kRowBytes) + d0, out);
      if constexpr (kQuant) {
        const float* s = scales + i * ns;
#pragma unroll
        for (int j = 0; j < kEpt; ++j) out[j] = round_to<T>(out[j] * s[(d0 + j) >> qshift]);
      }
    };

    // the group's running state per window row: max, denominator (of the unrounded p), AV
    float m[kW], l[kW], acc[kW][kEpt];
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      m[w] = -INFINITY;
      l[w] = 0.f;
#pragma unroll
      for (int j = 0; j < kEpt; ++j) acc[w][j] = 0.f;
    }
    for (int k = 0; k < np; ++k) {
      cp_async_wait<1>();            // this thread's copies of piece k have landed
      __syncwarp();                  // and the group's other lanes' too
      const int s0 = k * pr, n = min(pr, nr - s0), off = (k & 1) * pr;
      // a trip count uniform over the block: the group sums shuffle across every lane
      const int trips = (n + kGroups - 1) / kGroups;

      // 1. the scores of the group's rows (fp32, x sm_scale) and their max, each window row
      float pm[kW];
#pragma unroll
      for (int w = 0; w < kW; ++w) pm[w] = -INFINITY;
      for (int t = 0; t < trips; ++t) {
        const int i = gi + t * kGroups, r = r0 + s0 + i;
        const bool live = i < n;
        float kr[kEpt];
        if (live) {
          staged(sK, sKs, off + i, kr);
        } else {
#pragma unroll
          for (int j = 0; j < kEpt; ++j) kr[j] = 0.f;
        }
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          if (w >= W) break;
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < kEpt; ++j) s = fmaf(qr[w][j], kr[j], s);
          s = group_sum<kLanes>(s) * a.sm_scale;
          if (live && r <= len + w) pm[w] = fmaxf(pm[w], s);
          if (live && sub == 0) sc[w * sp.R + i] = s;
        }
      }
      __syncwarp();                  // the group's scores are in shared memory

      // 2. the running state rescaled to the piece's max: once a piece, never once a row
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        if (w >= W) break;
        const float m_new = fmaxf(m[w], pm[w]);
        const float alpha = m[w] == -INFINITY ? 0.f : expf(m[w] - m_new);
        l[w] *= alpha;
#pragma unroll
        for (int j = 0; j < kEpt; ++j) acc[w][j] *= alpha;
        m[w] = m_new;
      }

      // 3. p = exp(s - m), l += p, acc += round(p) V over the group's rows: independent rows
      for (int t = 0; t < trips; ++t) {
        const int i = gi + t * kGroups, r = r0 + s0 + i;
        if (i >= n) break;
        float vr[kEpt];
        staged(sV, sVs, off + i, vr);
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          if (w >= W) break;
          if (r <= len + w) {
            const float p = expf(sc[w * sp.R + i] - m[w]);
            const float pv = round_to<T>(p);      // p.astype(compute) for AV only
            l[w] += p;
#pragma unroll
            for (int j = 0; j < kEpt; ++j) acc[w][j] = fmaf(pv, vr[j], acc[w][j]);
          }
        }
      }
      __syncwarp();                  // the group's rows of this half and its scores are read
      issue(k + 2);
    }

    // 4. the groups of each warp merged (groups that saw no live row hold m = -inf), then each
    // warp's partial into shared memory
#pragma unroll
    for (int off = kLanes; off < 32; off <<= 1) {
#pragma unroll
      for (int w = 0; w < kW; ++w) {
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
      for (int w = 0; w < kW; ++w) {
        if (w >= W) break;
#pragma unroll
        for (int j = 0; j < kEpt; ++j) red_acc[(warp * W + w) * HD + d0 + j] = acc[w][j];
        if (lane == 0) {
          warp_m[warp][w] = m[w];
          warp_l[warp][w] = l[w];
        }
      }
    }
  }
  __syncthreads();

  // 5. the rank's partial (m, l, O) over its warps: m and l stored into every rank, each
  // output's O into the inbox of the rank that writes it (outputs q per .. q per + per - 1)
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < W) {
    float mx = -INFINITY, ls = 0.f;
#pragma unroll
    for (int k = 0; k < kOnlineWarps; ++k) mx = fmaxf(mx, warp_m[k][tid]);
#pragma unroll
    for (int k = 0; k < kOnlineWarps; ++k) {
      const float mk = warp_m[k][tid];
      if (mk != -INFINITY) ls += warp_l[k][tid] * expf(mk - mx);
    }
    push(cluster, &rank_m[rank][tid], mx, C);
    push(cluster, &rank_l[rank][tid], ls, C);
  }
  const int per = split_per(C, W, HD);
  for (int i = tid; i < W * HD; i += kOnlineThreads) {
    const int x = i / HD, d = i - x * HD, q_rank = i / per;
    float mx = -INFINITY, o = 0.f;
#pragma unroll
    for (int k = 0; k < kOnlineWarps; ++k) mx = fmaxf(mx, warp_m[k][x]);
#pragma unroll
    for (int k = 0; k < kOnlineWarps; ++k) {
      const float mk = warp_m[k][x];
      if (mk != -INFINITY) o += red_acc[(k * W + x) * HD + d] * expf(mk - mx);
    }
    *cluster.map_shared_rank(inbox + rank * per + (i - q_rank * per), q_rank) = o;
  }
  cluster.sync();                  // every store into every rank has landed

  // 6. the partials combined in rank order, each scaled by exp(m_r - m), divided by l; row 0
  // is live for every window row, so some rank has a finite max.  After the barrier no rank
  // touches a peer's shared memory, so each may exit
  const int lo = rank * per, hi = min(lo + per, W * HD);
  T* out = static_cast<T*>(a.out);
  for (int i = lo + tid; i < hi; i += kOnlineThreads) {
    const int x = i / HD, d = i - x * HD;
    const float mx = in_rank_order(&rank_m[0][x], kMaxW, C, -INFINITY, Max());
    float o = 0.f, ls = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRanks; ++r) {     // no early exit: the ranks' loads and exps overlap
      const float mr = r < C ? rank_m[r][x] : -INFINITY;
      const float f = mr == -INFINITY ? 0.f : expf(mr - mx);
      if (r < C) {
        o += f * inbox[r * per + (i - lo)];
        ls += f * rank_l[r][x];
      }
    }
    // __fdividef (within 2 ulp for l in [1, 2^126]: the row's max contributes p = 1) has no
    // slow-path call, across which ptxas spilled live values in two int8 instances
    out[((static_cast<size_t>(b) * W + x) * a.H + h) * HD + d] =
        from_f<T>(__fdividef(o, ls == 0.f ? 1.f : ls));
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

// online_split_kernel's: the same ranks; R rows staged at once, what kOnlineStageBytes holds
// but 32 to 64 (a 16-row tile a warp), so a streamed chunk's halves are whole tiles
// (online_sm90_plan is the same rule)
Split online_plan(int S, int HD, int elem, int n_scales) {
  Split sp = split_plan(S, HD, elem, n_scales);
  const int per_row = 2 * (HD * elem + 4 * n_scales);
  sp.R = std::min(std::min(sp.cap, 16 * kOnlineWarps), std::max(32, kOnlineStageBytes / per_row));
  return sp;
}

enum Kind { kOnline, kExact, kExactSplit, kOnlineSplit };

template <typename T, typename P, int HD>
int launch(Kind kind, const Args& a, int B, cudaStream_t stream) {
  const dim3 grid(B, a.H);
  if (kind == kExactSplit || kind == kOnlineSplit) {
    const bool online = kind == kOnlineSplit;
    const int ns = std::is_same<P, int8_t>::value ? a.n_scales : 0;
    const int elem = static_cast<int>(sizeof(P));
    const Split sp = online ? online_plan(a.nb_max * a.bs, HD, elem, ns)
                            : split_plan(a.nb_max * a.bs, HD, elem, ns);
    const bool tiles = !std::is_same<T, float>::value && ns > 0;   // int8 on the tensor cores
    const size_t smem = online ? online_layout(sp, a.W, HD, elem, ns, a.nb_max, tiles).total
                               : split_layout(sp, a.W, HD, elem, ns, a.nb_max).total;
    void (*kernel)(Args, Split) =
        !online ? exact_split_kernel<T, P, HD>
        : a.W == 1 ? online_split_kernel<T, P, HD, 1> : online_split_kernel<T, P, HD, kMaxW>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B, a.H, sp.C);
    cfg.blockDim = dim3(online ? kOnlineThreads : kSplitThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = sp.C;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, a, sp);
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
PAGED_ENTRY(paged_attention_online_sm90, kOnlineSplit)

// Paged attention over the serving layer's shared KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/transformer/paged_attention.py:
//   paged_attention_online  <- _online_kernel (paged_attention.py:180-272, via _online_call 275-318)
//   paged_attention_exact   <- _exact_kernel  (paged_attention.py:90-132,  via _exact_call  135-176)
//
// Both compute, for every slot b, head h and window row w (W <= 8 query tokens per slot),
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
// Later work (wgmma, TMA, split-K across blocks for long contexts) is not done here.
//
// The exact kernel keeps the full score row of every window row in shared memory
// (W * S * 4 bytes, 32 KB at W = 8, S = 1024) and mirrors GPT2._masked_attend op for op:
// score rounded to the compute dtype, then fp32, divided by sqrt(HD), masked with
// finfo(float32).min, full-row softmax, probabilities rounded to the compute dtype
// before AV.  The online kernel mirrors _online_kernel: fp32 scores multiplied by
// 1/sqrt(HD), online softmax, probabilities rounded to the compute dtype only for AV.
//
// C interface for ctypes: each entry returns cudaGetLastError() after the launch
// (0 on success), or -1 for a combination of dtype / head dim it was not built for.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// kEpt contiguous elements of P at src -> fp32, with 16-byte (or 8-byte) vector loads
template <typename P>
__device__ __forceinline__ void load_vec(const P* __restrict__ src, float (&out)[kEpt]) {
  constexpr int kBytes = kEpt * static_cast<int>(sizeof(P));
  static_assert(kBytes % 8 == 0, "a lane's slice must be a multiple of 8 bytes");
  if constexpr (kBytes % 16 == 0) {
    uint4 buf[kBytes / 16];
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) buf[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    const P* e = reinterpret_cast<const P*>(buf);
#pragma unroll
    for (int j = 0; j < kEpt; ++j) out[j] = to_f<P>(e[j]);
  } else {
    uint2 buf[kBytes / 8];
#pragma unroll
    for (int i = 0; i < kBytes / 8; ++i) buf[i] = __ldg(reinterpret_cast<const uint2*>(src) + i);
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

template <typename T, typename P, int HD>
int launch(bool exact, const Args& a, int B, cudaStream_t stream) {
  const dim3 grid(B, a.H);
  if (exact) {
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
int by_head_dim(int head_dim, bool exact, const Args& a, int B, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<T, P, 64>(exact, a, B, stream);
    case 128: return launch<T, P, 128>(exact, a, B, stream);
    default: return -1;
  }
}

// compute_dtype: 0 fp32, 1 bf16, 2 fp16
int dispatch(bool exact, int compute_dtype, int quantized, int head_dim, const Args& a, int B,
             cudaStream_t stream) {
  if (B == 0) return 0;
  if (a.W < 1 || a.W > kMaxW) return -1;
  if (quantized) {
    switch (compute_dtype) {
      case 0: return by_head_dim<float, int8_t>(head_dim, exact, a, B, stream);
      case 1: return by_head_dim<__nv_bfloat16, int8_t>(head_dim, exact, a, B, stream);
      case 2: return by_head_dim<__half, int8_t>(head_dim, exact, a, B, stream);
      default: return -1;
    }
  }
  switch (compute_dtype) {
    case 0: return by_head_dim<float, float>(head_dim, exact, a, B, stream);
    case 1: return by_head_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, exact, a, B, stream);
    case 2: return by_head_dim<__half, __half>(head_dim, exact, a, B, stream);
    default: return -1;
  }
}

int entry(bool exact, int compute_dtype, int quantized, int head_dim, const void* q,
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
  return dispatch(exact, compute_dtype, quantized, head_dim, a, B,
                  reinterpret_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int paged_attention_online(int compute_dtype, int quantized, int head_dim,
                                      const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* tables, const void* lengths, void* out, int B,
                                      int W, int H, int block_size, int nb_max, int num_blocks,
                                      int n_scales, int scale_attn, float sm_scale,
                                      void* stream) {
  return entry(false, compute_dtype, quantized, head_dim, q, k, v, k_scale, v_scale, tables,
               lengths, out, B, W, H, block_size, nb_max, num_blocks, n_scales, scale_attn,
               sm_scale, stream);
}

extern "C" int paged_attention_exact(int compute_dtype, int quantized, int head_dim,
                                     const void* q, const void* k, const void* v,
                                     const void* k_scale, const void* v_scale,
                                     const void* tables, const void* lengths, void* out, int B,
                                     int W, int H, int block_size, int nb_max, int num_blocks,
                                     int n_scales, int scale_attn, float sm_scale,
                                     void* stream) {
  return entry(true, compute_dtype, quantized, head_dim, q, k, v, k_scale, v_scale, tables,
               lengths, out, B, W, H, block_size, nb_max, num_blocks, n_scales, scale_attn,
               sm_scale, stream);
}

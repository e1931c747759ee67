// Flash attention forward and backward for Hopper (sm_90a): the kernels, shared by
// flash_attention.cu (dense), flash_attention_sparse_fwd.cu and
// flash_attention_sparse_bwd.cu (the biased and block-sparse LUT variants); the banded
// and merged-row forwards of flash_attention_band_merge_fwd.cu use its helpers.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/transformer/flash_attention.py:
//   fwd_kernel  <- _fwd_kernel      (144-283; dense, use_kbias/use_abias, use_lut)
//                  _fwd_kernel_dma  (306-415; the LUT forward with a 3-deep fetch ring)
//   dkdv_kernel <- _bwd_dkdv_kernel (617-688; dense, biases, use_lut with qmap/qlen)
//   dq_kernel   <- _bwd_dq_kernel   (691-753; dense, biases, use_lut)
// Each kernel is one template; its flags select the variant:
//   kLut    the block-sparse path: the loop visits only the live tiles of a 64 x 64 tile
//           LUT (built on the host from the layout, ops/transformer/flash_attention.py),
//           and a tile whose layout cells are not all live carries a bit mask of its
//           live cells (layout blocks 16 and 32: 4 x 4 or 2 x 2 cells per tile);
//   kBias   additive fp32 score biases, a (B, T) key bias and a (T, T) score bias, each
//           optional (null), added after the scale as the Pallas code adds them (215-221);
//           in log2 units here, so they enter as bias * log2 e;
//   kStages tiles in flight in the forward: 2 (double buffer) or 3 (the ring of
//           _fwd_kernel_dma: the fetch of slot j+2 is issued before slot j computes).
// With every flag off the kernels are the dense kernels as they were before the variants
// existed: the dense branches below are kept word for word, because a shared predicated
// form compiled the dense forward 7% slower (H100 80GB HBM3 at 700 W, B=8 H=16 T=1024
// d=64 bf16, chip_smoke.py phase 6).
//
// Layouts: q, k, v, dO are (B, T, H, D) tensors read through their (b, t, h) strides in
// elements with the last dim contiguous, so q/k/v can be views of the fused qkv matmul
// output; O, dQ, dK, dV are written contiguous (B, T, H, D); lse and delta are fp32
// (B, H, T).  Element type T is bf16 or fp16 (tensor cores: mma.sync .bf16 / .f16 operands,
// fp32 accumulation) or fp32 (CUDA cores).  fp16 (dtype code 2) is bf16's path with the
// operand type swapped: P and dS rounded to fp16 where the bf16 kernels round them to bf16
// (__floats2half2_rn), outputs rounded to nearest into fp16 (a value past 65504 becomes inf:
// no conversion saturates, so an overflow reaches the loss scaler); the scores, the biases
// (NEG_INF included), m, l, lse and delta stay fp32.
//
// What each kernel computes, as the Pallas code does:
//   forward  S = Q K^T * scale (+ biases), masked (k_pos < T, q_pos >= k_pos when causal,
//            the tile's live cells) with NEG_INF = -1e30; online softmax over the visited
//            k tiles with fp32 m / l / acc; P rounded to T before P V; O = acc / l;
//            lse = m + log(l); a row that saw no live key writes O = 0 and lse = NEG_INF
//            (row_live, 278-283).
//   dK/dV    per k tile, over the visited q tiles: P = exp(S - lse) (0 where masked, and
//            q_pos < T is part of the mask), dV += P^T dO with P rounded to T,
//            dS = P * (dO V^T - delta) * scale, dK += dS^T Q with dS rounded to T.
//   dQ       per q tile, over the visited k tiles: the same P and dS, dQ += dS K.
//   delta = rowsum(dO * O) is computed by the caller in fp32 (XLA did it outside Pallas).
//   A row with no live key (lse = NEG_INF, e.g. every key masked by a NEG_INF bias) has
//   P = 0 in the biased and LUT backward: its output is the constant 0.  (The Pallas
//   backward computes exp(S - lse) = exp(0) = 1 there; see ROADMAP.md section C.)
//
// What bounds them on this card: at the training shapes (T 1024-2048, D = 64, bf16) the
// forward does 4·D flops per (q, k) pair for 4·2 bytes per q or k row, so its
// arithmetic intensity is far above the ~295 flops per byte at which the H100's tensor
// cores, not its memory, become the limit; the backward kernels do 4 and 3 products per
// pair.  So the design keeps every product on the tensor cores (mma.sync m16n8k16, bf16
// in, fp32 accumulate) and keeps S, P and dS out of device memory:
//   * one block of 4 warps owns a 64-row tile (q rows in the forward and dQ kernels,
//     k rows in the dK/dV kernel); each warp owns 16 of those rows and loops over the
//     other side's 64-row tiles, so every block writes only its own output tile: no
//     atomics, deterministic results (the Pallas grid's sequential inner dimension
//     becomes the loop inside the block; a LUT row with no live tile writes zeros);
//   * tiles are staged global -> shared memory with 16-byte cp.async copies; the rows
//     past T are zero-filled and masked, so any T works without padded copies;
//   * every product is C(16x8) += A(16x16) * B(16x8).  The warp's own rows (Q, K, V,
//     dO) are loaded as A fragments with ldmatrix; the B operands come from the
//     row-major shared tiles with ldmatrix, or ldmatrix.trans where the product needs
//     the tile transposed (V in the forward, Q and dO in dK/dV, K in dQ), so no
//     transposed copy is ever made;
//   * P and dS go from the fp32 accumulators straight into A fragments in registers,
//     rounded to bf16 exactly where the Pallas code rounds them;
//   * only tiles crossing the diagonal, the ragged end, a partly live layout cell set,
//     or carrying a bias take the per-element mask; causal tiles wholly above the
//     diagonal are skipped (flash_attention.py:208, 646, 718); the forward and dQ grids
//     start with the longest q tiles;
//   * scores are kept in log2 units (S * scale * log2 e, one FMA) so every exponential
//     is one exp2f; lse is converted back to natural log on output;
//   * each block double-buffers (or, in the ring, triple-buffers) the tiles it loops
//     over: cp.async copies the next tiles global -> shared while the warps run this
//     tile's products.  The key bias rides in the same stage (64 floats), the (T, T)
//     score bias is read straight from global memory.
// Rows of shared tiles are padded by 8 elements so the 8 row addresses of an ldmatrix
// fall in different banks.  The fp32 path runs the same tiling on the CUDA cores, with
// P / dS staged through a per-warp shared tile.  The dense 16-bit forward at head dims 64
// and 128 runs in flash_attention_fwd_sm90.cu instead (TMA, an mbarrier ring fed by a
// producer warp, wgmma, 128-row q tiles); the dense fwd_kernel keeps fp32 and head dim
// 96, and every kernel here is still mma.sync with cp.async.
//
// C interface for ctypes (in the .cu files): each entry returns cudaGetLastError()
// after the launch (0 on success), or -1 for a dtype / head dim / shape it was not
// built for.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// The banded forward's schedule (flash_attention_band_merge_fwd.cu), a kernel parameter:
// the band width W and the layout block Lb, the global k tiles (ascending) that q tiles
// reach below their band, and a bit per layout column that is a global one.  Sized for
// T <= 65536: at most 1024 tiles of 64 rows and 4096 layout columns of 16.
constexpr int kMaxGlobalTiles = 1024;
constexpr int kMaxLayoutCols = 4096;
struct Band {
  int w, lb, cell_shift, n_gtiles;
  unsigned short gtile[kMaxGlobalTiles];
  unsigned int gbits[kMaxLayoutCols / 32];
};

// The optional operands of the biased, LUT and banded entries (a ctypes Structure on the
// host).
struct Extra {
  const int* map;
  const int* mask;
  const int* len;
  const float* kbias;
  const float* abias;
  int width, heads, cell_shift;
  const Band* band;
};

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16 * kWarps;   // q rows per tile
constexpr int kBK = 64;            // k rows per tile
constexpr int kPad = 8;            // shared-row padding, elements
constexpr float kNegInf = -1e30f;  // flash_attention.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kBQ == kBK, "the dK/dV kernel gives each warp 16 of the kBK key rows");

using bf16 = __nv_bfloat16;
using f16 = __half;
// whether T is a 16-bit element type (bf16 or fp16: the tensor-core path)
template <typename T>
constexpr bool k16Bit = std::is_same<T, bf16>::value || std::is_same<T, f16>::value;

struct Strides {
  long long b, t, h;  // elements
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  Strides sq, sk, sv, sdo;
  void* out0;          // O (forward), dQ (dq kernel), dK (dkdv kernel)
  void* out1;          // dV (dkdv kernel)
  float* lse;          // written by the forward, read by the backward kernels
  const float* delta;  // backward only
  int B, T, H, causal;
  float scale;
  // kLut: for head layout hl and row r of the outer loop (the q tile of the forward and
  // dQ kernels, the k tile of the dK/dV kernel), lut_len[hl * rows + r] tiles are live:
  // tile ids lut_map[(hl * rows + r) * lut_width + j] in ascending order, with their
  // cell masks in lut_mask at the same place (-1: every element live; else bit
  // (q_cell << (6 - cell_shift)) + k_cell of the 64 / 2^cell_shift cells per side).
  // hl = h when lut_heads == H, 0 when the layout is shared (lut_heads == 1).
  const int* lut_map;
  const int* lut_mask;
  const int* lut_len;
  int lut_width, lut_heads, cell_shift;
  // kBias: additive fp32 biases, each optional (null)
  const float* kbias;  // (B, T) over keys
  const float* abias;  // (T, T) over (q, k) positions
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
template <> __device__ __forceinline__ f16 from_f<f16>(float x) { return __float2half_rn(x); }

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// ---------------------------------------------------------------- tile staging
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; zero-filled when !pred
// (the source address is then not read, but must still be a valid one)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue dst[r][c] = src[t0 + r][c] for r < 64, c < D; rows at or past T are zero.  NT: the
// block's threads.
template <typename T, int D, int NT = kThreads>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, Strides s, int b, int h,
                                          int t0, int T_len) {
  constexpr int kEpv = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kVpr = D / kEpv;        // vectors per row
  const T* base = src + b * s.b + h * s.h;
  for (int i = threadIdx.x; i < 64 * kVpr; i += NT) {
    const int r = i / kVpr, c = (i % kVpr) * kEpv, t = t0 + r;
    cp_async16(dst + r * ld + c, base + (t < T_len ? t : 0) * s.t + c, t < T_len);
  }
}

// Issue dst[i] = stat[t0 + i] for i < 64 (zero at or past T).
__device__ __forceinline__ void load_stat(float* dst, const float* stat, int t0, int T_len) {
  for (int i = threadIdx.x; i < 64; i += kThreads) {
    const int t = t0 + i;
    cp_async4(dst + i, stat + (t < T_len ? t : 0), t < T_len);
  }
}

// ---------------------------------------------------------------- LUT rows
struct LutRow {
  const int* map;
  const int* mask;
  int len;
};

__device__ __forceinline__ LutRow lut_row(const Args& a, int h, int r, int rows) {
  const long long row = static_cast<long long>(a.lut_heads == 1 ? 0 : h) * rows + r;
  return {a.lut_map + row * a.lut_width, a.lut_mask + row * a.lut_width, a.lut_len[row]};
}

// Is the layout cell holding (qi, ki), positions inside a 64 x 64 tile, live?
__device__ __forceinline__ bool cell_live(int mask, int cell_shift, int qi, int ki) {
  return (mask >> (((qi >> cell_shift) << (6 - cell_shift)) + (ki >> cell_shift))) & 1;
}

// ---------------------------------------------------------------- tensor cores
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c (16x8) += a (16x16) * b (16x8), operands of element type E (TY: its PTX type, bf16 or
// f16).  Accumulator layout: lane = 4 g + i holds rows g (c[0], c[1]) and g + 8 (c[2], c[3])
// at columns 2i, 2i + 1.
#define MMA16816(TY)                                                          \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "     \
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n" \
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
template <typename E>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<E, f16>::value)
    MMA16816("f16");
  else
    MMA16816("bf16");
}
#undef MMA16816

// two floats rounded to nearest into one word of E (bf16 or fp16): lo in the low half
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<E, f16>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// ---------------------------------------------------------------- A operands
// The A operand (16 x K) of a warp's products.  bf16 and fp16: mma fragments in registers,
// loaded with ldmatrix or packed from fp32 accumulators.  fp32: a pointer to the rows in
// shared memory; accumulators are first stored to the warp's scratch tile.
template <typename T, int K> struct FragA;

template <typename E, int K> struct Frag16 {
  uint32_t r[K / 16][4];

  __device__ __forceinline__ void load(const E* A, int lda) {
    const int lane = lane_id();
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      ldsm_x4(r[kk], A + (lane & 15) * lda + kk * 16 + (lane >> 4) * 8);
  }

  // from the accumulators of a (16 x K) product, rounded to E
  __device__ __forceinline__ void from_acc(const float (&v)[K / 8][4], E*, int) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      r[kk][0] = pack2<E>(v[2 * kk][0], v[2 * kk][1]);
      r[kk][1] = pack2<E>(v[2 * kk][2], v[2 * kk][3]);
      r[kk][2] = pack2<E>(v[2 * kk + 1][0], v[2 * kk + 1][1]);
      r[kk][3] = pack2<E>(v[2 * kk + 1][2], v[2 * kk + 1][3]);
    }
  }
};

template <int K> struct FragA<bf16, K> : Frag16<bf16, K> {};
template <int K> struct FragA<f16, K> : Frag16<f16, K> {};

template <int K> struct FragA<float, K> {
  const float* p;
  int ld;

  __device__ __forceinline__ void load(const float* A, int lda) {
    p = A;
    ld = lda;
  }

  __device__ __forceinline__ void from_acc(const float (&v)[K / 8][4], float* scratch, int lds) {
    const int lane = lane_id(), g = lane >> 2, q = (lane & 3) * 2;
    __syncwarp();  // the previous product read the scratch tile
#pragma unroll
    for (int n = 0; n < K / 8; ++n) {
      scratch[g * lds + n * 8 + q] = v[n][0];
      scratch[g * lds + n * 8 + q + 1] = v[n][1];
      scratch[(g + 8) * lds + n * 8 + q] = v[n][2];
      scratch[(g + 8) * lds + n * 8 + q + 1] = v[n][3];
    }
    __syncwarp();
    p = scratch;
    ld = lds;
  }
};

// acc (16 x N) += A (16 x K) * B (K x N).  B is read from shared memory: with kTransB
// false it is given as its transpose, rows n of K contiguous elements (ldb apart); with
// kTransB true as rows k of N contiguous elements.
template <int N, int K, bool kTransB, typename E, std::enable_if_t<k16Bit<E>, int> = 0>
__device__ __forceinline__ void warp_mm(float (&acc)[N / 8][4], const FragA<E, K>& a,
                                        const E* B, int ldb) {
  const int lane = lane_id();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t b[4];
      if (kTransB)
        ldsm_x4_t(b, B + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + j * 16 +
                         (lane >> 4) * 8);
      else
        ldsm_x4(b, B + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldb + kk * 16 +
                       ((lane >> 3) & 1) * 8);
      mma16816<E>(acc[2 * j], a.r[kk], b[0], b[1]);
      mma16816<E>(acc[2 * j + 1], a.r[kk], b[2], b[3]);
    }
  }
}

// The fp32 path: the same accumulator elements, computed on the CUDA cores.
template <int N, int K, bool kTransB>
__device__ __forceinline__ void warp_mm(float (&acc)[N / 8][4], const FragA<float, K>& a,
                                        const float* B, int ldb) {
  const int lane = lane_id(), g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    const float lo = a.p[g * a.ld + kk], hi = a.p[(g + 8) * a.ld + kk];
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const int c = n * 8 + q;
      const float b0 = kTransB ? B[kk * ldb + c] : B[c * ldb + kk];
      const float b1 = kTransB ? B[kk * ldb + c + 1] : B[(c + 1) * ldb + kk];
      acc[n][0] = fmaf(lo, b0, acc[n][0]);
      acc[n][1] = fmaf(lo, b1, acc[n][1]);
      acc[n][2] = fmaf(hi, b0, acc[n][2]);
      acc[n][3] = fmaf(hi, b1, acc[n][3]);
    }
  }
}

// out[b, row, h, :] of a contiguous (B, T, H, D) tensor, from a warp's accumulator rows.
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* out, const float (&acc)[D / 8][4], const int (&row)[2],
                                           const Args& a, int b, int h, const float (&mul)[2]) {
  const int q = (lane_id() & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.T) continue;
    T* dst = out + ((static_cast<long long>(b) * a.T + row[r]) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      dst[n * 8 + q] = from_f<T>(acc[n][2 * r] * mul[r]);
      dst[n * 8 + q + 1] = from_f<T>(acc[n][2 * r + 1] * mul[r]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// per-warp scratch rows for P / dS: only the fp32 path stages them in shared memory
template <typename T>
__host__ __device__ constexpr int scratch_rows() {
  return std::is_same<T, float>::value ? kWarps * 16 : 0;
}

constexpr int kLdS = 64 + kPad;  // scratch row stride (64 columns: kBQ == kBK)

// The forward's stage count: the ring's three stages of an fp32 d=128 tile do not fit
// the 227 KB of shared memory a block may use, so that one instantiation keeps two.
template <typename T, int D, int kStages>
constexpr int fwd_stages() {
  return (kStages > 2 && sizeof(T) == 4 && D == 128) ? 2 : kStages;
}

// ---------------------------------------------------------------- forward
template <typename T, int D, bool kBias, int kStages>
size_t fwd_smem() {
  return sizeof(T) * (static_cast<size_t>(kBQ + 2 * kStages * kBK) * (D + kPad) +
                      static_cast<size_t>(scratch_rows<T>()) * kLdS) +
         (kBias ? sizeof(float) * kStages * kBK : 0);
}

template <typename T, int D, bool kLut, bool kBias, int kStages>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDD = D + kPad, kStage = 2 * kBK * LDD;
  T* sQ = reinterpret_cast<T*>(smem);  // [kBQ][LDD]
  T* sKV = sQ + kBQ * LDD;             // kStages stages of K then V, [kBK][LDD] each
  T* sP = sKV + kStages * kStage;      // fp32 only: [kBQ][kLdS], 16 rows per warp
  float* sKb = reinterpret_cast<float*>(sP + scratch_rows<T>() * kLdS);  // kBias: [kStages][kBK]

  const int nq = cdiv(a.T, kBQ);
  const int qt = nq - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qt * kBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int g = lane >> 2, qd = (lane & 3) * 2;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  T* myP = sP + warp * 16 * kLdS;
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  int nk;
  LutRow lut = {nullptr, nullptr, 0};
  if constexpr (kLut) {
    lut = lut_row(a, h, qt, nq);
    nk = lut.len;
  } else {
    nk = cdiv(a.T, kBK);
    if (a.causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);
  }
  const float scale2 = a.scale * kLog2e;
  // the j-th visited k tile: its first key and its stage's copies
  auto tile0 = [&](int j) { return (kLut ? lut.map[j] : j) * kBK; };
  auto issue = [&](int j, int stage) {
    T* dst = sKV + stage * kStage;
    const int k0 = tile0(j);
    load_rows<T, D>(dst, LDD, K, a.sk, b, h, k0, a.T);
    load_rows<T, D>(dst + kBK * LDD, LDD, V, a.sv, b, h, k0, a.T);
    if constexpr (kBias) {
      if (a.kbias) load_stat(sKb + stage * kBK, a.kbias + static_cast<long long>(b) * a.T, k0, a.T);
    }
  };

  load_rows<T, D>(sQ, LDD, static_cast<const T*>(a.q), a.sq, b, h, q0, a.T);
  if (!kLut || nk > 0) issue(0, 0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s + 1 < kStages; ++s) {  // the ring: slot s in flight before slot 0 computes
    if (s < nk) issue(s, s);
    cp_async_commit();
  }
  FragA<T, D> qa;
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int j = 0; j < nk; ++j) {
    const int k0 = tile0(j);
    const int stage = kStages == 2 ? (j & 1) : j % kStages;
    const T* sK = sKV + stage * kStage;
    const T* sV = sK + kBK * LDD;
    if constexpr (kStages == 2) {
      if (j + 1 < nk) {  // the next tile's loads overlap this tile's products
        issue(j + 1, (j + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      // slot j + kStages - 1 refills the stage that slot j - 1 left (every warp passed
      // the barrier at the end of iteration j - 1); a group is committed even when
      // empty, so "all but the newest kStages - 1 groups" is always "slot j is in"
      if (j + kStages - 1 < nk) issue(j + kStages - 1, (j + kStages - 1) % kStages);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
    }
    __syncthreads();
    if (j == 0) qa.load(sQ + warp * 16 * LDD, LDD);

    float s[kBK / 8][4] = {};
    warp_mm<kBK, D, false>(s, qa, sK, LDD);  // S = Q K^T
    // scores in log2 units (S * scale * log2 e), so each exponential is one exp2f;
    // only a tile crossing the diagonal, the ragged end or a partly live cell set, or a
    // biased one, needs the per-element pass
    const int cmask = kLut ? lut.mask[j] : -1;
    const bool masked = k0 + kBK > a.T || (a.causal && k0 + kBK - 1 > q0) ||
                        (kLut && cmask != -1) || kBias;
    const float* kb = sKb + stage * kBK;
    float mc[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + n * 8 + qd + (e & 1);
        if constexpr (kLut || kBias) {
          bool valid = !masked || (col < a.T && (!a.causal || row[r] >= col));
          if constexpr (kLut)
            valid = valid && (cmask == -1 || cell_live(cmask, a.cell_shift, row[r] - q0, col - k0));
          float x = s[n][e] * scale2;
          if constexpr (kBias) {
            if (valid) {
              float bias = 0.f;
              if (a.kbias) bias = kb[col - k0];
              if (a.abias && row[r] < a.T)
                bias += __ldg(a.abias + static_cast<long long>(row[r]) * a.T + col);
              x = fmaf(bias, kLog2e, x);
            }
          }
          s[n][e] = valid ? x : kNegInf;
        } else {
          const bool valid = !masked || (col < a.T && (!a.causal || row[r] >= col));
          s[n][e] = valid ? s[n][e] * scale2 : kNegInf;
        }
        mc[r] = fmaxf(mc[r], s[n][e]);
      }
    }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mc[r]));
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[n][e] == kNegInf ? 0.f : exp2f(s[n][e] - m[r]);
        s[n][e] = p;
        ls[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(ls[r]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    FragA<T, kBK> pa;
    pa.from_acc(s, myP, kLdS);
    warp_mm<D, kBK, true>(o, pa, sV, LDD);  // O += P V
    __syncthreads();  // this stage is refilled at the next iteration
  }
  if constexpr (kLut || kStages > 2) cp_async_wait<0>();  // empty rows, the ring's tail

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = m[r] > kNegInf * 0.5f;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    inv[r] = live ? 1.f / l_safe : 0.f;
    if ((lane & 3) == 0 && row[r] < a.T)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.T + row[r]] =
          live ? m[r] * kLn2 + logf(l_safe) : kNegInf;
  }
  write_rows<T, D>(static_cast<T*>(a.out0), o, row, a, b, h, inv);
}

// ---------------------------------------------------------------- dK / dV
template <typename T, int D>
size_t dkdv_smem() {
  return sizeof(T) * (static_cast<size_t>(2 * kBK + 4 * kBQ) * (D + kPad) +
                      static_cast<size_t>(scratch_rows<T>()) * kLdS) +
         sizeof(float) * 4 * kBQ;
}

template <typename T, int D, bool kLut, bool kBias>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDD = D + kPad, kStage = 2 * kBQ * LDD;
  T* sK = reinterpret_cast<T*>(smem);  // [kBK][LDD]
  T* sV = sK + kBK * LDD;              // [kBK][LDD]
  T* sQO = sV + kBK * LDD;             // 2 stages of Q then dO, [kBQ][LDD] each
  T* sS = sQO + 2 * kStage;            // fp32 only: [kBK][kLdS], 16 rows per warp
  float* sStat = reinterpret_cast<float*>(sS + scratch_rows<T>() * kLdS);  // 2 x {lse, delta}

  const int kt = blockIdx.x;
  const int k0 = kt * kBK;  // longest causal columns first
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int g = lane >> 2, qd = (lane & 3) * 2;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.T;
  T* myS = sS + warp * 16 * kLdS;
  const T* Q = static_cast<const T*>(a.q);
  const T* dO = static_cast<const T*>(a.dout);
  const int nq = cdiv(a.T, kBQ);
  // the visited q tiles: q tiles first..nq-1 (causal: q tile i meets this k tile iff
  // i * kBQ + kBQ - 1 >= k0), or slots 0..qlen-1 of the LUT's transposed row (qmap)
  int first, end;
  LutRow lut = {nullptr, nullptr, 0};
  if constexpr (kLut) {
    lut = lut_row(a, h, kt, cdiv(a.T, kBK));
    first = 0;
    end = lut.len;
  } else {
    first = a.causal ? k0 / kBQ : 0;
    end = nq;
  }
  const float scale2 = a.scale * kLog2e;
  auto tile0 = [&](int i) { return (kLut ? lut.map[i] : i) * kBQ; };
  // the key bias of this thread's two keys, in log2 units
  float kb2[2] = {0.f, 0.f};
  if constexpr (kBias) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (a.kbias && key[r] < a.T)
        kb2[r] = a.kbias[static_cast<long long>(b) * a.T + key[r]] * kLog2e;
  }

  auto issue_q_tile = [&](int i, int stage) {
    T* dst = sQO + stage * kStage;
    const int q0 = tile0(i);
    load_rows<T, D>(dst, LDD, Q, a.sq, b, h, q0, a.T);
    load_rows<T, D>(dst + kBQ * LDD, LDD, dO, a.sdo, b, h, q0, a.T);
    load_stat(sStat + stage * 2 * kBQ, a.lse + stat0, q0, a.T);
    load_stat(sStat + stage * 2 * kBQ + kBQ, a.delta + stat0, q0, a.T);
  };
  load_rows<T, D>(sK, LDD, static_cast<const T*>(a.k), a.sk, b, h, k0, a.T);
  load_rows<T, D>(sV, LDD, static_cast<const T*>(a.v), a.sv, b, h, k0, a.T);
  if (!kLut || end > 0) issue_q_tile(first, 0);
  cp_async_commit();

  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int i = first; i < end; ++i) {
    const int q0 = tile0(i), stage = (i - first) & 1;
    const T* sQ = sQO + stage * kStage;
    const T* sdO = sQ + kBQ * LDD;
    const float* sLse = sStat + stage * 2 * kBQ;
    const float* sDelta = sLse + kBQ;
    if (i + 1 < end) {  // the next tile's loads overlap this tile's products
      issue_q_tile(i + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // the warp's K and V rows as A fragments, reloaded per tile to spare registers
    float st[kBQ / 8][4] = {}, dpt[kBQ / 8][4] = {};
    FragA<T, D> kva;
    kva.load(sK + warp * 16 * LDD, LDD);
    warp_mm<kBQ, D, false>(st, kva, sQ, LDD);   // S^T = K Q^T
    kva.load(sV + warp * 16 * LDD, LDD);
    warp_mm<kBQ, D, false>(dpt, kva, sdO, LDD);  // dP^T = V dO^T
    // P = exp2(S * scale * log2 e - lse * log2 e); only a tile crossing the diagonal,
    // a ragged end or a partly live cell set, or a biased one, needs the mask
    const int cmask = kLut ? lut.mask[i] : -1;
    const bool masked = q0 + kBQ > a.T || k0 + kBK > a.T || (a.causal && q0 < k0 + kBK - 1) ||
                        (kLut && cmask != -1) || kBias;
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = n * 8 + qd + (e & 1), qpos = q0 + c;
        bool valid =
            !masked || (qpos < a.T && key[r] < a.T && (!a.causal || qpos >= key[r]));
        float p;
        if constexpr (kLut || kBias) {
          if constexpr (kLut)
            valid = valid && (cmask == -1 || cell_live(cmask, a.cell_shift, c, key[r] - k0));
          float bias2 = 0.f;  // log2 units
          if constexpr (kBias) {
            bias2 = kb2[r];
            if (a.abias && valid)
              bias2 = fmaf(__ldg(a.abias + static_cast<long long>(qpos) * a.T + key[r]), kLog2e,
                           bias2);
          }
          const float lse = sLse[c];
          valid = valid && lse > kNegInf * 0.5f;  // a row with no live key: O = 0
          p = valid ? exp2f(fmaf(st[n][e], scale2, bias2 - lse * kLog2e)) : 0.f;
        } else {
          p = valid ? exp2f(fmaf(st[n][e], scale2, -sLse[c] * kLog2e)) : 0.f;
        }
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - sDelta[c]) * a.scale;
      }
    }
    FragA<T, kBQ> fa;
    fa.from_acc(st, myS, kLdS);
    warp_mm<D, kBQ, true>(dv, fa, sdO, LDD);  // dV += P^T dO
    fa.from_acc(dpt, myS, kLdS);
    warp_mm<D, kBQ, true>(dk, fa, sQ, LDD);   // dK += dS^T Q
    __syncthreads();  // this stage is refilled at the next iteration
  }
  if constexpr (kLut) cp_async_wait<0>();  // a k tile no q tile visits
  const float one[2] = {1.f, 1.f};
  write_rows<T, D>(static_cast<T*>(a.out0), dk, key, a, b, h, one);
  write_rows<T, D>(static_cast<T*>(a.out1), dv, key, a, b, h, one);
}

// ---------------------------------------------------------------- dQ
template <typename T, int D, bool kBias>
size_t dq_smem() {
  return sizeof(T) * (static_cast<size_t>(2 * kBQ + 4 * kBK) * (D + kPad) +
                      static_cast<size_t>(scratch_rows<T>()) * kLdS) +
         (kBias ? sizeof(float) * 2 * kBK : 0);
}

template <typename T, int D, bool kLut, bool kBias>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDD = D + kPad, kStage = 2 * kBK * LDD;
  T* sQ = reinterpret_cast<T*>(smem);  // [kBQ][LDD]
  T* sdO = sQ + kBQ * LDD;             // [kBQ][LDD]
  T* sKV = sdO + kBQ * LDD;            // 2 stages of K then V, [kBK][LDD] each
  T* sS = sKV + 2 * kStage;            // fp32 only: [kBQ][kLdS], 16 rows per warp
  float* sKb = reinterpret_cast<float*>(sS + scratch_rows<T>() * kLdS);  // kBias: [2][kBK]

  const int nq = cdiv(a.T, kBQ);
  const int qt = nq - 1 - blockIdx.x;
  const int q0 = qt * kBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int g = lane >> 2, qd = (lane & 3) * 2;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.T;
  const float scale2 = a.scale * kLog2e;
  float lse2[2], delta[2];  // lse in log2 units
  bool live[2] = {true, true};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = row[r] < a.T ? a.lse[stat0 + row[r]] * kLog2e : 0.f;
    delta[r] = row[r] < a.T ? a.delta[stat0 + row[r]] : 0.f;
    if constexpr (kLut || kBias) live[r] = lse2[r] > kNegInf * 0.5f * kLog2e;  // O = 0 rows
  }
  T* myS = sS + warp * 16 * kLdS;
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  int nk;
  LutRow lut = {nullptr, nullptr, 0};
  if constexpr (kLut) {
    lut = lut_row(a, h, qt, nq);
    nk = lut.len;
  } else {
    nk = cdiv(a.T, kBK);
    if (a.causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);
  }
  auto tile0 = [&](int j) { return (kLut ? lut.map[j] : j) * kBK; };
  auto issue = [&](int j, int stage) {
    T* dst = sKV + stage * kStage;
    const int k0 = tile0(j);
    load_rows<T, D>(dst, LDD, K, a.sk, b, h, k0, a.T);
    load_rows<T, D>(dst + kBK * LDD, LDD, V, a.sv, b, h, k0, a.T);
    if constexpr (kBias) {
      if (a.kbias) load_stat(sKb + stage * kBK, a.kbias + static_cast<long long>(b) * a.T, k0, a.T);
    }
  };

  load_rows<T, D>(sQ, LDD, static_cast<const T*>(a.q), a.sq, b, h, q0, a.T);
  load_rows<T, D>(sdO, LDD, static_cast<const T*>(a.dout), a.sdo, b, h, q0, a.T);
  if (!kLut || nk > 0) issue(0, 0);
  cp_async_commit();

  float dq[D / 8][4] = {};
  for (int j = 0; j < nk; ++j) {
    const int k0 = tile0(j), stage = j & 1;
    const T* sK = sKV + stage * kStage;
    const T* sV = sK + kBK * LDD;
    if (j + 1 < nk) {  // the next tile's loads overlap this tile's products
      issue(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // the warp's Q and dO rows as A fragments, reloaded per tile to spare registers
    float s[kBK / 8][4] = {}, dp[kBK / 8][4] = {};
    FragA<T, D> qda;
    qda.load(sQ + warp * 16 * LDD, LDD);
    warp_mm<kBK, D, false>(s, qda, sK, LDD);   // S = Q K^T
    qda.load(sdO + warp * 16 * LDD, LDD);
    warp_mm<kBK, D, false>(dp, qda, sV, LDD);  // dP = dO V^T
    const int cmask = kLut ? lut.mask[j] : -1;
    const bool masked = q0 + kBQ > a.T || k0 + kBK > a.T || (a.causal && k0 + kBK - 1 > q0) ||
                        (kLut && cmask != -1) || kBias;
    const float* kb = sKb + stage * kBK;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + n * 8 + qd + (e & 1);
        bool valid =
            !masked || (row[r] < a.T && col < a.T && (!a.causal || row[r] >= col));
        float p;
        if constexpr (kLut || kBias) {
          if constexpr (kLut)
            valid = valid && (cmask == -1 || cell_live(cmask, a.cell_shift, row[r] - q0, col - k0));
          float bias2 = 0.f;  // log2 units
          if constexpr (kBias) {
            if (valid) {
              float bias = 0.f;
              if (a.kbias) bias = kb[col - k0];
              if (a.abias) bias += __ldg(a.abias + static_cast<long long>(row[r]) * a.T + col);
              bias2 = bias * kLog2e;
            }
          }
          valid = valid && live[r];
          p = valid ? exp2f(fmaf(s[n][e], scale2, bias2 - lse2[r])) : 0.f;
        } else {
          p = valid ? exp2f(fmaf(s[n][e], scale2, -lse2[r])) : 0.f;
        }
        dp[n][e] = p * (dp[n][e] - delta[r]) * a.scale;
      }
    }
    FragA<T, kBK> dsa;
    dsa.from_acc(dp, myS, kLdS);
    warp_mm<D, kBK, true>(dq, dsa, sK, LDD);  // dQ += dS K
    __syncthreads();  // this stage is refilled at the next iteration
  }
  if constexpr (kLut) cp_async_wait<0>();  // a q tile with no live k tile
  const float one[2] = {1.f, 1.f};
  write_rows<T, D>(static_cast<T*>(a.out0), dq, row, a, b, h, one);
}

// ---------------------------------------------------------------- launch
enum Which { kFwd, kDkdv, kDq };

template <Which W, bool kLut, bool kBias, int kStages, typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(W == kDkdv ? cdiv(a.T, kBK) : cdiv(a.T, kBQ), a.B * a.H);
  void (*kernel)(Args);
  size_t smem;
  if constexpr (W == kFwd) {
    constexpr int S = fwd_stages<T, D, kStages>();
    kernel = fwd_kernel<T, D, kLut, kBias, S>;
    smem = fwd_smem<T, D, kBias, S>();
  } else if constexpr (W == kDkdv) {
    kernel = dkdv_kernel<T, D, kLut, kBias>;
    smem = dkdv_smem<T, D>();
  } else {
    kernel = dq_kernel<T, D, kLut, kBias>;
    smem = dq_smem<T, D, kBias>();
  }
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 fp32 (CUDA cores), 1 bf16, 2 fp16 (tensor cores); head dims 64, 96, 128
template <Which W, bool kLut, bool kBias, int kStages = 2>
int dispatch(int dtype, int head_dim, const Args& a, cudaStream_t stream) {
  if (a.B * a.H > 65535) return -1;
  if (a.T == 0 || a.B * a.H == 0) return 0;
  if (dtype == 1) {
    switch (head_dim) {
      case 64: return launch<W, kLut, kBias, kStages, bf16, 64>(a, stream);
      case 96: return launch<W, kLut, kBias, kStages, bf16, 96>(a, stream);
      case 128: return launch<W, kLut, kBias, kStages, bf16, 128>(a, stream);
      default: return -1;
    }
  }
  if (dtype == 2) {
    switch (head_dim) {
      case 64: return launch<W, kLut, kBias, kStages, f16, 64>(a, stream);
      case 96: return launch<W, kLut, kBias, kStages, f16, 96>(a, stream);
      case 128: return launch<W, kLut, kBias, kStages, f16, 128>(a, stream);
      default: return -1;
    }
  }
  if (dtype == 0) {
    switch (head_dim) {
      case 64: return launch<W, kLut, kBias, kStages, float, 64>(a, stream);
      case 96: return launch<W, kLut, kBias, kStages, float, 96>(a, stream);
      case 128: return launch<W, kLut, kBias, kStages, float, 128>(a, stream);
      default: return -1;
    }
  }
  return -1;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const long long* strides, int B, int T, int H, int causal, float scale,
               const Extra* x = nullptr) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.sdo = {strides[9], strides[10], strides[11]};
  a.B = B;
  a.T = T;
  a.H = H;
  a.causal = causal;
  a.scale = scale;
  if (x != nullptr) {
    a.lut_map = x->map;
    a.lut_mask = x->mask;
    a.lut_len = x->len;
    a.lut_width = x->width;
    a.lut_heads = x->heads;
    a.cell_shift = x->cell_shift;
    a.kbias = x->kbias;
    a.abias = x->abias;
  }
  return a;
}

}  // namespace

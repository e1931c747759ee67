// Weight-int8 matrix product for Hopper (sm_90a): bf16 activations times int8 weights,
// accumulated in fp32, scaled and cast in the epilogue (W8A16).
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/transformer/int8_matmul.py:
//   int8_mm_nt  <- _kernel_nt (int8_matmul.py:45; the weight q is (K, N), N contiguous)
//   int8_mm_t   <- _kernel_t  (int8_matmul.py:53; q is (N, K), K contiguous: the tied head)
// both built by _int8_mm_tpu (62-80), and the XLA branch of int8_matmul (109-112), which
// computes the same function: out = cast(scale * sum_k bf16(x[m, k]) * bf16(q[k, n])), the
// products exact (|q| <= 128 is exact in bf16) and summed in fp32, the scale per tensor
// (one value) or per output channel (N values), the cast to bf16 or fp32 last.
//
// Layouts: x (M, K) bf16 row-major; q int8 as above; scale fp32; out (M, N) row-major, bf16
// or fp32.  M, N and K are arbitrary: the tails are masked in place (rows and columns past
// the end are zero-filled in shared memory and never stored), with no padded copies.
// 16-byte loads are used where the wrapper says the rows allow them (x_vec: K % 8 == 0
// and x 16-byte aligned; q_vec: q's row length % 16 == 0 and q 16-byte aligned), and
// element loads elsewhere.
//
// What bounds it on this card: at decode (M = 8 rows, one per serving slot) every weight
// byte is read once for 2·M flops, about 16 flops per byte, far below the ~295 at which
// the H100's tensor cores become the limit: the weight bytes bound it, so the point of
// the kernel is to stream int8 (half of bf16's bytes) and never write a widened copy.  At
// prefill (M up to 512) the flops bound it.  The design:
//   * one block of 4 warps owns a BM x BN output tile and loops over K in BK steps;
//     int8 weight tiles and bf16 x tiles are staged global -> shared with 16-byte
//     cp.async copies into a ring of kStages slots, so two tiles are in flight while one
//     is consumed;
//   * each thread converts the int8 chunks it copied (16 bytes -> 16 bf16, exact, with
//     byte permutes and fp32 subtractions in place of the slow conversion instructions)
//     into a bf16 tile in shared memory, from which the warps take mma fragments with ldmatrix
//     (ldmatrix.trans for the (K, N) layout), so no widened weight ever reaches device
//     memory;
//   * every product is mma.sync m16n8k16, bf16 in, fp32 accumulate;
//   * two tile shapes: 16 x 64 x 128 for M <= 16 (decode), 64 x 128 x 64 otherwise;
//   * split-K where the output tiles are too few to fill the 132 SMs (decode shapes):
//     block z of `splits` sums its share of the K tiles, writes the fp32 partial to a
//     workspace and counts itself in a per-tile counter; the block that counts last sums
//     the partials in the fixed order z = 0, 1, ..., applies the scale and stores, then
//     resets the counter.  One launch, no floating-point atomics: the same inputs give
//     the same bits on every call;
//   * the scale multiplies the fp32 sum and the cast to the output type comes last, as
//     int8_matmul.py:114-123 does.
// wgmma, TMA and warp specialisation are later work.
//
// C interface for ctypes: each entry returns cudaGetLastError() after the launch (0 on
// success), or -1 for an output type or tile configuration it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;
using bf16 = __nv_bfloat16;

struct Args {
  const bf16* x;        // (M, K)
  const int8_t* q;      // (K, N) or (N, K)
  const float* scale;   // 1 or N values
  void* out;            // (M, N)
  float* ws;            // split-K partials: tiles x splits x BM x BN fp32
  int* counters;        // one per output tile, zero between launches
  int M, N, K;
  int per_channel;      // scale has N values
  int kt_per_split;     // K tiles per split
  int x_vec, q_vec;     // 16-byte loads allowed
};

template <int BM_, int BN_, int BK_, int WM_, int WN_> struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  static constexpr int MF = WTM / 16, NF = WTN / 8;  // mma fragments per warp
  static_assert(WM * WN * 32 == kThreads, "4 warps");
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0, "mma tiling");
};
using Small = Cfg<16, 64, 128, 1, 4>;  // M <= 16: decode
using Large = Cfg<64, 128, 64, 2, 2>;  // M > 16: prefill

// Shared-memory plan of one configuration and layout.  The int8 tile has QR rows of QC
// bytes: (BK, BN) for the (K, N) layout, (BN, BK) for the (N, K) one.
template <typename C, bool kTrans> struct Smem {
  static constexpr int XLD = C::BK + 8;                 // bf16, rows of the x tile
  static constexpr int QR = kTrans ? C::BN : C::BK;
  static constexpr int QC = kTrans ? C::BK : C::BN;
  static constexpr int QLD = QC + 16;                   // int8 bytes, ring rows
  static constexpr int BLD = QC + 8;                    // bf16, converted rows
  static constexpr int X_BYTES = kStages * C::BM * XLD * 2;
  static constexpr int Q_BYTES = kStages * QR * QLD;
  static constexpr int B_BYTES = QR * BLD * 2;
  static constexpr int BYTES = X_BYTES + Q_BYTES + B_BYTES;
  static constexpr int Q_CHUNKS = QR * QC / 16;         // 16-byte chunks per int8 tile
  static constexpr int X_CHUNKS = C::BM * C::BK / 8;    // 16-byte chunks per x tile
  static_assert(Q_CHUNKS % kThreads == 0 && X_CHUNKS % kThreads == 0, "whole chunks");
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// c (16x8) += a (16x16) * b (16x8).  Accumulator layout: lane = 4 g + i holds rows g
// (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2i, 2i + 1.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// 4 int8 (one word) -> 4 bf16 (two words), exact, without conversion instructions (which
// issue at 16 per SM per clock on this card): byte b + 128 becomes the low mantissa bits of
// 2^23 (fp32 bits 0x4B0000uu), 2^23 + 128 is subtracted (exact), and the upper halves of
// the fp32 results are the bf16 values (an integer of at most 8 significant bits has zero
// low halves).  Byte permutes at integer rate, subtractions at fp32 rate.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128 in each byte
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// 16 int8 -> 16 bf16 (exact: every int8 is a bf16)
__device__ __forceinline__ void widen16(bf16* dst, const int8_t* src) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  uint4 a, b;
  widen4(v.x, a.x, a.y);
  widen4(v.y, a.z, a.w);
  widen4(v.z, b.x, b.y);
  widen4(v.w, b.z, b.w);
  *reinterpret_cast<uint4*>(dst) = a;
  *reinterpret_cast<uint4*>(dst + 8) = b;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename C, bool kTrans, typename OutT>
__global__ void __launch_bounds__(kThreads) int8_mm_kernel(Args a) {
  using S = Smem<C, kTrans>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  int8_t* qs = reinterpret_cast<int8_t*>(smem + S::X_BYTES);
  bf16* bs = reinterpret_cast<bf16*>(smem + S::X_BYTES + S::Q_BYTES);
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;
  const int splits = gridDim.z, z = blockIdx.z;
  const int kt_all = cdiv(a.K, C::BK);
  const int kt0 = z * a.kt_per_split;
  const int kt_n = max(0, min(kt_all, kt0 + a.kt_per_split) - kt0);
  // q rows run over K for (K, N), over N for (N, K); the row length is the other extent
  const int q_rows = kTrans ? a.N : a.K, q_cols = kTrans ? a.K : a.N;

  // issue the copies of K tile kt into ring slot s (this thread's chunks only)
  auto load_tile = [&](int kt, int s) {
    const int k0 = kt * C::BK;
    bf16* xd = xs + s * C::BM * S::XLD;
#pragma unroll
    for (int j = 0; j < S::X_CHUNKS / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (C::BK / 8), c = (i % (C::BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      bf16* d = xd + r * S::XLD + c;
      if (gm < a.M && gk + 8 <= a.K && a.x_vec) {
        cp_async16(d, a.x + static_cast<long long>(gm) * a.K + gk);
      } else if (gm >= a.M || gk >= a.K) {
        *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
      } else {
        for (int e = 0; e < 8; ++e)
          d[e] = gk + e < a.K ? a.x[static_cast<long long>(gm) * a.K + gk + e]
                              : __float2bfloat16_rn(0.f);
      }
    }
    int8_t* qd = qs + s * S::QR * S::QLD;
    const int r0 = kTrans ? n0 : k0, c0 = kTrans ? k0 : n0;
#pragma unroll
    for (int j = 0; j < S::Q_CHUNKS / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (S::QC / 16), c = (i % (S::QC / 16)) * 16;
      const int gr = r0 + r, gc = c0 + c;
      int8_t* d = qd + r * S::QLD + c;
      if (gr < q_rows && gc + 16 <= q_cols && a.q_vec) {
        cp_async16(d, a.q + static_cast<long long>(gr) * q_cols + gc);
      } else if (gr >= q_rows || gc >= q_cols) {
        *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
      } else {
        for (int e = 0; e < 16; ++e)
          d[e] = gc + e < q_cols ? a.q[static_cast<long long>(gr) * q_cols + gc + e] : 0;
      }
    }
  };

  float acc[C::MF][C::NF][4];
#pragma unroll
  for (int mi = 0; mi < C::MF; ++mi)
#pragma unroll
    for (int nf = 0; nf < C::NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nf][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) load_tile(kt0 + s, s);
    cp_async_commit();
  }

  for (int t = 0; t < kt_n; ++t) {
    const int slot = t % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
    __syncthreads();               // every copy of tile t has landed; tile t-1 is consumed
    if (t + kStages - 1 < kt_n) load_tile(kt0 + t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    // widen the int8 chunks this thread copied into the bf16 tile
    const int8_t* qsrc = qs + slot * S::QR * S::QLD;
#pragma unroll
    for (int j = 0; j < S::Q_CHUNKS / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / (S::QC / 16), c = (i % (S::QC / 16)) * 16;
      widen16(bs + r * S::BLD + c, qsrc + r * S::QLD + c);
    }
    __syncthreads();
    const bf16* xt = xs + slot * C::BM * S::XLD;
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      uint32_t af[C::MF][4];
#pragma unroll
      for (int mi = 0; mi < C::MF; ++mi)
        ldsm_x4(af[mi], xt + (wm * C::WTM + mi * 16 + (lane & 15)) * S::XLD + kk * 16 +
                            (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < C::NF / 2; ++nj) {
        const int nb = wn * C::WTN + nj * 16;
        uint32_t b[4];
        if (kTrans)  // bf16 tile rows are n, K contiguous
          ldsm_x4(b, bs + (nb + (lane & 7) + ((lane >> 4) << 3)) * S::BLD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
        else  // bf16 tile rows are k, N contiguous
          ldsm_x4_t(b, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S::BLD + nb +
                           (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < C::MF; ++mi) {
          mma16816(acc[mi][2 * nj], af[mi], b[0], b[1]);
          mma16816(acc[mi][2 * nj + 1], af[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (splits > 1) {
    // partial sums of this split -> workspace; the last block of the tile reduces them
    constexpr int kAcc = C::MF * C::NF * 4;
    const long long tile = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
    float* mine = a.ws + (tile * splits + z) * kAcc * kThreads;
#pragma unroll
    for (int mi = 0; mi < C::MF; ++mi)
#pragma unroll
      for (int nf = 0; nf < C::NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[((mi * C::NF + nf) * 4 + e) * kThreads + tid] = acc[mi][nf][e];
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(a.counters + tile, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const float* all = a.ws + tile * splits * kAcc * kThreads;
#pragma unroll
    for (int mi = 0; mi < C::MF; ++mi)
#pragma unroll
      for (int nf = 0; nf < C::NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = (mi * C::NF + nf) * 4 + e;
          float v = __ldcg(all + j * kThreads + tid);
          for (int zz = 1; zz < splits; ++zz) v += __ldcg(all + (zz * kAcc + j) * kThreads + tid);
          acc[mi][nf][e] = v;
        }
    if (tid == 0) a.counters[tile] = 0;  // ready for the next launch on this stream
  }

  // epilogue: scale the fp32 sums, cast, store the rows and columns inside (M, N)
  const int g = lane >> 2, i2 = (lane & 3) * 2;
  const float s0 = a.scale[0];
  OutT* out = static_cast<OutT*>(a.out);
#pragma unroll
  for (int mi = 0; mi < C::MF; ++mi)
#pragma unroll
    for (int nf = 0; nf < C::NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * C::WTM + mi * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn * C::WTN + nf * 8 + i2 + (e & 1);
        if (m < a.M && n < a.N)
          out[static_cast<long long>(m) * a.N + n] =
              from_f<OutT>(acc[mi][nf][e] * (a.per_channel ? a.scale[n] : s0));
      }
}

template <typename C, bool kTrans, typename OutT>
int launch(Args a, int splits, cudaStream_t stream) {
  auto kernel = int8_mm_kernel<C, kTrans, OutT>;
  constexpr int bytes = Smem<C, kTrans>::BYTES;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs opting in
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(cdiv(a.N, C::BN), cdiv(a.M, C::BM), splits);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTrans>
int dispatch(int tile, int out_dtype, Args a, int splits, cudaStream_t stream) {
  // out_dtype: 0 fp32, 1 bf16 (the codes of ops/transformer/int8_matmul.py)
  if (tile == 0 && out_dtype == 0) return launch<Small, kTrans, float>(a, splits, stream);
  if (tile == 0 && out_dtype == 1) return launch<Small, kTrans, bf16>(a, splits, stream);
  if (tile == 1 && out_dtype == 0) return launch<Large, kTrans, float>(a, splits, stream);
  if (tile == 1 && out_dtype == 1) return launch<Large, kTrans, bf16>(a, splits, stream);
  return -1;
}

Args make_args(const void* x, const void* q, const float* scale, int per_channel, void* out,
               float* ws, int* counters, int M, int N, int K, int kt_per_split, int x_vec,
               int q_vec) {
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.q = static_cast<const int8_t*>(q);
  a.scale = scale;
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.M = M;
  a.N = N;
  a.K = K;
  a.per_channel = per_channel;
  a.kt_per_split = kt_per_split;
  a.x_vec = x_vec;
  a.q_vec = q_vec;
  return a;
}

}  // namespace

// tile: 0 = 16 x 64 x 128 (decode), 1 = 64 x 128 x 64; splits blocks share each output
// tile's K tiles, kt_per_split apiece (splits > 1 needs ws and counters).
extern "C" int int8_mm_nt(const void* x, const void* q, const float* scale, int per_channel,
                          void* out, int out_dtype, float* ws, int* counters, int M, int N,
                          int K, int tile, int splits, int kt_per_split, int x_vec, int q_vec,
                          void* stream) {
  Args a = make_args(x, q, scale, per_channel, out, ws, counters, M, N, K, kt_per_split, x_vec,
                     q_vec);
  return dispatch<false>(tile, out_dtype, a, splits, static_cast<cudaStream_t>(stream));
}

extern "C" int int8_mm_t(const void* x, const void* q, const float* scale, int per_channel,
                         void* out, int out_dtype, float* ws, int* counters, int M, int N,
                         int K, int tile, int splits, int kt_per_split, int x_vec, int q_vec,
                         void* stream) {
  Args a = make_args(x, q, scale, per_channel, out, ws, counters, M, N, K, kt_per_split, x_vec,
                     q_vec);
  return dispatch<true>(tile, out_dtype, a, splits, static_cast<cudaStream_t>(stream));
}

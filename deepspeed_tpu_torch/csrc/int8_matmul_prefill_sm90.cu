// Weight-int8 matrix products at prefill for Hopper (sm_90a): bf16 activations of more than
// 16 rows times an int8 weight, accumulated in fp32.  Two entries share the helpers below:
// int8_mm_nt_prefill for a (K, N) weight (the block weights) and int8_mm_t_prefill for an
// (N, K) weight (the tied head), described before its kernel ("the (N, K) entry").
//
// Replaces, for M > 16, the Pallas TPU kernel _kernel_nt of
// deepspeed_tpu/ops/transformer/int8_matmul.py (45; pallas_call at 74) and the XLA branch of
// int8_matmul (109-123), which compute out[m, n] = cast(scale * sum_k bf16(x[m, k]) * q[k, n]):
// every product exact, the sums in fp32, the per-tensor scale on the fp32 sum, the cast to
// bf16 or fp32 last.  int8_mm_nt_decode (int8_matmul_decode_sm90.cu) keeps M <= 16, the
// tiled int8_mm_nt (int8_matmul.cu) every case neither takes (N % 16 != 0, a q that is not
// 16-byte aligned); ops/transformer/int8_matmul.py:int8_nt_kernel routes.
//
// What bounds it: a prefill of M tokens does 2 M flops per weight byte.  At GPT-2 1.3B's qkv
// (K = 2048, N = 6144) and M = 512 that is 12.9 GFLOP against 21.0 MB (x, q and the bf16
// out once each): 13.03 us at the H100's 989 bf16 TFLOP/s against 6.26 us at 3.35 TB/s, so
// the operations bound it; at M = 272 (the mean prompt of the serving traffic) 6.92 us of
// operations against 5.09 us of bytes.  The two cross at M = 180-210 at GPT-2 1.3B's four
// block shapes (qkv 183, proj 207, fc and fc_proj 180); below that the bytes bound it.  The tiled
// int8_mm_nt reached 18% of the operation bound: mma.sync on four warps, a round trip of
// the widened tile through shared memory with two block barriers per k step.  This one
// runs on wgmma, the only path to the tensor cores' full rate:
//   * the weight is wgmma's A operand, from registers: out^T (N x M) = q^T (N x K) x^T
//     (K x M); a block's 128 weight columns are the 64-row M sides of two m64n128k16
//     products, one per consumer warpgroup, its 128 tokens their N side;
//   * one producer thread issues TMA loads, per 64-row k box, of the 128 x 64 int8 weight
//     box (8 KB) and of the 128-token x 64-k bf16 x box (16 KB), both 128-byte swizzled,
//     onto one full mbarrier per stage of a kStages ring (96 KB); TMA zero-fills rows past
//     K and M and columns past N and K; the maps are built per call through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda;
//   * no widened tile in shared memory and no block barrier per k step: warp w of either
//     warpgroup reads, per 16-row k step, four 32-bit words of its 32 columns (rows 2t,
//     2t+1, 2t+8, 2t+9 for lane 4g+t, bytes 32w+4g..+3, conflict-free under the swizzle:
//     int8_matmul_decode_sm90.cu's reads); byte b of word j is column 32w + 4g + b at k row
//     r_j, and warpgroup T widens column bytes 2T and 2T+1 (rows g and g+8 of its warp's
//     16-row slice) in registers into its register-A fragment: one byte permute, two
//     logic ops and one bf16x2 subtraction per pair, exact;
//   * x is the shared-memory B operand, K-major as TMA writes it (no transpose), read
//     through the descriptor flash_attention_fwd_sm90.cu uses for K in S = Q K^T;
//   * the fragments of two k steps alternate: a k step's wgmma is one commit group, and
//     after each commit the consumers wait until one group is left in flight; a stage goes
//     back to the producer once the group after its last has been issued.  At two blocks
//     an SM (112 registers a thread) ptxas serializes the wgmmas (C7512, "insufficient
//     register resources"); one block an SM, or a whole box per commit group, frees them
//     but was slower (examples/int8_prefill_check.py's variants);
//   * the accumulator rows come out in the permuted column order (row 16w + g + 8r of
//     warpgroup T's product is weight column 32w + 4g + 2T + r): the epilogue scales,
//     casts and stores two adjacent columns of one token per accumulator pair;
//   * 288 threads (the two consumer warpgroups and a producer warp) and 97 KB of shared
//     memory a block, two blocks an SM (__launch_bounds__(288, 2)): one block's epilogue
//     and ramp overlap the other's main loop;
//   * deterministic split-K where the output tiles are too few for two blocks an SM (proj
//     and fc_proj): each of a tile's splits writes its fp32 partial to a workspace
//     (float4 i of all threads adjacent) and counts itself in on the tile's counter (the
//     int32 counters int8_mm_nt and int8_mm_nt_decode share); the block that counts last
//     adds the partials in split order, scales, casts, stores and resets the counter.  No
//     floating-point atomics: the same inputs give the same bits on every call.
// Where the time goes (examples/int8_prefill_check.py, H100): the consumers' compute path,
// not the loads: with no box loaded the kernel takes as long; the products alone (no words
// read or widened) about two thirds of it, the reads and widening alone about one third,
// and the two add instead of overlapping.  PERF.md holds the figures.
// int8_prefill_plan and int8_prefill_blocks in ops/transformer/int8_matmul.py are this
// schedule in Python; tests/test_torch_int8_prefill.py emulates the kernel lane by lane.
//
// int8_mm_t_prefill replaces, for M > 16, the Pallas TPU kernel _kernel_t of the same file
// (53; pallas_call at 74) and the XLA branch with w_transposed: out[m, n] = cast(s_n * sum_k
// bf16(x[m, k]) * q[n, k]), the scale per tensor or per output channel n, on the fp32 sum.
// At GPT-2 1.3B's head (N = 50257, K = 2048) and M = 512 that is 105.4 GFLOP against 208.2
// MB (the 103 MB weight, the 103 MB fp32 logits, x): 106.57 us of operations against 62.13
// of bytes; at M = 272 56.61 against 47.44 us.  int8_matmul.cu's int8_mm_t (its tiled
// design, which keeps M <= 16 and the rest) read 0.17 of the operation bound.  This entry is
// int8_mm_nt_prefill's design on the (N, K) layout, where a weight row is already a K-major
// A row (no byte transposes), with one block an SM and token tiles of 136 or 256 (two tiles
// cover M = 272 and M = 512); its stores are single elements (N is odd), and with one block
// an SM they do not overlap the products.  tests/test_torch_int8_t_prefill.py emulates it
// lane by lane; examples/int8_prefill_check.py --layout t times it and its variants.
//
// C interface for ctypes (both entries): returns cudaGetLastError() after the launch (0 on
// success), -1 for a shape, alignment, split, tile or output type it was not built for, -2
// when a tensor map cannot be encoded and -3 when the CUDA driver has no
// cuTensorMapEncodeTiled.

#include <cuda.h>  // CUtensorMap and its enums; the CUDA driver function is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBN = 128;                    // weight columns per tile: one 128-byte q row
constexpr int kBM = 128;                    // tokens per tile: wgmma's N side
constexpr int kBK = 64;                     // k rows per box
constexpr int kQBytes = kBK * kBN;          // int8 weight box, 8 KB
constexpr int kXBytes = kBM * kBK * 2;      // bf16 x box, 16 KB
constexpr int kStages = 4;
constexpr int kConsumers = 256;             // two warpgroups: warpgroup T owns product T
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kAcc = 64;                    // fp32 accumulators per consumer thread
constexpr size_t kSmem = 1024 + static_cast<size_t>(kStages) * (kQBytes + kXBytes) + 16 * kStages;
constexpr unsigned long long kHangNs = 2000000000ull;  // an mbarrier wait past this traps

struct Params {
  const float* scale;   // one value (or, int8_mm_t_prefill with per_channel, N)
  int per_channel;
  void* out;            // (M, N)
  float4* ws;           // splits > 1: tiles x splits x kAcc / 4 x kConsumers partials
  int* counters;        // splits > 1: one per tile, zero between launches
  int M, N;
  int mt;               // token tiles
  int KB;               // k boxes
  int splits, per;      // k splits per tile, k boxes per split
};

// ---------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity`; a wait past kHangNs is a fault of the schedule:
// trap, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try(a, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try(a, parity))
    if (globaltimer() - t0 > kHangNs) __trap();
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// named barrier 1: the consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (layout type 1): the start
// address, the leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers a wgmma owns across the
// asynchronous window (between the issue and the wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_frags(uint32_t (&r)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[j])::"memory");
}

#define F8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, fp32) += A (64 x 16, bf16 fragments in registers) B (16 x 128): B in shared
// memory, K-major (no transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 136) += A B (16 x 136), as wgmma_rs_n128
__device__ __forceinline__ void wgmma_rs_n136(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67"
      "}, "
      "{%68, %69, %70, %71}, %72, p, 1, 1, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256) += A B (16 x 256), as wgmma_rs_n128
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef F8

// Byte B of w0 and byte B of w1 (int8) -> one bf16x2, w0's in the low half, exact and with
// no conversion instruction (sel = B | (B + 4) << 8 puts w0.B in byte 0, w1.B in byte 2).
// For a byte v with low bits l = v & 0x7F and sign bit s: bf16 bits 0x4300 | l are 128 + l,
// bf16 bits 0x4300 | (s << 7) are 128 or 256, and their difference is 128 + l - 128 - 128 s
// = v, an integer of magnitude <= 128: exact in bf16.  `magic` holds 0x43004300 in a
// register the compiler cannot see through, so each mask-and-or is one LOP3 (with two
// immediates it takes two).
__device__ __forceinline__ uint32_t widen2(uint32_t w0, uint32_t w1, uint32_t sel,
                                           uint32_t magic) {
  const uint32_t p = __byte_perm(w0, w1, sel);
  const uint32_t hi = (p & 0x007F007Fu) | magic;
  const uint32_t lo = (p & 0x00800080u) | magic;
  uint32_t d;
  // d = lo * -1 + hi, two bf16 lanes
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(lo), "r"(0xBF80BF80u), "r"(hi));
  return d;
}

template <typename T> struct Store2;
template <> struct Store2<float> {
  __device__ static void run(float* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  }
};
template <> struct Store2<bf16> {
  __device__ static void run(bf16* dst, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  }
};

// Add one to a tile's counter and return its old value.  Release: the partial every
// consumer thread stored before the barrier that precedes this call is visible to the block
// that reads the count last; acquire: that block then reads every partial.
__device__ __forceinline__ int count_in(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// A consumer thread's store of its tile's sums.  Accumulator element 4 n + 2 r + e of
// warpgroup T's product is weight column c0 + r (c0 = n0 + 32 w + 4 g + 2 T) and token
// m0 + 8 n + 2 t + e: per (n, e) the thread holds two adjacent columns of one token, scaled,
// cast and stored together.
template <typename OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[kAcc], const Params& p, int m0,
                                           int c0) {
  if (c0 >= p.N) return;
  const int t = threadIdx.x & 3;
  const float sc = p.scale[0];
  OutT* out = static_cast<OutT*>(p.out) + c0;
#pragma unroll
  for (int n = 0; n < kBM / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * n + 2 * t + e;
      if (m < p.M)
        Store2<OutT>::run(out + static_cast<long long>(m) * p.N, acc[4 * n + e] * sc,
                          acc[4 * n + 2 + e] * sc);
    }
}

// ---------------------------------------------------------------- the kernel
// Block b: split b % splits of tile b / splits; tile = column tile * mt + token tile, so
// the token tiles (and the splits) of one weight tile are neighbours in launch order.
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    int8_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tx, Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzled boxes must start on 1024 bytes
  unsigned char* xring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qring = xring + kStages * kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(qring + kStages * kQBytes);
  uint64_t* empty = full + kStages;
  __shared__ int last_flag;

  const int split = blockIdx.x % p.splits, tile = blockIdx.x / p.splits;
  const int m0 = (tile % p.mt) * kBM, n0 = (tile / p.mt) * kBN;
  const int kb0 = split * p.per, kb1 = min(p.KB, kb0 + p.per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      prefetch_map(&tq);
      prefetch_map(&tx);
      int s = 0, ph = 0;
      for (int kb = kb0; kb < kb1; ++kb) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], kQBytes + kXBytes);
        tma_load_2d(qring + s * kQBytes, &tq, &full[s], n0, kb * kBK);
        tma_load_2d(xring + s * kXBytes, &tx, &full[s], kb * kBK, m0);
        if (++s == kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  // warpgroup T, its warp w (32 weight columns, of which it takes bytes 2 T and 2 T + 1)
  const int T = threadIdx.x >> 7, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int ctid = threadIdx.x;
  // Weight word j of k step ks: row r = 16 ks + 2 t + (j & 1) + 8 (j >> 1) of the box, column
  // bytes 32 w + 4 g .. + 3, in 16-byte chunk 2 w + g / 4 before the swizzle, which XORs the
  // chunk with the row's index mod 8 (2 t + (j & 1), whatever ks is): offset woff[j] +
  // 2048 ks.  Both warpgroups read the same words.
  int woff[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 2 * t + (j & 1) + 8 * (j >> 1);
    woff[j] = r * kBN + (((2 * w + (g >> 2)) ^ (r & 7)) << 4) + 4 * (g & 3);
  }
  // A rows g and g + 8 of the warp's slice: column bytes 2 T and 2 T + 1
  const uint32_t sel_lo = (2 * T) | ((2 * T + 4) << 8), sel_hi = sel_lo + 0x101;
  uint32_t magic;
  asm volatile("mov.b32 %0, 0x43004300;\n" : "=r"(magic));
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
  uint32_t frag[2][4];  // [k step parity][register]

  int s = 0, ph = 0;
  for (int kb = kb0; kb < kb1; ++kb) {
    mbar_wait(&full[s], ph);
    const unsigned char* qbox = qring + s * kQBytes;
    const unsigned char* xbox = xring + s * kXBytes;
    uint32_t wd[kBK / 16][4];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wd[ks][j] = *reinterpret_cast<const uint32_t*>(qbox + woff[j] + 16 * ks * kBN);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // the m16n8k16 A layout: rows g (a[0], a[2]) and g + 8 (a[1], a[3]) at k 2 t, 2 t + 1
      // (words 0, 1) and 2 t + 8, 2 t + 9 (words 2, 3)
      uint32_t (&a)[4] = frag[ks & 1];
      const uint32_t* v = wd[ks];
      a[0] = widen2(v[0], v[1], sel_lo, magic);
      a[1] = widen2(v[0], v[1], sel_hi, magic);
      a[2] = widen2(v[2], v[3], sel_lo, magic);
      a[3] = widen2(v[2], v[3], sel_hi, magic);
      // B: the 128 tokens' k 16 ks .. 16 ks + 15, 32 bytes into each swizzled 128-byte row
      const uint64_t db = desc_sw128(xbox + 32 * ks, 16, 1024);
      fence_regs(acc);
      fence_frags(a);
      wgmma_fence();
      wgmma_rs_n128(acc, a, db);
      wgmma_commit();
      // one group left in flight: the last k step's is done, its fragments free, and at
      // ks = 0 the previous box's stage is read to the end
      wgmma_wait<1>();
      fence_regs(acc);
      fence_frags(frag[(ks + 1) & 1]);
      if (ks == 0 && kb != kb0 && lane == 0) mbar_arrive(&empty[s == 0 ? kStages - 1 : s - 1]);
    }
    if (++s == kStages) s = 0, ph ^= 1;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_frags(frag[0]);
  fence_frags(frag[1]);

  const int c0 = n0 + 32 * w + 4 * g + 2 * T;
  if (p.splits == 1) {
    store_tile<OutT>(acc, p, m0, c0);
    return;
  }
  // a split tile: the partial goes to slot tile * splits + split as kAcc / 4 float4 a
  // thread, float4 i of all threads adjacent (coalesced stores and loads)
  float4* mine = p.ws + (static_cast<long long>(tile) * p.splits + split) * (kAcc / 4) * kConsumers +
                 ctid;
#pragma unroll
  for (int i = 0; i < kAcc / 4; ++i)
    mine[i * kConsumers] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  consumers_sync();
  if (ctid == 0) last_flag = count_in(p.counters + tile) == p.splits - 1;
  consumers_sync();
  if (!last_flag) return;
  // counted last: the partials in split order (a fixed order: two calls give the same bits)
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
  const float4* base =
      p.ws + static_cast<long long>(tile) * p.splits * (kAcc / 4) * kConsumers + ctid;
  for (int sp = 0; sp < p.splits; ++sp) {
    const float4* src = base + static_cast<long long>(sp) * (kAcc / 4) * kConsumers;
#pragma unroll
    for (int h = 0; h < kAcc / 4; h += 8) {
      float4 u[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) u[i] = __ldcg(src + (h + i) * kConsumers);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[4 * (h + i)] += u[i].x;
        acc[4 * (h + i) + 1] += u[i].y;
        acc[4 * (h + i) + 2] += u[i].z;
        acc[4 * (h + i) + 3] += u[i].w;
      }
    }
  }
  store_tile<OutT>(acc, p, m0, c0);
  if (ctid == 0) p.counters[tile] = 0;  // ready for the next launch on this stream
}

// ---------------------------------------------------------------- the (N, K) entry
// int8_mm_t_prefill: the weight stored (N, K), K contiguous (the tied head), out = x q^T.  A
// block owns kBN = 128 weight rows n (the 64-row M sides of the two consumer warpgroups'
// products: warpgroup T takes rows 64 T .. 64 T + 63) and kTM tokens (their N side), over
// 64-wide k boxes: a 128 x 64 int8 box of q (64-byte rows, TMA's 64-byte swizzle: 16-byte
// chunk c of row r lands at chunk c ^ ((r >> 1) & 3)) and a kTM x 64 bf16 box of x
// (128-byte swizzle, as above).  A row of the q box is already a K-major A row: lane 4 g + t
// of warp w reads, per 16-k step ks, the byte pairs k 2 t, 2 t + 1 and 2 t + 8, 2 t + 9 of
// rows 16 w + g and 16 w + g + 8 as four 16-bit reads (16 distinct banks a read; on an H100
// 32-bit reads with a byte choice in the permute read 1.08x the time at M = 272) and widens
// each pair into one A register, which then feeds kTM tokens' products.  One
// block an SM (168 registers: kTM / 2 accumulators a thread without serializing the wgmmas;
// at two blocks an SM, 96 registers, ptxas serializes them, and on an H100 128 x 128 tiles
// read 1.17x the time of 128 x 256 at the 1.3B head and M = 512).
template <int kTM>
struct TCfg {
  static constexpr int kAcc = kTM / 2;                  // fp32 accumulators a consumer thread
  static constexpr int kXBytes = kTM * kBK * 2;         // bf16 x box
  // as many stages as 200 KB hold, at most 8
  static constexpr int kStages = (200 * 1024) / (kQBytes + kXBytes) < 8
                                     ? (200 * 1024) / (kQBytes + kXBytes) : 8;
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kStages) * (kQBytes + kXBytes) + 16 * kStages;
};

template <typename T> struct Store1;
template <> struct Store1<float> {
  __device__ static void run(float* dst, float v) { *dst = v; }
};
template <> struct Store1<bf16> {
  __device__ static void run(bf16* dst, float v) { *dst = __float2bfloat16_rn(v); }
};

// k step ks of a warpgroup's product: the 16 x kTM B slice of the x box, one wgmma (on an
// H100, one m64n136 a k step read 146.28 us at the 1.3B head and M = 272 where m64n128 +
// m64n8 on the same fragment read 148.82: examples/int8_prefill_check.py)
template <int kTM>
__device__ __forceinline__ void t_products(float* acc, const uint32_t (&a)[4],
                                           const unsigned char* xbox, int ks) {
  static_assert(kTM == 136 || kTM == 256, "the built token tiles");
  if constexpr (kTM == 136)
    wgmma_rs_n136(acc, a, desc_sw128(xbox + 32 * ks, 16, 1024));
  else
    wgmma_rs_n256(acc, a, desc_sw128(xbox + 32 * ks, 16, 1024));
}

// A consumer thread's store of its tile's sums.  Accumulator element 4 j + 2 r + e of warp w
// of warpgroup T, lane 4 g + t, is weight row c + 8 r (c = n0 + 64 T + 16 w + g) and token
// m0 + 8 j + 2 t + e: per (j, e, r) the warp stores 8 adjacent columns of 4 tokens, one
// element a lane (N is odd at the head: no wider store is aligned on every row).
template <typename OutT, int kTM>
__device__ __forceinline__ void store_t_tile(const float (&acc)[kTM / 2], const Params& p,
                                             int m0, int c) {
  const int t = threadIdx.x & 3;
  float sc[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    live[r] = c + 8 * r < p.N;
    sc[r] = p.per_channel ? (live[r] ? p.scale[c + 8 * r] : 0.f) : p.scale[0];
  }
  OutT* out = static_cast<OutT*>(p.out) + c;
#pragma unroll
  for (int j = 0; j < kTM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m >= p.M) continue;
      OutT* row = out + static_cast<long long>(m) * p.N;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (live[r]) Store1<OutT>::run(row + 8 * r, acc[4 * j + 2 * r + e] * sc[r]);
    }
}

// Block b: split b % splits of tile b / splits; tile = weight-row tile * mt + token tile, so
// the token tiles (and the splits) of one weight tile are neighbours in launch order.
template <typename OutT, int kTM>
__global__ void __launch_bounds__(kThreads, 1)
    int8_t_prefill_kernel(const __grid_constant__ CUtensorMap tmq,
                          const __grid_constant__ CUtensorMap tmx, Params tp) {
  using C = TCfg<kTM>;
  extern __shared__ __align__(1024) unsigned char smem_t[];
  // swizzled boxes must start on 1024 bytes (the x boxes' pattern repeats every 1024)
  unsigned char* xboxes = smem_t + ((1024 - (smem_addr(smem_t) & 1023)) & 1023);
  unsigned char* qboxes = xboxes + C::kStages * C::kXBytes;
  uint64_t* filled = reinterpret_cast<uint64_t*>(qboxes + C::kStages * kQBytes);
  uint64_t* freed = filled + C::kStages;
  __shared__ int counted_last;

  const int split = blockIdx.x % tp.splits, tile = blockIdx.x / tp.splits;
  const int m0 = (tile % tp.mt) * kTM, n0 = (tile / tp.mt) * kBN;
  const int kb0 = split * tp.per, kb1 = min(tp.KB, kb0 + tp.per);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&filled[s], 1);
      mbar_init(&freed[s], kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      prefetch_map(&tmq);
      prefetch_map(&tmx);
      int s = 0, ph = 0;
      for (int kb = kb0; kb < kb1; ++kb) {
        mbar_wait(&freed[s], ph ^ 1);
        mbar_expect_tx(&filled[s], kQBytes + C::kXBytes);
        tma_load_2d(qboxes + s * kQBytes, &tmq, &filled[s], kb * kBK, n0);
        tma_load_2d(xboxes + s * C::kXBytes, &tmx, &filled[s], kb * kBK, m0);
        if (++s == C::kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  const int T = threadIdx.x >> 7, w = warp & 3, g = lane >> 2, t = lane & 3;
  // pair h of k step ks: row 64 T + 16 w + g (+ 8 for h & 1), k byte 2 t (+ 8 for h >> 1)
  // of chunk ks, which the swizzle XORs with (g >> 1) (rows g and g + 8 alike)
  const int wbase = (64 * T + 16 * w + g) * kBK + 2 * t;
  const int wswz = (g >> 1) << 4;
  uint32_t magic;
  asm volatile("mov.b32 %0, 0x43004300;\n" : "=r"(magic));
  float acc[C::kAcc];
#pragma unroll
  for (int e = 0; e < C::kAcc; ++e) acc[e] = 0.f;
  uint32_t afrag[2][4];  // [k step parity][A register]

  int s = 0, ph = 0;
  for (int kb = kb0; kb < kb1; ++kb) {
    mbar_wait(&filled[s], ph);
    const unsigned char* qb = qboxes + s * kQBytes;
    const unsigned char* xb = xboxes + s * C::kXBytes;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // a[0]: row g at k 2 t; a[1]: row g + 8; a[2]: row g at k 2 t + 8; a[3]: row g + 8
      // there (the pairs of one k step at a time), bytes 0 and 1 into the bf16 lanes
      const unsigned char* chunk = qb + wbase + ((ks << 4) ^ wswz);
      uint32_t qw[4];
      qw[0] = *reinterpret_cast<const uint16_t*>(chunk);
      qw[1] = *reinterpret_cast<const uint16_t*>(chunk + 8 * kBK);
      qw[2] = *reinterpret_cast<const uint16_t*>(chunk + 8);
      qw[3] = *reinterpret_cast<const uint16_t*>(chunk + 8 * kBK + 8);
      uint32_t (&a)[4] = afrag[ks & 1];
#pragma unroll
      for (int h = 0; h < 4; ++h) a[h] = widen2(qw[h], qw[h], 0x0100u, magic);
      fence_regs(acc);
      fence_frags(a);
      wgmma_fence();
      t_products<kTM>(acc, a, xb, ks);
      wgmma_commit();
      // one group left in flight: the last k step's is done, its fragments free, and at
      // ks = 0 the previous box's stage is read to the end
      wgmma_wait<1>();
      fence_regs(acc);
      fence_frags(afrag[(ks + 1) & 1]);
      if (ks == 0 && kb != kb0 && lane == 0)
        mbar_arrive(&freed[s == 0 ? C::kStages - 1 : s - 1]);
    }
    if (++s == C::kStages) s = 0, ph ^= 1;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_frags(afrag[0]);
  fence_frags(afrag[1]);

  const int c = n0 + 64 * T + 16 * w + g;
  if (tp.splits > 1) {
    // a split tile: the partial goes to slot tile * splits + split as kAcc / 4 float4 a
    // thread, float4 i of all threads adjacent (coalesced stores and loads)
    const int ctid = threadIdx.x;
    float4* base =
        tp.ws + static_cast<long long>(tile) * tp.splits * (C::kAcc / 4) * kConsumers + ctid;
    float4* mine = base + static_cast<long long>(split) * (C::kAcc / 4) * kConsumers;
#pragma unroll
    for (int i = 0; i < C::kAcc / 4; ++i)
      mine[i * kConsumers] =
          make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    consumers_sync();
    if (ctid == 0) counted_last = count_in(tp.counters + tile) == tp.splits - 1;
    consumers_sync();
    if (!counted_last) return;
    // counted last: the partials in split order (a fixed order: two calls give the same bits)
#pragma unroll
    for (int e = 0; e < C::kAcc; ++e) acc[e] = 0.f;
    for (int sp = 0; sp < tp.splits; ++sp) {
      const float4* src = base + static_cast<long long>(sp) * (C::kAcc / 4) * kConsumers;
#pragma unroll
      for (int i = 0; i < C::kAcc / 4; ++i) {
        const float4 u = __ldcg(src + i * kConsumers);
        acc[4 * i] += u.x;
        acc[4 * i + 1] += u.y;
        acc[4 * i + 2] += u.z;
        acc[4 * i + 3] += u.w;
      }
    }
    if (ctid == 0) tp.counters[tile] = 0;  // ready for the next launch on this stream
  }
  store_t_tile<OutT, kTM>(acc, tp, m0, c);
}

// ---------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, so the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

template <typename OutT>
int launch(const CUtensorMap& mq, const CUtensorMap& mx, const Params& p, int blocks,
           cudaStream_t stream) {
  auto kernel = int8_prefill_kernel<OutT>;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs opting in
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
    // two blocks an SM need the largest shared-memory carveout
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kernel<<<blocks, kThreads, kSmem, stream>>>(mq, mx, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT, int kTM>
int launch_t(const CUtensorMap& mq, const CUtensorMap& mx, const Params& p, int blocks,
             cudaStream_t stream) {
  using C = TCfg<kTM>;
  auto kernel = int8_t_prefill_kernel<OutT, kTM>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kernel<<<blocks, kThreads, C::kSmem, stream>>>(mq, mx, p);
  return static_cast<int>(cudaGetLastError());
}

// the token tiles built: 136 (two tiles at M = 272) and 256
template <typename OutT>
int launch_t_tile(int tm, const CUtensorMap& mq, const CUtensorMap& mx, const Params& p,
                  int blocks, cudaStream_t stream) {
  return tm == 136 ? launch_t<OutT, 136>(mq, mx, p, blocks, stream)
                   : launch_t<OutT, 256>(mq, mx, p, blocks, stream);
}

}  // namespace

// x (M, K) bf16 in rows of ldx elements (16-byte aligned, ldx % 8 == 0, ldx >= K), q (K, N)
// int8 (16-byte aligned, N % 16 == 0), scale one fp32, out (M, N) bf16 (out_dtype 1) or
// fp32 (0), 16-byte aligned; splits, per: each 128 x 128 output tile's k boxes (64 rows)
// cut into `splits` ranges of `per` (the last may be shorter, none empty); with splits > 1,
// ws holds tiles x splits x 128 x 128 fp32 and counters one zeroed int per tile.
extern "C" int int8_mm_nt_prefill(const void* x, const void* q, const float* scale, void* out,
                                  int out_dtype, float4* ws, int* counters, int M, int N, int K,
                                  int ldx, int splits, int per, void* stream) {
  const auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16; };
  if (M < 1 || N < 16 || N % 16 != 0 || K < 1 || ldx < K || ldx % 8 != 0 || misaligned(x) ||
      misaligned(q) || misaligned(out) || (out_dtype != 0 && out_dtype != 1))
    return -1;
  Params p;
  p.scale = scale;
  p.per_channel = 0;
  p.out = out;
  p.ws = ws;
  p.counters = counters;
  p.M = M;
  p.N = N;
  p.mt = (M + kBM - 1) / kBM;
  p.KB = (K + kBK - 1) / kBK;
  p.splits = splits;
  p.per = per;
  const long long tiles = static_cast<long long>(p.mt) * ((N + kBN - 1) / kBN);
  if (splits < 1 || per < 1 || static_cast<long long>(splits - 1) * per >= p.KB ||
      static_cast<long long>(splits) * per < p.KB || tiles * splits >= 0x7fffffffLL ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return -1;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -3;
  // q: (K, N) bytes in 128 x 64 boxes; x: (M, K) bf16 in 64 x 128 boxes; both 128-byte
  // swizzled, zero past the ends
  CUtensorMap mq, mx;
  const cuuint64_t qdims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t qstrides[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t qbox[2] = {kBN, kBK};
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(ldx) * 2};
  const cuuint32_t xbox[2] = {kBK, kBM};
  const cuuint32_t estr[2] = {1, 1};
  if (enc(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q), qdims, qstrides, qbox,
          estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      enc(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), xdims, xstrides, xbox,
          estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>(tiles * splits);
  return out_dtype == 1 ? launch<bf16>(mq, mx, p, blocks, st) : launch<float>(mq, mx, p, blocks, st);
}

// x (M, K) bf16 in rows of ldx elements (16-byte aligned, ldx % 8 == 0, ldx >= K), q (N, K)
// int8 (16-byte aligned, K % 16 == 0), scale one fp32 or (per_channel) N, out (M, N) bf16
// (out_dtype 1) or fp32 (0); tm: the token tile, 136 or 256; splits, per: each 128 x tm
// output tile's k boxes (64 wide) cut into `splits` ranges of `per` (the last may be
// shorter, none empty); with splits > 1, ws holds tiles x splits x 128 x tm fp32 and counters
// one zeroed int per tile.
extern "C" int int8_mm_t_prefill(const void* x, const void* q, const float* scale,
                                 int per_channel, void* out, int out_dtype, float4* ws,
                                 int* counters, int M, int N, int K, int ldx, int tm, int splits,
                                 int per, void* stream) {
  const auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16; };
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 || ldx < K || ldx % 8 != 0 || misaligned(x) ||
      misaligned(q) || misaligned(out) || (out_dtype != 0 && out_dtype != 1) ||
      (tm != 136 && tm != 256))
    return -1;
  Params p;
  p.scale = scale;
  p.per_channel = per_channel != 0;
  p.out = out;
  p.ws = ws;
  p.counters = counters;
  p.M = M;
  p.N = N;
  p.mt = (M + tm - 1) / tm;
  p.KB = (K + kBK - 1) / kBK;
  p.splits = splits;
  p.per = per;
  const long long tiles = static_cast<long long>(p.mt) * ((N + kBN - 1) / kBN);
  if (splits < 1 || per < 1 || static_cast<long long>(splits - 1) * per >= p.KB ||
      static_cast<long long>(splits) * per < p.KB || tiles * splits >= 0x7fffffffLL ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return -1;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -3;
  // q: (N, K) bytes in 128-row x 64-byte boxes, 64-byte swizzled; x: (M, K) bf16 in tm x 64
  // boxes, 128-byte swizzled; zero past the ends
  CUtensorMap mq, mx;
  const cuuint64_t qdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t qstrides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t qbox[2] = {kBK, kBN};
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(ldx) * 2};
  const cuuint32_t xbox[2] = {kBK, static_cast<cuuint32_t>(tm)};
  const cuuint32_t estr[2] = {1, 1};
  if (enc(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q), qdims, qstrides, qbox,
          estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      enc(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), xdims, xstrides, xbox,
          estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>(tiles * splits);
  return out_dtype == 1 ? launch_t_tile<bf16>(tm, mq, mx, p, blocks, st)
                        : launch_t_tile<float>(tm, mq, mx, p, blocks, st);
}

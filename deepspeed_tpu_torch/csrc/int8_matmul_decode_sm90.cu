// Weight-int8 matrix product at decode for Hopper (sm_90a): the entry int8_mm_nt_decode,
// bf16 activations of at most 16 rows times an int8 (K, N) weight, accumulated in fp32.
//
// Replaces, for M <= 16, the Pallas TPU kernel _kernel_nt of
// deepspeed_tpu/ops/transformer/int8_matmul.py (45; pallas_call at 74) and the XLA branch of
// int8_matmul (109-123), which compute out[m, n] = cast(scale * sum_k bf16(x[m, k]) * q[k, n]):
// every product exact, the sums in fp32, the per-tensor scale on the fp32 sum, the cast to
// bf16 or fp32 last.  The tiled kernel int8_mm_nt (int8_matmul.cu) keeps M > 16 and every
// case this entry does not take; ops/transformer/int8_matmul.py:int8_nt_kernel routes.
//
// What bounds it: at decode every weight byte is read once for 2·M flops (16 at M = 8), far
// below the ~295 flops per byte at which the H100's tensor cores become the limit.  The
// bytes bound it: 12.6 MB at GPT-2 1.3B's qkv (K = 2048, N = 6144) take 3.80 us at
// 3.35 TB/s.  The tiled int8_mm_nt reached 0.72 TB/s there: 8 KB per cp.async stage, three
// stages, a round trip of the widened tile through shared memory with two block barriers
// per k step, half of every m16n8k16 product empty, short-lived split-K blocks.  This one:
//   * weight streaming: one producer thread issues TMA loads of 128-column x 64-row int8
//     boxes (8 KB, 128-byte swizzle) over a 2-D tensor map of q into a ring of kStages
//     boxes (64 KB in flight per SM), each with a full mbarrier (the box's bytes) and an
//     empty one (one arrival per consumer warp); the map is built per call through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda; TMA zero-fills the rows
//     past K and the columns past N;
//   * the activation rides in the same ring: with each weight box the producer loads x's
//     64 matching columns for 8 or 16 rows (1 or 2 KB, 128-byte swizzle; TMA zero-fills
//     rows past M and columns past K) onto the same full barrier, so a consumer never
//     waits on a global load of x behind the weight stream;
//   * the weight is the M-side operand of the product: out^T (N x M) = q^T (N x K) x^T
//     (K x M), so 32 weight columns fill the 16 rows of two mma.sync m16n8k16 products and
//     the M <= 8 (or 16) activation rows their n = 8 side (one or two products per column
//     pair);
//   * no widened tile: consumer warp w reads, per 16-row k step, four 32-bit words of its
//     32 columns (rows 2t, 2t+1, 2t+8, 2t+9 of the step for lane 4g+t, bytes 32w+4g..+3,
//     conflict-free under the swizzle) and two of x, hands the box back and tests
//     (without waiting) whether the next one has landed, then turns the words into the A
//     fragments of both products in registers: byte b of word j is weight column 32w + 4g
//     + b at k row r_j; column bytes 0/1 are rows g/g+8 of product 0, bytes 2/3 those of
//     product 1; each bf16 pair is one byte permute, two logic ops and one bf16x2
//     subtraction (exact); the lane's shared-memory offsets are computed once, and the
//     tile, k box and ring stage are counted, not divided out, per box;
//   * a persistent grid: the N/128 x K/64 boxes, ordered by (column tile, k box), are cut
//     into one contiguous range per block (the ranges differ by at most one box); a block
//     sums each column tile's boxes in its range and stores a tile it holds whole; where a
//     tile spans blocks, each writes its fp32 partial to a workspace slot and counts
//     itself in the tile's counter, and the block that counts last adds the partials in
//     block order, scales, casts, stores and resets the counter.  A block's first tile is
//     counted in by a helper warp while the consumers go on.  One launch, no
//     floating-point atomics: the same inputs give the same bits on every call;
//   * the stores are four adjacent columns of one row per lane (16 or 8 bytes).
// int8_decode_plan and int8_decode_blocks in ops/transformer/int8_matmul.py are this
// schedule in Python; examples/int8_decode_check.py times the kernel with parts taken out.
//
// C interface for ctypes: returns cudaGetLastError() after the launch (0 on success), -1 for
// a shape, alignment or output type it was not built for, -2 when a tensor map cannot be
// encoded and -3 when the CUDA driver has no cuTensorMapEncodeTiled.

#include <cuda.h>  // CUtensorMap and its enums; the CUDA driver function is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBN = 128;                      // weight columns per box: one 128-byte row
constexpr int kBK = 64;                       // weight rows (k) per box
constexpr int kBoxBytes = kBN * kBK;          // 8 KB
constexpr int kStages = 8;                    // boxes in the ring
constexpr int kXBoxBytes = 16 * 128;          // x box slot: up to 16 rows of 64 bf16
constexpr int kConsumerWarps = kBN / 32;      // one warp per 32 columns
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kProducerWarp = kConsumerWarps, kHelperWarp = kConsumerWarps + 1;
constexpr int kThreads = kConsumers + 64;     // and the producer and helper warps
constexpr size_t kSmem =
    1024 + static_cast<size_t>(kStages) * (kBoxBytes + kXBoxBytes) + 16 * kStages + 16;
constexpr unsigned long long kHangNs = 2000000000ull;  // an mbarrier wait past this traps

struct Params {
  const float* scale;   // one value
  void* out;            // (M, N)
  float* ws;            // 2 slots per block of kConsumers x 8 NF fp32 partials
  int* counters;        // one per column tile, zero between launches
  int M, N;
  int KB;               // k boxes per column tile
  int W;                // boxes: column tiles x KB (the host keeps W * G < 2^31)
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

// whether the phase of parity `parity` has completed, without suspending the thread
__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
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

// named barrier 1: the consumer threads
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// c (16x8) += a (16x16) * b (16x8), bf16 in, fp32 accumulate.  a: rows g (a[0], a[2]) and
// g + 8 (a[1], a[3]) at k 2t, 2t+1 (a[0], a[1]) and 2t+8, 2t+9 (a[2], a[3]); b: k 2t, 2t+1
// (b0) and 2t+8, 2t+9 (b1) of column g; c: rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at
// columns 2t, 2t+1 (lane = 4 g + t).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte B of w0 and byte B of w1 (int8) -> one bf16x2, w0's in the low half, exact and with
// no conversion instruction.  For a byte v with low bits l = v & 0x7F and sign bit s:
// bf16 bits 0x4300 | l are 128 + l, bf16 bits 0x4300 | (s << 7) are 128 or 256, and their
// difference is 128 + l - 128 - 128 s = v, an integer of magnitude <= 128: exact in bf16.
template <int B>
__device__ __forceinline__ uint32_t widen2(uint32_t w0, uint32_t w1) {
  const uint32_t p = __byte_perm(w0, w1, B | ((B + 4) << 8));  // w0.B in byte 0, w1.B in 2
  const uint32_t hi = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t lo = (p & 0x00800080u) | 0x43004300u;
  uint32_t d;
  // d = lo * -1 + hi, two bf16 lanes
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(lo), "r"(0xBF80BF80u), "r"(hi));
  return d;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> struct Store4;
template <> struct Store4<float> {
  __device__ static void run(float* dst, const float (&v)[4]) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Store4<bf16> {
  __device__ static void run(bf16* dst, const float (&v)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(dst) = u;
  }
};

// Add one to a tile's counter and return its old value.  Release: the partial every
// consumer thread stored before the barrier that precedes this call is visible to the block that
// reads the count last; acquire: that block then reads every partial.
__device__ __forceinline__ int count_in(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// block whose range holds box i: the largest b with floor(b W / G) <= i
__device__ __forceinline__ int block_of(int i, int W, int G) {
  return ((i + 1) * G + W - 1) / W - 1;
}

// ---------------------------------------------------------------- the kernel
// The sums of one split tile over every block that shares it (bf..bl), in block order (a
// fixed order: two calls give the same bits), read by the consumer threads from the
// workspace slots, 8 / NF slots in flight at a time.
template <int NF>
__device__ __forceinline__ void sum_partials(float (&acc)[2][NF][4], const Params& p, int nt,
                                             int bf, int bl, int ctid) {
  constexpr int kAcc = 2 * NF * 4, kBatch = 8 / NF;
  const int G = gridDim.x;
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[T][f][e] = 0.f;
  for (int b0 = bf; b0 <= bl; b0 += kBatch) {
    float part[kBatch][kAcc];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int bb = b0 + u;
      if (bb > bl) break;
      const int slot = 2 * bb + (nt != bb * p.W / G / p.KB);
      const float* src = p.ws + static_cast<long long>(slot) * kAcc * kConsumers + ctid;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) part[u][j] = __ldcg(src + j * kConsumers);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (b0 + u > bl) break;
#pragma unroll
      for (int T = 0; T < 2; ++T)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[T][f][e] += part[u][(T * NF + f) * 4 + e];
    }
  }
}

// A consumer thread's store of a tile's sums: rows 8 f + 2 t + h, columns n0 .. n0 + 3
// (product T, row half r -> column n0 + 2 T + r), scaled and cast.
template <int NF, typename OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[2][NF][4], const Params& p, int nt,
                                           int cg, int g, int t) {
  const int n0 = nt * kBN + 32 * cg + 4 * g;
  const float sc = p.scale[0];
  if (n0 >= p.N) return;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * f + 2 * t + h;
      if (m < p.M) {
        const float v[4] = {acc[0][f][h] * sc, acc[0][f][2 + h] * sc, acc[1][f][h] * sc,
                            acc[1][f][2 + h] * sc};
        Store4<OutT>::run(static_cast<OutT*>(p.out) + static_cast<long long>(m) * p.N + n0, v);
      }
    }
}

// NF: activation row groups of 8 (1 for M <= 8, 2 for M <= 16).
template <int NF, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    int8_decode_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tx, Params p) {
  constexpr int kAcc = 2 * NF * 4;       // accumulators per consumer thread
  constexpr int kXBytes = NF * 8 * 128;  // one x box: 8 NF rows of 64 bf16
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzled boxes must start on 1024 bytes
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* xring = ring + kStages * kBoxBytes;  // x boxes, 1024-byte aligned slots
  uint64_t* full = reinterpret_cast<uint64_t*>(xring + kStages * kXBoxBytes);
  uint64_t* empty = full + kStages;
  uint64_t* part = empty + kStages;  // the first split tile's partial is in the workspace
  uint64_t* decided = part + 1;      // and the helper warp has counted it
  __shared__ int last_flag, first_last;

  const int G = gridDim.x, b = blockIdx.x;
  const int lo = b * p.W / G, hi = (b + 1) * p.W / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KB = p.KB, first = lo / KB;
  const auto split = [&](int nt) {
    return block_of(nt * KB, p.W, G) != block_of(nt * KB + KB - 1, p.W, G);
  };
  // the block's first tile is split and more of its range follows: that tile's partial is
  // counted in by the helper warp while the consumers go on
  const bool publish_first = first != (hi - 1) / KB && split(first);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(part, kConsumerWarps);
    mbar_init(decided, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      prefetch_map(&tq);
      prefetch_map(&tx);
      int nt = first, kb = lo % KB, s = 0, ph = 0;
      for (int i = lo; i < hi; ++i) {
        mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], kBoxBytes + kXBytes);
        tma_load_2d(ring + s * kBoxBytes, &tq, &full[s], nt * kBN, kb * kBK);
        tma_load_2d(xring + s * kXBoxBytes, &tx, &full[s], kb * kBK, 0);
        if (++kb == KB) kb = 0, ++nt;
        if (++s == kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }
  if (warp == kHelperWarp) {
    // ------------------------------------------------------------ helper
    // counts the block's first split tile in (release / acquire: see count_in) and tells
    // the consumers whether they must sum it; they do not wait for the count
    if (lane == 0 && publish_first) {
      mbar_wait(part, 0);
      first_last = count_in(p.counters + first) ==
                   block_of(first * KB + KB - 1, p.W, G) - block_of(first * KB, p.W, G);
      mbar_arrive(decided);
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  // warp = 32 columns; ctid = threadIdx.x
  const int g = lane >> 2, t = lane & 3, ctid = threadIdx.x;
  // This lane's shared-memory offsets, fixed for the kernel.  Weight word j of k step ks
  // is row r = 16 ks + 2 t + (j & 1) + 8 (j >> 1) of the box, column bytes 32 warp + 4 g ..
  // + 3, in 16-byte chunk 2 warp + g / 4 before the swizzle, which XORs the chunk with the
  // row's index mod 8 (2 t + (j & 1), whatever ks is): offset woff[j] + 2048 ks.  The x
  // pair h of row group f at k step ks: row g + 8 f, chunk 2 ks + h XORed with g, 4 t
  // bytes in.
  int woff[4], xoff[kBK / 16][NF][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 2 * t + (j & 1) + 8 * (j >> 1);
    woff[j] = r * kBN + (((2 * warp + (g >> 2)) ^ (r & 7)) << 4) + 4 * (g & 3);
  }
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xoff[ks][f][h] = (g + 8 * f) * 128 + (((2 * ks + h) ^ g) << 4) + 4 * t;
  float acc[2][NF][4];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[T][f][e] = 0.f;

  int nt = first, kb = lo % KB, s = 0, ph = 0;
  bool ready = false;  // the box of stage s has landed (tested while the last one ran)
  for (int i = lo; i < hi; ++i) {
    if (!ready) mbar_wait(&full[s], ph);
    const unsigned char* box = ring + s * kBoxBytes;
    const unsigned char* xbox = xring + s * kXBoxBytes;
    uint32_t w[kBK / 16][4], xb[kBK / 16][NF][2];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[ks][j] = *reinterpret_cast<const uint32_t*>(box + woff[j] + 16 * ks * kBN);
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          xb[ks][f][h] = *reinterpret_cast<const uint32_t*>(xbox + xoff[ks][f][h]);
    }
    // the box's words are in registers: hand the stage back, and ask (without waiting)
    // whether the next box has landed, while this one is widened and multiplied
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == kStages) s = 0, ph ^= 1;
    ready = mbar_test(&full[s], ph);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // product 0 takes column bytes 0 (row g) and 1 (row g + 8), product 1 bytes 2 and 3
      const uint32_t* v = w[ks];
      const uint32_t a0[4] = {widen2<0>(v[0], v[1]), widen2<1>(v[0], v[1]),
                              widen2<0>(v[2], v[3]), widen2<1>(v[2], v[3])};
      const uint32_t a1[4] = {widen2<2>(v[0], v[1]), widen2<3>(v[0], v[1]),
                              widen2<2>(v[2], v[3]), widen2<3>(v[2], v[3])};
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        mma16816(acc[0][f], a0, xb[ks][f][0], xb[ks][f][1]);
        mma16816(acc[1][f], a1, xb[ks][f][0], xb[ks][f][1]);
      }
    }
    if (++kb != KB && i + 1 != hi) continue;
    // ------------------------------------------ the end of this block's part of tile nt
    if (!split(nt)) {
      store_tile<NF, OutT>(acc, p, nt, warp, g, t);
    } else {
      // a split tile: the partial goes to slot 2 b (+ 1 past the block's first tile)
      float* mine = p.ws + static_cast<long long>(2 * b + (nt != first)) * kAcc * kConsumers + ctid;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) mine[j * kConsumers] = acc[j / (NF * 4)][j / 4 % NF][j % 4];
      if (i + 1 != hi) {  // the first tile, more of the range to go: the helper counts it
        __syncwarp();
        if (lane == 0) mbar_arrive(part);
      } else {  // the range's last tile: count it in; the last block sums the tile
        const int bf = block_of(nt * KB, p.W, G), bl = block_of(nt * KB + KB - 1, p.W, G);
        consumers_sync();
        if (ctid == 0) last_flag = count_in(p.counters + nt) == bl - bf;
        consumers_sync();
        if (last_flag) {
          sum_partials<NF>(acc, p, nt, bf, bl, ctid);
          store_tile<NF, OutT>(acc, p, nt, warp, g, t);
          if (ctid == 0) p.counters[nt] = 0;  // ready for the next launch on this stream
        }
      }
    }
    kb = 0;  // the next box, if any, starts tile nt + 1
    ++nt;
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[T][f][e] = 0.f;
  }
  // the first split tile, if the helper found this block counted last
  if (publish_first) {
    mbar_wait(decided, 0);
    if (first_last) {
      sum_partials<NF>(acc, p, first, block_of(first * KB, p.W, G),
                       block_of(first * KB + KB - 1, p.W, G), ctid);
      store_tile<NF, OutT>(acc, p, first, warp, g, t);
      if (ctid == 0) p.counters[first] = 0;
    }
  }
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

template <int NF, typename OutT>
int launch(const CUtensorMap& mq, const CUtensorMap& mx, const Params& p, int blocks,
           cudaStream_t stream) {
  auto kernel = int8_decode_kernel<NF, OutT>;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs opting in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kernel<<<blocks, kThreads, kSmem, stream>>>(mq, mx, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) bf16 in rows of ldx elements (16-byte aligned, ldx % 8 == 0, ldx >= K), q
// (K, N) int8 (16-byte aligned, N % 16 == 0), scale one fp32, out (M, N) bf16 (out_dtype
// 1) or fp32 (0), 16-byte aligned; blocks: the persistent grid (at most the boxes); ws: 2 x
// blocks x 128 x 8 NF fp32 (NF = 1 for M <= 8, else 2); counters: one zeroed int per
// 128-column tile.
extern "C" int int8_mm_nt_decode(const void* x, const void* q, const float* scale, void* out,
                                 int out_dtype, float* ws, int* counters, int M, int N, int K,
                                 int ldx, int blocks, void* stream) {
  const auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16; };
  if (M < 1 || M > 16 || N < 16 || N % 16 != 0 || K < 1 || ldx < K || ldx % 8 != 0 ||
      misaligned(x) ||
      misaligned(q) || misaligned(out) || (out_dtype != 0 && out_dtype != 1))
    return -1;
  const int NF = M <= 8 ? 1 : 2;
  Params p;
  p.scale = scale;
  p.out = out;
  p.ws = ws;
  p.counters = counters;
  p.M = M;
  p.N = N;
  p.KB = (K + kBK - 1) / kBK;
  const long long W = static_cast<long long>((N + kBN - 1) / kBN) * p.KB;
  if (blocks < 1 || blocks > W || W * (blocks + 1) >= 0x7fffffffLL) return -1;
  p.W = static_cast<int>(W);
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -3;
  // q: (K, N) bytes in 128 x 64 boxes; x: (M, K) bf16 in 64 x 8 NF boxes (the kernel's
  // kXBytes); both 128-byte swizzled, zero past the ends
  CUtensorMap mq, mx;
  const cuuint64_t qdims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t qstrides[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t qbox[2] = {kBN, kBK};
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(ldx) * 2};
  const cuuint32_t xbox[2] = {64, static_cast<cuuint32_t>(8 * NF)};
  const cuuint32_t estr[2] = {1, 1};
  if (enc(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q), qdims, qstrides, qbox,
          estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      enc(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), xdims, xstrides, xbox,
          estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (NF == 1)
    return out_dtype == 1 ? launch<1, bf16>(mq, mx, p, blocks, st)
                          : launch<1, float>(mq, mx, p, blocks, st);
  return out_dtype == 1 ? launch<2, bf16>(mq, mx, p, blocks, st)
                        : launch<2, float>(mq, mx, p, blocks, st);
}

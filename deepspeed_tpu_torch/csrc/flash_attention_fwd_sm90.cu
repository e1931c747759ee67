// Flash-attention forward for Hopper (sm_90a) built the way the card is meant to be used:
// the entry flash_fwd_sm90, bf16, head dims 64 and 128, causal or not.
//
// Replaces the Pallas TPU kernel _fwd_kernel of deepspeed_tpu/ops/transformer/flash_attention.py
// (144-283, built by _fwd 441-613) on its dense path, no biases and no LUT.  The template
// fwd_kernel of flash_attention.cuh (4 warps, 64-row q tiles, mma.sync, a cp.async double
// buffer) keeps fp32 and head dim 96; ops/transformer/flash_attention.py routes bf16 at head
// dims 64 and 128 here.  It computes what fwd_kernel computes on its dense path:
//   S = Q K^T * scale, masked with NEG_INF = -1e30 where k_pos >= T or, when causal,
//   q_pos < k_pos; an online softmax over the visited k tiles with fp32 m, l and O; P
//   rounded to bf16 before P V; O = acc / l written bf16, contiguous (B, T, H, D); lse =
//   m + log l, fp32 (B, H, T), natural log; a row with no live key writes O = 0 and lse =
//   NEG_INF (row_live, 278-283).  The backward kernels read this lse.
//
// What bounds it: at GPT-2's shape (B=8, T=1024, H=16, D=64, causal) the call does 4·D
// flops per live (q, k) pair, 17.2 GFLOP, against 8.4 MB of inputs and outputs: 17.4 us of
// bf16 tensor-core time against 2.5 us of memory time at the H100's 989 TFLOP/s and
// 3.35 TB/s.  So it is bound by operations, and the design keeps the tensor cores fed:
//   * a block of three warpgroups owns a 128-row q tile: one producer warp issues every
//     copy with the Tensor Memory Accelerator, and two consumer warpgroups own 64 q rows
//     each; setmaxnreg gives the producer's registers to the consumers (24 / 240);
//   * TMA copies Q once and then streams K and V tiles of kBN keys into a ring of kStages
//     stages; each stage of K and of V has a full mbarrier (the producer's expected bytes,
//     completed by the copy) and an empty one (one arrival per consumer warp), so the next
//     tiles are in flight while the consumers compute on this one; the tensor maps are 4-D
//     (D, H, T, B) over the tensors' own strides, so q/k/v may be views of the fused qkv
//     matmul output, and TMA zero-fills the rows past T;
//   * every tile is stored with the 128-byte swizzle (one 64-column box per 128-byte row;
//     head dim 128 is two boxes), which wgmma reads through shared-memory descriptors
//     without bank conflicts;
//   * S = Q K^T is wgmma m64nNk16 with both operands in shared memory (K-major, as TMA
//     writes them): each warpgroup reads a K tile once, where mma.sync made every warp
//     re-read it;
//   * the softmax runs on the S accumulators in registers, in log2 units (one FMA and one
//     exp2 per element); only tiles that cross the diagonal or the ragged end take the
//     per-element mask and the NEG_INF select; causal tiles wholly above the diagonal are
//     never loaded; the row sums are reduced across the quad once, at the end;
//   * O += P V is wgmma with A from registers: P goes from the fp32 S accumulators to bf16 A
//     fragments in place (the accumulator layout of a 16-column slice is the A-fragment
//     layout), and V is read from its row-major tile with the transpose bit, so no
//     transposed copy is made;
//   * the grid is persistent, one block per SM: the work items (a q tile of one (b, h)),
//     ordered longest causal q tiles first, are dealt to the blocks in rounds that
//     alternate direction, so every block gets about the same number of k tiles; a block's
//     producer loads the next item's Q (as soon as the last Q K^T of this one is done) and
//     K / V tiles while the consumers finish this one, so an item's start and end overlap
//     its neighbours' work instead of each block's paying its own;
//   * the epilogue scales O by 1/l, writes it bf16 into the warpgroup's staging tile in the
//     swizzled layout and stores it with one TMA store per box (rows past T are clipped).
// flash_fwd_sm90_schedule in ops/transformer/flash_attention.py is this kernel's schedule
// in Python (the q tiles in launch order, the k tiles each visits, the masked ones).
//
// C interface for ctypes: the argument list of flash_fwd (flash_attention.cu); returns
// cudaGetLastError() after the launch (0 on success), -1 for a dtype / head dim / shape it
// was not built for, -2 when a tensor map cannot be encoded (alignment, strides) and -3
// when the driver has no cuTensorMapEncodeTiled.

#include <cuda.h>  // CUtensorMap and its enums; the driver function is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 128;
constexpr int kConsumers = 2;                              // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * kWgThreads;    // and one producer warpgroup
constexpr int kBQ = 64 * kConsumers;                       // q rows per block
constexpr int kBox = 64;                                   // bf16 columns per swizzle row
constexpr int kBoxBytes = 64 * 128;                        // a 64-row box
constexpr float kNegInf = -1e30f;                          // flash_attention.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned long long kHangNs = 2000000000ull;      // an mbarrier wait past this traps

template <int D>
struct Cfg {
  static constexpr int kBN = 128;      // keys per K / V tile
  static constexpr int kStages = 2;    // K and V tiles in the ring
  static constexpr int kBoxes = D / kBox;
  static constexpr int kQBytes = kBQ * D * 2;           // the Q tile, and O's staging tile
  static constexpr int kTileBytes = kBN * D * 2;        // one K or V tile
  static constexpr int kTileBox = kBN * 128;            // one box of a K or V tile
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + 2 * static_cast<size_t>(kStages) * kTileBytes + 8 * (2 + 4 * kStages);
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// k tiles a q tile starting at row q0 visits: every tile under T, and when causal only
// those holding a key <= its last row
__host__ __device__ __forceinline__ int n_ktiles(int T, int q0, int causal, int bn) {
  const int nk = cdiv(T, bn), last = (q0 + kBQ - 1) / bn + 1;
  return causal && last < nk ? last : nk;
}

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

// Wait for the phase of parity `parity` of an mbarrier.  A wait that lasts past kHangNs is a
// fault of the schedule (a barrier nobody will complete): trap, so the launch fails instead
// of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try(a, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try(a, parity))
    if (globaltimer() - t0 > kHangNs) __trap();
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWgThreads) : "memory");
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
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define F8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, fp32) (+)= A (64 x 16) B (16 x 128): A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers) B (16 x 64): B in shared
// memory, MN-major (rows of B contiguous: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x with one MUFU instruction (denormal results flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_min(float x) {
  x = fminf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fminf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Params {
  float* lse;
  int T, H, causal;
  int nq, n_work;  // q tiles per (b, h); work items (q tile, b, h)
  float scale2;    // scale * log2 e
};

// ---------------------------------------------------------------- the kernel
// Accumulator layout of a warpgroup's 64 x N product (wgmma, fp32): warp w of the group
// holds rows 16 w + g and 16 w + g + 8 (g = lane / 4); element 4 n + 2 r + e is row
// 16 w + g + 8 r, column 8 n + 2 (lane % 4) + e.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                    Params p) {
  using C = Cfg<D>;
  constexpr int kBN = C::kBN, kS = C::kStages, kBoxes = C::kBoxes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzled tiles must start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;                        // [consumer][box][64 rows][128 bytes]
  unsigned char* sO = sQ + C::kQBytes;             // the same, O on its way out
  unsigned char* sK = sO + C::kQBytes;             // [stage][box][kBN rows][128 bytes]
  unsigned char* sV = sK + kS * C::kTileBytes;     // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kS * C::kTileBytes);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* k_empty = k_full + kS;
  uint64_t* v_full = k_empty + kS;
  uint64_t* v_empty = v_full + kS;

  const int T = p.T, H = p.H;
  const int wg = threadIdx.x / kWgThreads;
  // work item w: q tile nq - 1 - w / (B H) of (b, h) = w % (B H), so the longest causal
  // rows come first.  In round r a block takes item r G + blockIdx.x, or r G + G - 1 -
  // blockIdx.x when r is odd (G = gridDim.x): a snake over the blocks, so the blocks that
  // take the longer item of one round take the shorter of the next
  auto work = [&](int r) {
    const int G = gridDim.x, x = blockIdx.x;
    return r * G + ((r & 1) ? G - 1 - x : x);
  };
  auto item = [&](int w, int& b, int& h, int& q0) {
    const int bh = w % (p.n_work / p.nq);
    b = bh / H;
    h = bh % H;
    q0 = (p.nq - 1 - w / (p.n_work / p.nq)) * kBQ;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers * 4);  // one arrival per consumer warp
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumers * 4);
      mbar_init(&v_empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    int t = 0;  // K / V tiles issued by this block
    for (int i = 0, w = work(0); w < p.n_work; w = work(++i)) {
      int b, h, q0;
      item(w, b, h, q0);
      const int nk = n_ktiles(T, q0, p.causal, kBN);
      mbar_wait(q_empty, (i & 1) ^ 1);  // the previous item's last Q K^T is done
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c)
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(sQ + (c * kBoxes + x) * kBoxBytes, &tq, q_full, x * kBox, h, q0 + 64 * c, b);
      // k tiles from the last (the diagonal one, or the ragged end) down to 0
      for (int j = nk - 1; j >= 0; --j, ++t) {
        const int s = t % kS, ph = (t / kS) & 1;
        mbar_wait(&k_empty[s], ph ^ 1);
        mbar_expect_tx(&k_full[s], C::kTileBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(sK + s * C::kTileBytes + x * C::kTileBox, &tk, &k_full[s], x * kBox, h,
                   j * kBN, b);
        mbar_wait(&v_empty[s], ph ^ 1);
        mbar_expect_tx(&v_full[s], C::kTileBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load(sV + s * C::kTileBytes + x * C::kTileBox, &tv, &v_full[s], x * kBox, h,
                   j * kBN, b);
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int tid = static_cast<int>(threadIdx.x) - wg * kWgThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = (lane & 3) * 2;
  const unsigned char* myQ = sQ + c * kBoxes * kBoxBytes;
  unsigned char* myO = sO + c * kBoxes * kBoxBytes;
  const float scale2 = p.scale2;
  int t = 0;  // K / V tiles consumed by this block
  for (int i = 0, w = work(0); w < p.n_work; w = work(++i)) {
    int b, h, q0;
    item(w, b, h, q0);
    const int nk = n_ktiles(T, q0, p.causal, kBN);
    const int qw = q0 + 64 * c;                        // this warpgroup's first row
    const int row[2] = {qw + 16 * warp + g, qw + 16 * warp + g + 8};
    float o[kBoxes][32];
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[x][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's partial sums
    float sc[kBN / 2];                                   // S, then P in fp32
    uint32_t pa[kBN / 16][4];                            // P as bf16 A fragments

    mbar_wait(q_full, i & 1);
    for (int j = nk - 1; j >= 0; --j, ++t) {
      const int k0 = j * kBN, s = t % kS, ph = (t / kS) & 1;
      // S = Q K^T, both operands in shared memory
      const unsigned char* tK = sK + s * C::kTileBytes;
      mbar_wait(&k_full[s], ph);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int x = kk / 4, off = (kk % 4) * 32;
        wgmma_ss_n128(sc, desc_sw128(myQ + x * kBoxBytes + off, 16, 1024),
                      desc_sw128(tK + x * C::kTileBox + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) {
        mbar_arrive(&k_empty[s]);
        if (j == 0) mbar_arrive(q_empty);
      }

      // the online softmax in log2 units; only a tile crossing the diagonal or the ragged
      // end takes the per-element mask.  Row max and row sum over four independent
      // partials per row (short dependency chains): partial (n % 2) * 2 + e % 2 of row e / 2
      const bool masked = k0 + kBN > T || (p.causal && k0 + kBN - 1 > qw);
      float mp[2][4];
      if (masked) {
#pragma unroll
        for (int e = 0; e < 8; ++e) mp[e >> 2][e & 3] = kNegInf;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, col = k0 + n * 8 + qd + (e & 1);
            const bool valid = col < T && (!p.causal || row[r] >= col);
            const float x = valid ? sc[4 * n + e] * scale2 : kNegInf;
            sc[4 * n + e] = x;
            mp[r][(n & 1) * 2 + (e & 1)] = fmaxf(mp[r][(n & 1) * 2 + (e & 1)], x);
          }
      } else if (scale2 >= 0.f) {  // max(S) * scale = max(S * scale)
#pragma unroll
        for (int e = 0; e < 8; ++e) mp[e >> 2][e & 3] = sc[(e >> 2) * 2 + (e & 1) + (e & 2) * 2];
#pragma unroll
        for (int n = 2; n < kBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& a = mp[e >> 1][(n & 1) * 2 + (e & 1)];
            a = fmaxf(a, sc[4 * n + e]);
          }
      } else {  // a negative scale: min(S) * scale = max(S * scale)
#pragma unroll
        for (int e = 0; e < 8; ++e) mp[e >> 2][e & 3] = sc[(e >> 2) * 2 + (e & 1) + (e & 2) * 2];
#pragma unroll
        for (int n = 2; n < kBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& a = mp[e >> 1][(n & 1) * 2 + (e & 1)];
            a = fminf(a, sc[4 * n + e]);
          }
      }
      float mn[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx;
        if (masked || scale2 >= 0.f)
          mx = quad_max(fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3])));
        else
          mx = quad_min(fminf(fminf(mp[r][0], mp[r][1]), fminf(mp[r][2], mp[r][3])));
        if (!masked) mx *= scale2;
        mn[r] = fmaxf(m[r], mx);
        alpha[r] = exp2_ftz(m[r] - mn[r]);
        m[r] = mn[r];
      }
      float ls[2][4] = {};
      if (masked) {
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = sc[4 * n + e] == kNegInf ? 0.f : exp2_ftz(sc[4 * n + e] - mn[e >> 1]);
            sc[4 * n + e] = x;
            ls[e >> 1][(n & 1) * 2 + (e & 1)] += x;
          }
      } else {
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = exp2_ftz(fmaf(sc[4 * n + e], scale2, -mn[e >> 1]));
            sc[4 * n + e] = x;
            ls[e >> 1][(n & 1) * 2 + (e & 1)] += x;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] = l[r] * alpha[r] + ((ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]));
      // P as bf16 A fragments: a 16-column slice of the accumulator is one fragment
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[kk][q] = pack_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[x][e] *= alpha[(e >> 1) & 1];

      // O += P V, P from registers, V's rows read through the transpose bit
      const unsigned char* tV = sV + s * C::kTileBytes;
      mbar_wait(&v_full[s], ph);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_rs_n64_tb(o[x], pa[kk],
                          desc_sw128(tV + x * C::kTileBox + kk * 16 * 128, C::kTileBox, 1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) fence_regs(o[x]);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&v_empty[s]);
    }

    // ---------------------------------------------------------- epilogue
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lsum = quad_sum(l[r]);
      const bool live = m[r] > kNegInf * 0.5f;
      const float l_safe = lsum == 0.f ? 1.f : lsum;
      inv[r] = live ? 1.f / l_safe : 0.f;
      if ((lane & 3) == 0 && row[r] < T)
        p.lse[(static_cast<long long>(b) * H + h) * T + row[r]] =
            live ? m[r] * kLn2 + logf(l_safe) : kNegInf;
    }
    named_barrier(1 + c);  // the group's previous store has read the staging tile
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rl = 16 * warp + g + 8 * r;  // row in the group's 64
          const uint32_t v =
              pack_bf16(o[x][4 * n + 2 * r] * inv[r], o[x][4 * n + 2 * r + 1] * inv[r]);
          unsigned char* dst = myO + x * kBoxBytes + rl * 128 + ((n ^ (rl & 7)) << 4) + qd * 2;
          *reinterpret_cast<uint32_t*>(dst) = v;
        }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(1 + c);
    if (tid == 0) {
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) tma_store(&to, myO + x * kBoxBytes, x * kBox, h, qw, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, so the library needs no -lcuda
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

// A 4-D map (D, H, T, B) of a bf16 (B, T, H, D) tensor with element strides s[0..2] for
// (b, t, h), read in boxes of 64 columns x `rows` rows of one (b, h), 128-byte swizzled.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, const long long* s, int B, int T,
              int H, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s[2]) * 2,
                                 static_cast<cuuint64_t>(s[1]) * 2,
                                 static_cast<cuuint64_t>(s[0]) * 2};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           const long long* strides, int B, int T, int H, int causal, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -3;
  CUtensorMap mq, mk, mv, mo;
  const long long so[3] = {static_cast<long long>(T) * H * D, static_cast<long long>(H) * D, D};
  if (!make_map(enc, &mq, q, strides, B, T, H, D, 64) ||
      !make_map(enc, &mk, k, strides + 3, B, T, H, D, C::kBN) ||
      !make_map(enc, &mv, v, strides + 6, B, T, H, D, C::kBN) ||
      !make_map(enc, &mo, out, so, B, T, H, D, 64))
    return -2;
  const int nq = cdiv(T, kBQ), n_work = nq * B * H;
  const Params p = {lse, T, H, causal, nq, n_work, scale * kLog2e};
  int dev = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = sms < n_work ? sms : n_work;  // persistent: one block per SM
  fwd_sm90_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(mq, mk, mv, mo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64, the (b, t, h) element strides of q, k, v (and dout's, ignored here).
extern "C" int flash_fwd_sm90(int dtype, int head_dim, const void* q, const void* k,
                              const void* v, void* out, float* lse, const long long* strides,
                              int B, int T, int H, int causal, float scale, void* stream) {
  if (dtype != 1 || static_cast<long long>(cdiv(T, kBQ)) * B * H > 0x7fffffffLL) return -1;
  if (T == 0 || B * H == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64>(q, k, v, out, lse, strides, B, T, H, causal, scale, st);
    case 128: return launch<128>(q, k, v, out, lse, strides, B, T, H, causal, scale, st);
    default: return -1;
  }
}

// Flash-attention forward for Hopper (sm_90a) built the way the card is meant to be used:
// the entry flash_fwd_sm90, bf16 and fp16 (fp16 training, below), head dims 64 and 128, causal
// or not, with or without a key bias.
//
// Replaces the Pallas TPU kernel _fwd_kernel of deepspeed_tpu/ops/transformer/flash_attention.py
// (144-283, built by _fwd 441-613) on its dense path with no LUT: without a bias, and (the kBias
// instances) with use_kbias, the (B, T) key bias added to the scores at 218 (reached through
// flash_attention(key_padding_bias=) 913 -> _biased_call 1221 -> _make_biased_bhtd 1178).  The
// template fwd_kernel of flash_attention.cuh (4 warps, 64-row q tiles, mma.sync, a cp.async
// double buffer) keeps fp32, head dim 96 and the (T, T) score bias (flash_fwd and
// flash_fwd_biased); ops/transformer/flash_attention.py routes bf16 and fp16 at head dims 64
// and 128 here (dense_fwd_kernel, biased_fwd_kernel).  It computes what fwd_kernel computes on its
// dense path:
//   S = Q K^T * scale (+ kbias[b, k_pos]), masked with NEG_INF = -1e30 where k_pos >= T or,
//   when causal, q_pos < k_pos; an online softmax over the visited k tiles with fp32 m, l and
//   O; P
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
//     swizzled layout and stores it with one TMA store per box (rows past T are clipped);
//   * the key bias (kBias): a (B, T) fp32 row of any T has no 16-byte aligned stride, so no
//     TMA map: the producer warp's 32 lanes copy each K tile's kBN bias values with 4-byte
//     cp.async into a ring of their own beside K (zeros from T on), after the stage's V slot
//     is free (the consumers read the bias until their P V), arriving on the stage's K full
//     barrier, which then counts 1 + 32 arrivals.  The consumers add it in log2 units
//     (kbias log2 e) to every score before the row maximum, on masked and unmasked tiles
//     alike; a padded key (-10000, or NEG_INF for a mul bias) needs no element mask, and a
//     row whose every key carries NEG_INF keeps m = NEG_INF and writes O = 0, lse = NEG_INF
//     (the live test of the epilogue), which the key-bias backward kernels read as +inf.
//     The producer keeps 40 registers and the consumers 232 in these instances (24 / 240
//     without the bias, where the producer is one thread).
// flash_fwd_sm90_schedule in ops/transformer/flash_attention.py is this kernel's schedule
// in Python (the q tiles in launch order, the k tiles each visits, the masked ones).
//
// Two more schedules run the same block (the template's kSched), for the causal block-sparse
// path's forwards; what changes is which k tiles a work item visits and which take the
// element mask.  Both replace the templates of flash_attention_band_merge_fwd.cu (mma.sync,
// cp.async, 64-row q tiles), which keep fp32 and head dim 96:
//   * flash_fwd_banded_sm90 (kBanded) replaces _fwd_kernel with use_banded (180-198 for the
//     affine slots, 230-244 for the positional band mask): causal attention over a layout
//     shared by the heads whose live blocks are a band of W layout blocks below the diagonal
//     plus global columns.  Its schedule is computed in the kernel from the BandSm90
//     parameter, with no LUT in device memory: for the q tile at q0 (first layout row r0),
//     the 128-key tiles of the kernel global columns that lie wholly below the band's first
//     key (gtile, ascending), then the band's tiles from floor(max(r0 - W + 1, 0) Lb / 128)
//     up to the tile holding q0 + 127.  The producer works out, for each tile it issues, each
//     16-key chunk's layout column and whether it is global, and for each consumer's 64 rows
//     whether the tile needs the element mask (it crosses T or the diagonal, or holds a key
//     of a non-global column below the band of the half's last row), and hands them to the
//     consumers in the stage's slot; a masked tile's live test is k <= q, k < T and
//     row(q) - col(k) < W or col(k) global (the chunk's column, so layout blocks 16 and 32
//     are exact too).  At the workload's block 64, W = 13, only the band's first tile (for
//     the lower half) and the diagonal one are masked.
//   * flash_fwd_merged_sm90 (kMerged) replaces _fwd_kernel with use_merge (161-164, 245-255)
//     and _fwd_kernel_dma with use_merge (317-319, 384-390): a work item is one merged row
//     of the MergedLut, q tiles 2i and 2i + 1 of 64 rows, which are the two consumers'
//     halves.  The producer walks the row's k list (its 32 lanes load 32 slots at a time and
//     hand them round by shuffles) and puts each slot's tile masks, one a half and 64-key
//     subtile (adjacent 64-key tiles paired on the host into 128-key slots, none wholly above
//     a causal half's diagonal), in the stage's slot; a consumer whose masks are all 0 skips
//     both products but still waits for the tile and releases the stage, -1 needs no
//     element mask (but for T and, when causal, the diagonal), cell bits mask per element
//     at the layout's cell size.  An odd last tile leaves half 1 empty: its rows are past T
//     and not stored.
// In both the producer keeps 40 registers and the consumers 232, as in the kBias instances.
//
// fp16 (dtype code 2): every instance at head dims 64 and 128, dense with and without the key
// bias, banded and merged (fwd_sm90_kernel<D, kBias, kSched, f16>), is the bf16 one with the
// element type a template parameter: wgmma .f32.f16.f16, P rounded to fp16 before P V
// (__floats2half2_rn), O written fp16 and the tensor maps of data type FLOAT16.  The scores,
// the key bias (a padded key's NEG_INF included), m, l and lse stay fp32.  An O past fp16's
// 65504 (it is a convex mix of V rows, so only an inf or a V past 65504 gives one) becomes
// inf: no conversion saturates.
// flash_fwd_banded_sm90_schedule / flash_fwd_merged_sm90_schedule are these schedules in
// Python.
//
// C interface for ctypes: the argument list of flash_fwd (flash_attention.cu), then the key
// bias (null for none) before the stream; the banded and merged entries take their
// schedule (a BandSm90, a MergedSched) in its place.  Each returns
// cudaGetLastError() after the launch (0 on success), -1 for a dtype / head dim / shape it
// was not built for, -2 when a tensor map cannot be encoded (alignment, strides) and -3
// when the driver has no cuTensorMapEncodeTiled.

#include <cuda.h>  // CUtensorMap and its enums; the driver function is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// The schedule structs the C entries take (ctypes Structures on the host), outside the
// anonymous namespace so the entries keep external linkage.
//
// The banded schedule's parameter (flash_fwd_banded_sm90): band width W and layout block lb,
// the 128-key tiles holding a kernel global column (ascending), and a bit per layout column
// that is global.  Sized for T <= 65536: 512 tiles, 4096 layout columns of 16.
constexpr int kMaxBandTiles = 512;
constexpr int kMaxBandCols = 4096;
struct BandSm90 {
  int w, lb, n_gtiles;
  unsigned short gtile[kMaxBandTiles];
  unsigned int gbits[kMaxBandCols / 32];
};

// The merged schedule (flash_fwd_merged_sm90): for head layout hl (h, or 0 when shared) and
// merged row r, len[hl rows + r] slots; slot j is key tile map[(hl rows + r) width + j] of
// 128 keys, with two masks a half, one a 64-key subtile, at mask[((hl rows + r) width + j) 4
// + half 2 + sub]: -1, the cell bits of a 64 x 64 tile (bit (q_cell << (6 - cell_shift)) +
// k_cell), or 0 (the half has no such tile).
struct MergedSched {
  const int* map;
  const int* mask;
  const int* len;
  int width, heads, cell_shift;
};

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
// whether an element type E (bf16 or f16) is fp16
template <typename E>
constexpr bool kHalf = std::is_same<E, f16>::value;

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

// the schedules: every k tile up to T (and the diagonal); the band and global tiles of a
// BandSm90; the k list of a merged row of a MergedLut
constexpr int kDense = 0, kBanded = 1, kMerged = 2;
constexpr int kSlotInts = 16;   // a stage's slot: k0, the halves' flags or masks, chunk columns

template <int D, bool kBias, int kSched = kDense>
struct Cfg {
  static constexpr int kBN = 128;      // keys per K / V tile (a merged slot: two 64-key tiles)
  static constexpr int kStages = 2;    // K and V tiles in the ring
  static constexpr int kBoxes = D / kBox;
  static constexpr int kQBytes = kBQ * D * 2;           // the Q tile, and O's staging tile
  static constexpr int kTileBytes = kBN * D * 2;        // one K or V tile
  static constexpr int kTileBox = kBN * 128;            // one box of a K or V tile
  static constexpr int kBiasBytes = kBias ? kStages * kBN * 4 : 0;   // the key bias's ring
  // the schedule's slots (a stage's tile and flags, and the item's visit count)
  static constexpr int kSlotBytes = kSched == kDense ? 0 : (kStages + 1) * kSlotInts * 4;
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + 2 * static_cast<size_t>(kStages) * kTileBytes +
                                  kBiasBytes + kSlotBytes + 8 * (2 + 4 * kStages);
  // lanes of the producer warp that run: its copies of the key bias, its loads of a merged
  // row's k list; else one
  static constexpr int kProducerLanes = kBias || kSched == kMerged ? 32 : 1;
  // setmaxnreg: the producer warpgroup's and the consumers' registers
  static constexpr int kProducerRegs = kBias || kSched != kDense ? 40 : 24;
  static constexpr int kConsumerRegs = kBias || kSched != kDense ? 232 : 240;
};

struct NoSched {};
template <int S> struct SchedArg { using type = NoSched; };
template <> struct SchedArg<kBanded> { using type = BandSm90; };
template <> struct SchedArg<kMerged> { using type = MergedSched; };

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

// 4 bytes from global to shared memory, asynchronously; zeros where !valid (src is then not
// read, but must be a valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// An arrival on an mbarrier once the thread's earlier cp.async copies have landed; it is one of
// the arrivals the barrier was initialised to expect (noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
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

// d (64 x 128, fp32) (+)= A (64 x 16) B (16 x 128): A and B K-major in shared memory, of
// element type E (TY: its PTX type, bf16 or f16)
#define WGMMA_SS_N128(TY)                                                             \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                   \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"                                                 \
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)                  \
      : "l"(da), "l"(db), "r"(accumulate))
template <typename E>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  if constexpr (kHalf<E>)
    WGMMA_SS_N128("f16");
  else
    WGMMA_SS_N128("bf16");
}
#undef WGMMA_SS_N128

// d (64 x 64, fp32) += A (64 x 16, E fragments in registers) B (16 x 64): B in shared
// memory, MN-major (rows of B contiguous: the transpose bit)
#define WGMMA_RS_N64_TB(TY)                                                           \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                    \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                   \
      : F8(0), F8(8), F8(16), F8(24)                                                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename E>
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  if constexpr (kHalf<E>)
    WGMMA_RS_N64_TB("f16");
  else
    WGMMA_RS_N64_TB("bf16");
}
#undef WGMMA_RS_N64_TB
#undef F8

// two floats rounded to nearest into one word of E: lo in the low half (an fp16 value past
// 65504 becomes inf, not 65504)
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf<E>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
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
  const float* kbias;  // (B, T) fp32, contiguous: the key bias (kBias instances)
  int T, H, causal;
  int nq, n_work;  // q tiles per (b, h); work items (q tile, b, h)
  float scale2;    // scale * log2 e
};

// ---------------------------------------------------------------- the banded schedule
// The visits of the q tile at q0: n_glob global tiles (gtile[0 .. n_glob - 1]), then the
// band's tiles lo .. hi; visit j is tile gtile[j] for j < n_glob, else lo + j - n_glob.
struct BandItem {
  int n_glob, lo, n;
};

__device__ __forceinline__ BandItem band_item(const BandSm90& bd, int q0, int T, int bn) {
  BandItem it;
  const int r0 = q0 / bd.lb;
  it.lo = (r0 - bd.w + 1 > 0 ? r0 - bd.w + 1 : 0) * bd.lb / bn;
  const int last = (q0 + kBQ - 1) / bn, nk = cdiv(T, bn);
  const int hi = last < nk - 1 ? last : nk - 1;
  it.n_glob = 0;
  while (it.n_glob < bd.n_gtiles && bd.gtile[it.n_glob] < it.lo) ++it.n_glob;
  it.n = it.n_glob + (hi >= it.lo ? hi - it.lo + 1 : 0);
  return it;
}

// Fill a stage's slot for the banded tile at k0: [0] k0; [1 + c] whether consumer c's 64 rows
// need the element mask; [3] a bit per 16-key chunk whose layout column is global; [4 + u]
// chunk u's layout column.
template <int kBN>
__device__ __forceinline__ void band_slot(int* slot, const BandSm90& bd, int k0, int q0, int T) {
  // the halves' last layout rows; a half's edge: a key of a non-global column below the band
  // of that row
  const int r_last0 = (q0 + 63) / bd.lb, r_last1 = (q0 + 127) / bd.lb;
  int gbits = 0;
  bool edge0 = false, edge1 = false;
#pragma unroll
  for (int u = 0; u < kBN / 16; ++u) {
    const int cu = (k0 + 16 * u) / bd.lb;
    const bool g = cu < kMaxBandCols && ((bd.gbits[cu >> 5] >> (cu & 31)) & 1);
    gbits |= g << u;
    edge0 |= r_last0 - cu >= bd.w && !g;
    edge1 |= r_last1 - cu >= bd.w && !g;
    slot[4 + u] = cu;
  }
  slot[0] = k0;
  slot[1] = k0 + kBN > T || k0 + kBN - 1 > q0 || edge0;
  slot[2] = k0 + kBN > T || k0 + kBN - 1 > q0 + 64 || edge1;
  slot[3] = gbits;
}

// ---------------------------------------------------------------- the kernel
// Accumulator layout of a warpgroup's 64 x N product (wgmma, fp32): warp w of the group
// holds rows 16 w + g and 16 w + g + 8 (g = lane / 4); element 4 n + 2 r + e is row
// 16 w + g + 8 r, column 8 n + 2 (lane % 4) + e.
template <int D, bool kBias, int kSched, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                    Params p, const __grid_constant__ typename SchedArg<kSched>::type sa) {
  using C = Cfg<D, kBias, kSched>;
  constexpr int kBN = C::kBN, kS = C::kStages, kBoxes = C::kBoxes;
  constexpr int kSubs = kBN / 64;   // the merged schedule's masks a half and slot
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzled tiles must start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;                        // [consumer][box][64 rows][128 bytes]
  unsigned char* sO = sQ + C::kQBytes;             // the same, O on its way out
  unsigned char* sK = sO + C::kQBytes;             // [stage][box][kBN rows][128 bytes]
  unsigned char* sV = sK + kS * C::kTileBytes;     // the same
  float* sKb = reinterpret_cast<float*>(sV + kS * C::kTileBytes);  // [stage][kBN] (kBias)
  // [stage][kSlotInts] the schedule's slots, then the item's visit count (kBanded, kMerged)
  int* sSlot = reinterpret_cast<int*>(sV + kS * C::kTileBytes + C::kBiasBytes);
  int* sNk = sSlot + kS * kSlotInts;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(sV + kS * C::kTileBytes + C::kBiasBytes + C::kSlotBytes);
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
      mbar_init(&k_full[s], kBias ? 1 + 32 : 1);  // the TMA issue (and the key bias lanes)
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumers * 4);
      mbar_init(&v_empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    // thread 0 issues every TMA copy; with the key bias, the warp's 32 lanes copy the bias;
    // with the merged schedule, they load the row's k list
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    const int lane = threadIdx.x;
    if (lane >= C::kProducerLanes) return;
    int t = 0;  // K / V tiles issued by this block
    for (int i = 0, w = work(0); w < p.n_work; w = work(++i)) {
      int b, h, q0;
      item(w, b, h, q0);
      int nk;
      BandItem bi;
      const int* row_map = nullptr;
      const int* row_mask = nullptr;
      if constexpr (kSched == kDense) {
        nk = n_ktiles(T, q0, p.causal, kBN);
      } else if constexpr (kSched == kBanded) {
        bi = band_item(sa, q0, T, kBN);
        nk = bi.n;
      } else {
        // the merged row's list, read before the wait for the previous item's Q
        const long long r = static_cast<long long>(sa.heads == 1 ? 0 : h) * p.nq + q0 / kBQ;
        row_map = sa.map + r * sa.width;
        row_mask = sa.mask + r * sa.width * 2 * kSubs;
        nk = sa.len[r];
      }
      // the merged row's slots, 32 at a time: lane x holds slot (j & ~31) + x
      int e_map = 0, e_mask[2 * kSubs] = {};
      if (lane == 0) {
        mbar_wait(q_empty, (i & 1) ^ 1);  // the previous item's last Q K^T is done
        if constexpr (kSched != kDense) *sNk = nk;  // released by the arrival below
        mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
        for (int c = 0; c < kConsumers; ++c)
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
            tma_load(sQ + (c * kBoxes + x) * kBoxBytes, &tq, q_full, x * kBox, h, q0 + 64 * c, b);
      }
      // k tiles from the last visit (the diagonal one, or the ragged end) down to the first
      for (int j = nk - 1; j >= 0; --j, ++t) {
        const int s = t % kS, ph = (t / kS) & 1;
        int k0 = j * kBN;
        if constexpr (kSched == kBanded) {
          k0 = (j < bi.n_glob ? static_cast<int>(sa.gtile[j]) : bi.lo + j - bi.n_glob) * kBN;
        } else if constexpr (kSched == kMerged) {
          if (j == nk - 1 || (j & 31) == 31) {
            const int e = (j & ~31) + lane;
            if (e < nk) {
              e_map = row_map[e];
#pragma unroll
              for (int x = 0; x < 2 * kSubs; ++x) e_mask[x] = row_mask[e * 2 * kSubs + x];
            }
          }
          k0 = __shfl_sync(0xffffffffu, e_map, j & 31) * kBN;
        }
        int masks[2 * kSubs];
        if constexpr (kSched == kMerged) {
#pragma unroll
          for (int x = 0; x < 2 * kSubs; ++x)
            masks[x] = __shfl_sync(0xffffffffu, e_mask[x], j & 31);
        }
        if (lane == 0) {
          mbar_wait(&k_empty[s], ph ^ 1);
          int* slot = sSlot + s * kSlotInts;   // read by the consumers before they free K
          if constexpr (kSched == kBanded) band_slot<kBN>(slot, sa, k0, q0, T);
          if constexpr (kSched == kMerged) {
            slot[0] = k0;
#pragma unroll
            for (int x = 0; x < 2 * kSubs; ++x) slot[1 + x] = masks[x];
          }
          mbar_expect_tx(&k_full[s], C::kTileBytes);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
            tma_load(sK + s * C::kTileBytes + x * C::kTileBox, &tk, &k_full[s], x * kBox, h, k0,
                     b);
        }
        if (kBias || lane == 0) mbar_wait(&v_empty[s], ph ^ 1);  // and the stage's bias slot
        if constexpr (kBias) {
          // keys k0 .. k0 + kBN - 1 of batch row b, four a lane, zeros from T on
#pragma unroll
          for (int x = 0; x < kBN / 32; ++x) {
            const int col = k0 + 32 * x + lane;
            const bool in = col < T;
            cp_async4(sKb + s * kBN + 32 * x + lane,
                      p.kbias + (in ? static_cast<long long>(b) * T + col : 0), in);
          }
          cp_async_arrive(&k_full[s]);
        }
        if (lane == 0) {
          mbar_expect_tx(&v_full[s], C::kTileBytes);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
            tma_load(sV + s * C::kTileBytes + x * C::kTileBox, &tv, &v_full[s], x * kBox, h, k0,
                     b);
        }
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
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
    const int qw = q0 + 64 * c;                        // this warpgroup's first row
    const int row[2] = {qw + 16 * warp + g, qw + 16 * warp + g + 8};
    int rrow[2] = {0, 0};                              // kBanded: the rows' layout rows
    if constexpr (kSched == kBanded) {
      rrow[0] = row[0] / sa.lb;
      rrow[1] = row[1] / sa.lb;
    }
    float o[kBoxes][32];
#pragma unroll
    for (int x = 0; x < kBoxes; ++x)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[x][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's partial sums
    float sc[kBN / 2];                                   // S, then P in fp32
    uint32_t pa[kBN / 16][4];                            // P as bf16 A fragments

    mbar_wait(q_full, i & 1);
    const int nk = kSched == kDense ? n_ktiles(T, q0, p.causal, kBN) : *sNk;
    if (nk == 0 && lane == 0) mbar_arrive(q_empty);    // a merged row with no slot
    for (int j = nk - 1; j >= 0; --j, ++t) {
      const int s = t % kS, ph = (t / kS) & 1;
      mbar_wait(&k_full[s], ph);
      // the visit: its first key, whether this warpgroup computes it and whether it takes
      // the element mask; kBanded: each row's live chunks (bit u: chunk u is in the row's
      // band or global); kMerged: each row's cell bits of its tile masks
      const int* slot = sSlot + s * kSlotInts;
      int k0 = j * kBN;
      bool visit = true, masked;
      uint32_t live[2] = {~0u, ~0u};
      int cell[2][kSubs];
      if constexpr (kSched == kDense) {
        masked = k0 + kBN > T || (p.causal && k0 + kBN - 1 > qw);
      } else if constexpr (kSched == kBanded) {
        k0 = slot[0];
        masked = slot[1 + c] != 0;
        if (masked) {
          const int gb = slot[3];
          live[0] = live[1] = 0;
#pragma unroll
          for (int u = 0; u < kBN / 16; ++u) {
            const int cu = slot[4 + u];
#pragma unroll
            for (int r = 0; r < 2; ++r)
              live[r] |= static_cast<uint32_t>(rrow[r] - cu < sa.w || ((gb >> u) & 1)) << u;
          }
        }
      } else {
        k0 = slot[0];
        int any = 0, whole = 1;
        const int cs = sa.cell_shift;
#pragma unroll
        for (int x = 0; x < kSubs; ++x) {
          const int cm = slot[1 + c * kSubs + x];
          any |= cm;
          whole &= cm == -1;
#pragma unroll
          for (int r = 0; r < 2; ++r) cell[r][x] = cm >> (((row[r] - qw) >> cs) << (6 - cs));
        }
        visit = any != 0;
        masked = !whole || k0 + kBN > T || (p.causal && k0 + kBN - 1 > qw);
      }
      // S = Q K^T, both operands in shared memory
      const unsigned char* tK = sK + s * C::kTileBytes;
      if (visit) {
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int x = kk / 4, off = (kk % 4) * 32;
          wgmma_ss_n128<E>(sc, desc_sw128(myQ + x * kBoxBytes + off, 16, 1024),
                           desc_sw128(tK + x * C::kTileBox + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
      }
      if (lane == 0) {
        mbar_arrive(&k_empty[s]);
        if (j == 0) mbar_arrive(q_empty);
      }
      if (!visit) {
        // kMerged: no live tile of this half here; the stage is released once its V has
        // landed (V of this round lands only after the previous round's release, so this
        // arrival cannot count toward the previous round while the other half reads it)
        mbar_wait(&v_full[s], ph);
        if (lane == 0) mbar_arrive(&v_empty[s]);
        continue;
      }

      // the online softmax in log2 units; only a tile crossing the diagonal or the ragged
      // end takes the per-element mask.  Row max and row sum over four independent
      // partials per row (short dependency chains): partial (n % 2) * 2 + e % 2 of row e / 2.
      // With the key bias every score is scaled and biased in place first (pre)
      const bool pre = kBias || masked;
      float mp[2][4];
      if (pre) {
        const float* kb = sKb + s * kBN;   // this tile's key bias (kBias)
        // scores scaled (and biased) in place, with (kMasked) or without the element mask
        auto scale_bias = [&](auto kMasked) {
#pragma unroll
          for (int e = 0; e < 8; ++e) mp[e >> 2][e & 3] = kNegInf;
#pragma unroll
          for (int n = 0; n < kBN / 8; ++n) {
            float2 kb2 = make_float2(0.f, 0.f);
            if (kBias) {
              kb2 = *reinterpret_cast<const float2*>(kb + n * 8 + qd);
              kb2.x *= kLog2e;
              kb2.y *= kLog2e;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, col = k0 + n * 8 + qd + (e & 1);
              float x = kBias ? fmaf(sc[4 * n + e], scale2, (e & 1) ? kb2.y : kb2.x)
                              : sc[4 * n + e] * scale2;
              if constexpr (decltype(kMasked)::value) {
                bool ok = col < T && (!p.causal || row[r] >= col);
                if constexpr (kSched == kBanded) ok = ok && ((live[r] >> (n >> 1)) & 1);
                if constexpr (kSched == kMerged) {
                  const int ki = (n * 8 + qd + (e & 1)) & 63;   // the key in its 64-key subtile
                  ok = ok && ((cell[r][n / 8] >> (ki >> sa.cell_shift)) & 1);
                }
                if (!ok) x = kNegInf;
              }
              sc[4 * n + e] = x;
              mp[r][(n & 1) * 2 + (e & 1)] = fmaxf(mp[r][(n & 1) * 2 + (e & 1)], x);
            }
          }
        };
        if (!kBias || masked)
          scale_bias(std::true_type());
        else
          scale_bias(std::false_type());
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
        if (pre || scale2 >= 0.f)
          mx = quad_max(fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3])));
        else
          mx = quad_min(fminf(fminf(mp[r][0], mp[r][1]), fminf(mp[r][2], mp[r][3])));
        if (!pre) mx *= scale2;
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
      } else if (kBias) {
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = exp2_ftz(sc[4 * n + e] - mn[e >> 1]);
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
      // P as E A fragments: a 16-column slice of the accumulator is one fragment
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[kk][q] = pack2<E>(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
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
          wgmma_rs_n64_tb<E>(o[x], pa[kk],
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
              pack2<E>(o[x][4 * n + 2 * r] * inv[r], o[x][4 * n + 2 * r + 1] * inv[r]);
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

// A 4-D map (D, H, T, B) of a 16-bit (B, T, H, D) tensor of data type `type` with element
// strides s[0..2] for (b, t, h), read in boxes of 64 columns x `rows` rows of one (b, h),
// 128-byte swizzled.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, const long long* s, int B, int T,
              int H, int D, int rows, CUtensorMapDataType type) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s[2]) * 2,
                                 static_cast<cuuint64_t>(s[1]) * 2,
                                 static_cast<cuuint64_t>(s[0]) * 2};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, type, 4, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one call of instance (D, kBias, kSched) of element type E (bf16, fp16)
template <int D, bool kBias, int kSched = kDense, typename E = bf16>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           const long long* strides, int B, int T, int H, int causal, float scale,
           const float* kbias, const typename SchedArg<kSched>::type& sa, cudaStream_t stream) {
  using C = Cfg<D, kBias, kSched>;
  constexpr CUtensorMapDataType type =
      kHalf<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -3;
  CUtensorMap mq, mk, mv, mo;
  const long long so[3] = {static_cast<long long>(T) * H * D, static_cast<long long>(H) * D, D};
  if (!make_map(enc, &mq, q, strides, B, T, H, D, 64, type) ||
      !make_map(enc, &mk, k, strides + 3, B, T, H, D, C::kBN, type) ||
      !make_map(enc, &mv, v, strides + 6, B, T, H, D, C::kBN, type) ||
      !make_map(enc, &mo, out, so, B, T, H, D, 64, type))
    return -2;
  const int nq = cdiv(T, kBQ), n_work = nq * B * H;
  const Params p = {lse, kbias, T, H, causal, nq, n_work, scale * kLog2e};
  int dev = 0, sms = 0;
  auto kernel = fwd_sm90_kernel<D, kBias, kSched, E>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(C::kSmem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = sms < n_work ? sms : n_work;  // persistent: one block per SM
  kernel<<<grid, kThreads, C::kSmem, stream>>>(mq, mk, mv, mo, p, sa);
  return static_cast<int>(cudaGetLastError());
}

// a dense call of element type E, with or without the key bias
template <int D, typename E>
int launch_bias(const void* q, const void* k, const void* v, void* out, float* lse,
                const long long* strides, int B, int T, int H, int causal, float scale,
                const float* kbias, cudaStream_t stream) {
  const NoSched none{};
  return kbias != nullptr
             ? launch<D, true, kDense, E>(q, k, v, out, lse, strides, B, T, H, causal, scale,
                                          kbias, none, stream)
             : launch<D, false, kDense, E>(q, k, v, out, lse, strides, B, T, H, causal, scale,
                                           kbias, none, stream);
}

// one call of an entry: instance (D, kBias, kSched) at head dim 64 or 128, in bf16 (dtype code
// 1) or fp16 (code 2)
#define SM90_DISPATCH(CALL)                                     \
  switch (head_dim * 4 + dtype) {                               \
    case 64 * 4 + 1: return CALL(64, bf16);                     \
    case 64 * 4 + 2: return CALL(64, f16);                      \
    case 128 * 4 + 1: return CALL(128, bf16);                   \
    case 128 * 4 + 2: return CALL(128, f16);                    \
    default: return -1;                                         \
  }

// the entries' common refusals: bf16 (dtype code 1) or fp16 (code 2), and work item indices in
// an int
bool fits(int dtype, int B, int T, int H) {
  return (dtype == 1 || dtype == 2) && static_cast<long long>(cdiv(T, kBQ)) * B * H <= 0x7fffffffLL;
}

}  // namespace

// dtype: 1 bf16, 2 fp16; strides: 12 int64, the (b, t, h) element strides of q, k, v (and
// dout's, ignored here); kbias: the (B, T) fp32 key bias, contiguous, or null for none.
extern "C" int flash_fwd_sm90(int dtype, int head_dim, const void* q, const void* k,
                              const void* v, void* out, float* lse, const long long* strides,
                              int B, int T, int H, int causal, float scale, const float* kbias,
                              void* stream) {
  if (!fits(dtype, B, T, H)) return -1;
  if (T == 0 || B * H == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define DENSE_CALL(D, E) \
  launch_bias<D, E>(q, k, v, out, lse, strides, B, T, H, causal, scale, kbias, st)
  SM90_DISPATCH(DENSE_CALL)
#undef DENSE_CALL
}

// The banded forward: causal only, T <= 65536, band: the schedule's parameter (BandSm90).
extern "C" int flash_fwd_banded_sm90(int dtype, int head_dim, const void* q, const void* k,
                                     const void* v, void* out, float* lse,
                                     const long long* strides, int B, int T, int H, int causal,
                                     float scale, const BandSm90* band, void* stream) {
  if (!fits(dtype, B, T, H) || band == nullptr || !causal || T > kMaxBandCols * 16 ||
      band->n_gtiles < 0 || band->n_gtiles > kMaxBandTiles || band->w < 0 || band->lb <= 0)
    return -1;
  if (T == 0 || B * H == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define BANDED_CALL(D, E) \
  launch<D, false, kBanded, E>(q, k, v, out, lse, strides, B, T, H, 1, scale, nullptr, *band, st)
  SM90_DISPATCH(BANDED_CALL)
#undef BANDED_CALL
}

// The merged-row forward: m, the MergedLut's slot arrays (rows of 128 queries: cdiv(T, 128) a
// head layout) at 128 keys a slot.
extern "C" int flash_fwd_merged_sm90(int dtype, int head_dim, const void* q, const void* k,
                                     const void* v, void* out, float* lse,
                                     const long long* strides, int B, int T, int H, int causal,
                                     float scale, const MergedSched* m, void* stream) {
  if (!fits(dtype, B, T, H) || m == nullptr || m->map == nullptr || m->mask == nullptr ||
      m->len == nullptr || (m->heads != 1 && m->heads != H) || m->cell_shift < 4 ||
      m->cell_shift > 6)
    return -1;
  if (T == 0 || B * H == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define MERGED_CALL(D, E)                                                                       \
  launch<D, false, kMerged, E>(q, k, v, out, lse, strides, B, T, H, causal, scale, nullptr, *m, \
                               st)
  SM90_DISPATCH(MERGED_CALL)
#undef MERGED_CALL
}

// Helpers shared by the Hopper (sm_90a) group kernels: the block-sparse backward of
// flash_attention_sparse_bwd_sm90.cu (flash_bwd_dkdv_lut_sm90, flash_bwd_dq_lut_sm90 and the
// dense flash_bwd_dkdv_sm90 / flash_bwd_dq_sm90) and the block-sparse forward of
// flash_attention_sparse_fwd_sm90.cu (flash_fwd_lut_sm90).  Each source includes it once, so
// everything here lives in the including file's anonymous namespace but GroupSchedule, the
// C struct the entries take:
//   * the schedule of one call (GroupLut's arrays, GroupSchedule);
//   * the launch geometry: 384 threads, a producer warpgroup and two consumer warpgroups
//     (two pipes a block), 64-row tiles stored as 128-byte-swizzled 64-column boxes;
//   * PTX: mbarriers (a wait past 2 s traps), TMA loads, cp.async, wgmma (m64n64k16, both
//     operands in shared memory, or A from registers with B read through the transpose bit,
//     bf16 or fp16 operands: the element type E) and the register fences around them;
//   * the output product dQ += dS K, which is also the forward's O += P V, and the store of a
//     64-row accumulator's rows, rounded to nearest into E (an fp16 value past 65504 becomes
//     inf: no conversion here saturates);
//   * the host side: cuTensorMapEncodeTiled fetched at run time (no -lcuda), the tensor maps
//     of q / k / v / dO, lse / delta and the key bias, and the persistent launch of two pipes
//     a block (launch_pipes).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// The schedule of one call (GroupLut's arrays on the device; a ctypes Structure on the host).
// Output units are key units for dK/dV and query units for dQ; visited units the others.
struct GroupSchedule {
  const int* out_slots;    // (tiles, 4): each output tile's units, -1 for an empty slot
  const int* vbeg;         // (tiles + 1): tile t's visits are vbeg[t] .. vbeg[t + 1] - 1
  const int* visit_slots;  // (visits, 4): each visit's units, -1 for an empty slot
  const int* masked;       // (visits): 1 where the visit takes the per-element mask
  const int* order;        // (n_work, 2): the work items (b * H + h, tile), longest first
  const float* kbias;      // (B, T) fp32 key bias, or null
  int n_work, unit;        // work items; rows per slot (16, 32 or 64)
};

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
// whether an element type E (bf16 or f16) is fp16
template <typename E>
constexpr bool kHalf = std::is_same<E, f16>::value;

constexpr int kWgThreads = 128;
constexpr int kThreads = 3 * kWgThreads;  // a producer warpgroup, two consumer warpgroups
constexpr int kRows = 64;                                 // rows of an output tile and a visit
constexpr int kBox = 64;                                  // bf16 columns per swizzle row
constexpr int kBoxBytes = kRows * 128;                    // one 64-column box of a tile
constexpr int kStatSlot = 64;                             // floats per lse / delta slot (256 B)
constexpr float kNegInf = -1e30f;                         // flash_attention.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned long long kHangNs = 2000000000ull;     // an mbarrier wait past this traps

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

// Wait for the phase of parity `parity` of an mbarrier; a wait past kHangNs is a fault of the
// schedule (a barrier nobody will complete): trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try(a, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try(a, parity))
    if (globaltimer() - t0 > kHangNs) __trap();
}

__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
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

__device__ __forceinline__ void tma_load2(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
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

// d (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64): A and B K-major in shared memory, of
// element type E (TY: its PTX type, bf16 or f16)
#define WGMMA_SS_N64(TY)                                                              \
  asm volatile(                                                                       \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                    \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                 \
      : F8(0), F8(8), F8(16), F8(24)                                                  \
      : "l"(da), "l"(db), "r"(accumulate))
template <typename E = bf16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  if constexpr (kHalf<E>)
    WGMMA_SS_N64("f16");
  else
    WGMMA_SS_N64("bf16");
}
#undef WGMMA_SS_N64

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
template <typename E = bf16>
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
// 65504 becomes inf, not 65504: the overflow reaches the loss scaler)
template <typename E = bf16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf<E>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// 2^x with one MUFU instruction (denormal results flush to 0; 2^-inf = 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The output product of one dQ visit, one commit group: dQ += dS K, the visit's K tile read
// through the transpose bit (the forward's O += P V: P in the A fragments, V's tile), of
// element type E.  The caller fences the registers first.
template <int kB, typename E = bf16>
__device__ __forceinline__ void issue_dq(float (&dq)[kB][32], const uint32_t (&da)[4][4],
                                         const unsigned char* tK) {
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < kB; ++x)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64_tb<E>(dq[x], da[kk], desc_sw128(tK + x * kBoxBytes + kk * 16 * 128,
                                                   kBoxBytes, 1024));
  wgmma_commit();
}

// Row r (0 or 1: row 16 warp + g + 8 r of the tile) of a 64-row accumulator, in E (bf16 or
// fp16), to out (that row's first column): its kB x 8 column pairs 64 x + 8 n + qd
template <int kB, typename E>
__device__ __forceinline__ void store_row(E* out, const float (&acc)[kB][32], int r, int qd) {
#pragma unroll
  for (int x = 0; x < kB; ++x)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int e = 4 * n + 2 * r;
      *reinterpret_cast<uint32_t*>(out + x * kBox + 8 * n + qd) = pack2<E>(acc[x][e],
                                                                          acc[x][e + 1]);
    }
}

// ---------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled fetched at run time, so the library needs no -lcuda
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

// The tensor-map data type of an element type E (bf16 or fp16)
template <typename E>
constexpr CUtensorMapDataType kMapType =
    kHalf<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// A 4-D map (D, H, T, B) of a 16-bit (B, T, H, D) tensor of data type `type` with element
// strides s[0..2] for (b, t, h), read in boxes of 64 columns x `rows` rows of one (b, h),
// 128-byte swizzled.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, const long long* s, int B, int T,
              int H, int D, int rows, CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
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

// A 3-D map (T, H, B) of a contiguous fp32 (B, H, T) tensor (lse, delta), `rows` per box.
bool make_stat_map(EncodeTiled enc, CUtensorMap* map, const float* base, int B, int T, int H,
                   int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(T) * 4,
                                 static_cast<cuuint64_t>(T) * H * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map (T, B) of the contiguous fp32 (B, T) key bias, `rows` per box.
bool make_bias_map(EncodeTiled enc, CUtensorMap* map, const float* base, int B, int T, int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(T) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// whether a group kernel's instances were built for a call: bf16 or fp16 (dtype codes 1, 2),
// head dim 64, a slot of 16, 32 or 64 rows that tiles T
bool built_for(int dtype, int head_dim, int T, const GroupSchedule* s) {
  return (dtype == 1 || dtype == 2) && head_dim == 64 && s != nullptr &&
         (s->unit == 16 || s->unit == 32 || s->unit == 64) && T % s->unit == 0;
}

// A persistent grid of kernel: one block an SM at most, two pipes a block, one pipe for
// each work item at most
template <typename Kernel, typename... Args>
int launch_pipes(Kernel kernel, size_t smem, int n_work, cudaStream_t stream,
                 const Args&... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) per_sm = 1;
  const int half = (n_work + 1) / 2;
  const int grid = sms * per_sm < half ? sms * per_sm : half;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Flash-attention backward for Hopper (sm_90a), bf16 and fp16, head dim 64: the block-sparse
// entries flash_bwd_dkdv_lut_sm90 (dK, dV) and flash_bwd_dq_lut_sm90 (dQ), and the dense entries
// flash_bwd_dkdv_sm90 and flash_bwd_dq_sm90 (the end of this note), which share their helpers;
// the (B, T) key bias optional in all four.  Every instance is built for fp16 too (fp16
// mixed-precision training; the last paragraph of this note).
//
// Replace the Pallas TPU kernels _bwd_dkdv_kernel (617-688) and _bwd_dq_kernel (691-753) of
// deepspeed_tpu/ops/transformer/flash_attention.py with use_lut and use_kbias, built by _bwd
// (756-891) over the LUTs of _sparse_luts (84-127).  The template kernels dkdv_kernel<kLut> and
// dq_kernel<kLut> of flash_attention.cuh (flash_bwd_dkdv_lut, flash_bwd_dq_lut: 4 warps, 64 x 64
// tiles carrying a mask of their live layout cells, mma.sync, a cp.async double buffer) keep
// fp32, head dims 96 and 128 (here the largest dK/dV instance spilled, and a dQ pipe of four
// stages does not fit twice in shared memory) and the (T, T) score bias;
// ops/transformer/flash_attention.py: sparse_dkdv_kernel and sparse_dq_kernel route bf16 and
// fp16 at head dim 64 here.  They compute what the template kernels compute:
//   P = exp(S * scale + kbias - lse), 0 where the pair is not live and on a row whose lse is
//   NEG_INF (no live key); dS = P * (dO V^T - delta) * scale; fp32 accumulation.
//   dK/dV, for each key row over the query rows live for it: dV += P^T dO with P rounded to
//   bf16, dK += dS^T Q with dS rounded to bf16.  dQ, for each query row over the key rows live
//   for it: dQ += dS K with dS rounded to bf16.  Outputs bf16, contiguous (B, T, H, D); a row
//   no live partner reaches gets zeros.  delta = rowsum(dO * O) comes from the caller.
//
// What bounds them: 8·D flops per live (q, k) pair for dK/dV (the products S, dP, dV and dK),
// 6·D for dQ (S, dP and dQ).  At BERT-large's shape with the tutorial layout (B=8, T=2048, H=16,
// D=64; Fixed, block 16, local 4, global 1, bidirectional; element density 0.2734) that is 75.2
// GFLOP, 76.0 us at the H100's 989 bf16 TFLOP/s, against 203 MB of inputs and outputs, 60.6 us
// at 3.35 TB/s (dK/dV), and 56.4 GFLOP, 57.0 us, against 170 MB, 50.7 us (dQ): the operations
// bound them.  The template kernels compute every pair of each 64 x 64 tile that holds a live
// cell (at block 16 that is every tile, 3.66x the live pairs) and mask each element.  This
// design computes only live pairs, on wgmma; dK/dV and dQ are one design with the roles of the
// query and key rows swapped:
//   * the schedule (GroupLut in ops/transformer/flash_attention.py, built on the host from
//     the layout and cached; side "k" for dK/dV, "q" for dQ) groups the output blocks (key
//     blocks for dK/dV, query blocks for dQ) by the set of blocks live for them and packs each
//     group R = 64 / U blocks (U = min(block, 64) rows, a "slot") to a 64-row output tile; each
//     tile visits its group's live blocks, gathered R at a time into 64-row visits.  So every
//     pair of a visit is live except in the last visit of a group whose size is not a multiple
//     of R (an empty slot) and in causal diagonal blocks, and only those visits, flagged by the
//     schedule, take the per-element mask.  The tutorial layout's 1024 tiles per head become
//     288 visits, on 40 output tiles for dK/dV and 32 for dQ, 97% live;
//   * gathered tiles by TMA: the maps of q, k, v and dO are 4-D (D, H, T, B) over the
//     tensors' own strides (views of the fused qkv output work) with U-row boxes, 128-byte
//     swizzled.  A 16-row box is two swizzle atoms, so four boxes at 2 KB offsets give the
//     same shared-memory image as one 64-row box and the wgmma descriptors read a gathered
//     tile unchanged.  An empty slot loads rows from T on, which TMA fills with zeros (its
//     products add nothing; its stats and key bias load as 0 too and its pairs are masked);
//   * a block (one an SM, 384 threads) holds two pipes; a pipe is one consumer warpgroup fed
//     by one thread of the producer warpgroup through its own half of shared memory: it owns
//     one output tile at a time, loads its operands once (dK/dV: K, V and the key-bias slots;
//     dQ: Q, dO and the lse and delta slots; two buffers, so the next tile's arrive during
//     this one) and streams the tile's visits (dK/dV: Q, dO, lse and delta; dQ: K, V and the
//     key-bias slots) through a ring of kStages stages with full and empty mbarriers; the
//     producer also hands each tile's and each visit's schedule entries over in shared
//     memory, so the consumers read no global memory in their loop; setmaxnreg gives the
//     consumers 224 registers and the producers 56 (as two blocks an SM of one consumer
//     warpgroup each, at most 200 registers a thread, ptxas serialized the wgmmas, C7512,
//     and the dK/dV kernel took 13% longer); an mbarrier wait longer than 2 s traps;
//   * the two products of the softmax step (dK/dV: S^T = K Q^T and dP^T = V dO^T; dQ: S = Q K^T
//     and dP = dO V^T) are wgmma m64n64k16 with both operands in shared memory (K-major, as
//     TMA writes them); the softmax gradient runs on the accumulators in registers, in log2
//     units (one FMA and one exp2 for P, one FMA and one multiply for dS), into bf16
//     register-A fragments (P^T and dS^T; dS); a row of lse NEG_INF enters as +inf, so its P
//     is 0 with no select; dV += P^T dO and dK += dS^T Q (dQ += dS K) are wgmma with dO and Q
//     (K) read through the transpose bit, so no transposed copy is made, and the next visit's
//     products of the softmax step are issued right behind them;
//   * instances by slot rows U (16, 32, 64; the stats' addresses are then constants) and key
//     bias; the grid is persistent, one block an SM; the work items (an output tile of one
//     (b, h)), ordered on the host by visit count, longest first, are dealt over the pipes in
//     a snake as flash_fwd_sm90 deals its items; each output row belongs to one output tile,
//     written once by its pipe from registers: no atomics, deterministic.
// Where the dK/dV time goes (examples/sparse_dkdv_check.py's variants, H100): the softmax
// step's instructions, the loads' waits and the products add more than they overlap.  PERF.md
// holds the figures.  flash_bwd_dkdv_lut_sm90_schedule and flash_bwd_dq_lut_sm90_schedule in
// ops/transformer/flash_attention.py are the kernels' schedules in Python (the items each pipe
// takes, their slots, visits and flags).
//
// The dense entries replace the same Pallas kernels on the dense paths for bf16 at head dim 64:
// _bwd_dkdv_kernel and _bwd_dq_kernel with no LUT, built by _bwd 756-891, without a bias
// (reached through _flash_bwd_rule 906) and with use_kbias (the key bias added to S at 659-660
// and 731-732; reached through flash_attention(key_padding_bias=) 913-934, _biased_call 1221
// and _make_biased_bhtd 1178-1218).  The template kernels keep the rest: dkdv_kernel and
// dq_kernel of flash_attention.cuh (flash_bwd_dkdv, flash_bwd_dq) fp32 and head dims 96 and 128
// (at 128 two pipes do not fit in shared memory even at two stages, and dK/dV's accumulators
// alone take 128 registers a thread), and flash_bwd_dkdv_biased / flash_bwd_dq_biased also
// any (T, T) score bias; ops/transformer/flash_attention.py: dense_bwd_kernel and
// biased_bwd_kernel route.  They compute what the templates compute on the dense paths:
// P = exp(S scale + kbias - lse), 0 where the pair is masked (q_pos < T, k_pos < T and, when
// causal, q_pos >= k_pos) and on a row whose lse is NEG_INF (a mul key bias's fully padded batch
// row: no gradient, where JAX's backward computes exp(S - lse) = 1 there); dV += P^T dO with P
// rounded to bf16; dS = P (dO V^T - delta) scale; dK += dS^T Q and dQ += dS K with dS rounded
// to bf16; fp32 accumulation; outputs bf16, contiguous (B, T, H, D).  The operations bound them,
// 8·D (dK/dV) and 6·D (dQ) flops per live pair: at GPT-2 350M's shape (B=8, T=1024, H=16, D=64,
// causal) 34.4 and 25.8 GFLOP, 34.8 and 26.1 us at 989 TFLOP/s, against 101 and 85 MB, 30 and
// 25 us at 3.35 TB/s; with the key bias at BERT-large's (B=8, T=2048, H=16, D=64, not causal)
// 275 and 206 GFLOP, 277.9 and 208.5 us, against 203 and 170 MB, 61 and 51 us (the bias adds
// 64 KB).  The design is the group kernels' with a schedule the kernel computes from (B, H, T,
// causal), so no arrays are read and nothing is handed over in shared memory:
//   * a work item is one 64-row output tile of one (b, h): key rows for dK/dV, query rows for
//     dQ; a visit is one 64-row tile of the other side, each operand one 64-row TMA box (the
//     same 128-byte-swizzled image as the group kernels' gathered tiles); causal, key tile j
//     visits query tiles j .. nt - 1 and query tile i visits key tiles 0 .. i; the items are
//     ordered longest first (dK/dV: item w is key tile w / (B H); dQ: query tile
//     nt - 1 - w / (B H)) and dealt over the pipes in the snake of the group kernels;
//   * lse and delta (fp32 (B, H, T) rows of any length T, so no TMA map: its row stride would
//     have to be a multiple of 16 bytes) are copied by the 32 lanes of the pipe's producer warp
//     with cp.async, two rows a lane, zeros from T on, arriving on the same barrier as the
//     TMA loads, and so is the key bias (kBias, fp32 (B, T)): dK/dV's, constant over a work
//     item, once an item beside its K and V, each consumer thread keeping its two key rows' in
//     registers (log2 units); dQ's, 64 other key rows each visit, into the ring stage beside
//     the visit's K and V; softmax_grad and softmax_grad_dq add it in log2 units.  A padded
//     key enters as a bias of -10000 (add) or NEG_INF (mul), so its P underflows to 0 and only
//     the visits flagged below take an element mask; rows of q, k, v and dO past T load as
//     zeros; the visits that hold rows past T
//     (the last, when T is not a multiple of 64) and the causal diagonal ones alone take the
//     per-element mask, q_pos < T and k_pos < T included; rows of an output tile past T are
//     computed and not stored;
//   * the pipes, the ring, setmaxnreg, the softmax step (issue_sdp, softmax_grad,
//     softmax_grad_dq) and the output products (issue_dvdk, issue_dq) are the group kernels'.
// flash_bwd_dkdv_sm90_schedule and flash_bwd_dq_sm90_schedule in ops/transformer/
// flash_attention.py are their schedules in Python.
//
// fp16 (dtype code 2): every instance, group and dense, with and without the key bias
// (dkdv_sm90_kernel<64, U, kBias, f16>, dq_sm90_kernel<64, U, kBias, f16>,
// dense_dkdv_kernel<64, kBias, f16>, dense_dq_kernel<64, kBias, f16>), is the bf16 one with the
// element type a template parameter: wgmma .f32.f16.f16 in place of .f32.bf16.bf16, P and dS
// rounded to fp16 (__floats2half2_rn) where the bf16 instances round to bf16, fp16 stores, and
// the tensor maps of data type FLOAT16.  The scores, the key bias (NEG_INF for a padded key
// under "mul"), lse and delta stay fp32, so a fully padded row still gets P = 0 and zero
// gradients.  fp16's range ends at 65504: a P^T dO, dS^T Q or dS K past it (or a dS rounded
// past it) becomes inf, no conversion saturates, so an overflow reaches the outputs and the
// loss scaler skips the step, as the reference's fp16 kernels do.  Head dim 128 stays unbuilt
// in either type.
//
// The PTX, TMA, mbarrier, wgmma, tensor-map and launch helpers, the GroupSchedule struct and
// the output product issue_dq are in flash_attention_sm90.cuh, shared with the forward of
// flash_attention_sparse_fwd_sm90.cu.
//
// C interface for ctypes: the argument lists of flash_bwd_dkdv and flash_bwd_dq
// (flash_attention.cu), the group entries with the schedule after them, the dense ones with
// the key bias (or null) after them; returns
// cudaGetLastError() after the launch (0 on success), -1 for a dtype / head dim / slot size /
// shape it was not built for, -2 when a tensor map cannot be encoded and -3 when
// cuTensorMapEncodeTiled cannot be found.

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kProducerRegs = 56, kConsumerRegs = 224;   // setmaxnreg: 128 x 56 + 256 x 224
constexpr int kStages = 4;                                // visits in the ring
constexpr int kStatBytes = 4 * kStatSlot * 4;             // one stage's lse (or delta)

template <int D>
struct Cfg {
  static constexpr int kBoxes = D / kBox;
  static constexpr int kTileBytes = kRows * D * 2;        // a 64-row tile of K, V, Q or dO
  // one pipe's shared memory, a multiple of 1024 so the second pipe's tiles stay aligned
  static constexpr size_t kPipe = (4 * static_cast<size_t>(kTileBytes) +
                                   kStages * (2 * static_cast<size_t>(kTileBytes) +
                                              2 * kStatBytes) +
                                   2 * kStatBytes + 4 * 8 * (2 + kStages) +
                                   8 * (4 + 2 * kStages) + 1023) / 1024 * 1024;
  static constexpr size_t kSmem = 1024 + 2 * kPipe;
  // a dQ pipe: Q, dO and the lse and delta slots in two buffers, K, V and the key-bias slots
  // in the ring
  static constexpr size_t kPipeDq = (4 * static_cast<size_t>(kTileBytes) +
                                     kStages * (2 * static_cast<size_t>(kTileBytes) +
                                                kStatBytes) +
                                     4 * kStatBytes + 4 * 8 * (2 + kStages) +
                                     8 * (4 + 2 * kStages) + 1023) / 1024 * 1024;
  static constexpr size_t kSmemDq = 1024 + 2 * kPipeDq;
};

// The two products of one visit's softmax step, every operand in shared memory (K-major, as
// TMA writes them): s = tS vS^T and dp = tP vP^T, with tS, tP the output tile's operands and
// vS, vP the visit's (dK/dV: S^T = K Q^T, dP^T = V dO^T; dQ: S = Q K^T, dP = dO V^T); one
// commit group.  It may be issued while the last visit's output products are in flight, so
// it touches s and dp with nothing but the wgmmas: a register fence there counts as a
// definition inside their pipeline stage, and ptxas then serializes every wgmma of the kernel
// (C7515).  E: the operands' element type.
template <int D, typename E = bf16>
__device__ __forceinline__ void issue_sdp(float (&s)[32], float (&dp)[32], const unsigned char* tS,
                                          const unsigned char* tP, const unsigned char* vS,
                                          const unsigned char* vP) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n64<E>(s, desc_sw128(tS + off, 16, 1024), desc_sw128(vS + off, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n64<E>(dp, desc_sw128(tP + off, 16, 1024), desc_sw128(vP + off, 16, 1024),
                    kk > 0);
  }
  wgmma_commit();
}

// P = 2^(S scale log2e + kbias log2e - lse log2e) and dS = P (dP scale - delta scale) of one
// visit, from its S^T and dP^T accumulators, its lse and delta slots (sl, sd) and its entries
// (vm: the mask flag and the query units); a row of lse NEG_INF takes +inf, so its P is 0.
// Only a flagged visit (kMasked) masks: an empty query slot, a query row from qend on (T: the
// group kernels' filled slots never reach it, the dense kernel's last tile may), and when
// causal a query before the key.  P^T and dS^T go straight to E A fragments (bf16, fp16): columns
// 8 n + qd + e of row r are word 2 (n & 1) + r of fragment n / 2 (a 16-column slice of the
// accumulator is one fragment).  s and dp are only read: no instruction but a wgmma defines an
// accumulator while one is in flight, else ptxas serializes the kernel's wgmmas (C7515).
template <int U, bool kMasked, bool kBias, typename E = bf16>
__device__ __forceinline__ void softmax_grad(const float (&s)[32], const float (&dp)[32],
                                             uint32_t (&pa)[4][4], uint32_t (&da)[4][4],
                                             const float* sl, const float* sd, const int* vm,
                                             const float (&kb2)[2], const int (&kpos)[2], int qd,
                                             int causal, float scale, float scale2, int qend) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float l2[2], ds[2];
    int qpos[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // column 8 n + qd + e (qd + e < 8): its slot and its row there are constants plus qd + e
      const int slot = (8 * n) / U, row = (8 * n) % U + qd + e;
      const int at = slot * kStatSlot + row;
      const float lse = sl[at];
      l2[e] = lse > kNegInf * 0.5f ? lse * kLog2e : INFINITY;
      ds[e] = sd[at] * scale;
      if (kMasked) {
        const int u = vm[1 + slot];
        qpos[e] = u < 0 || u * U + row >= qend ? -1 : u * U + row;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float pv[2], dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * n + 2 * r + e;
        pv[e] = exp2_ftz(fmaf(s[idx], scale2, kBias ? kb2[r] - l2[e] : -l2[e]));
        if (kMasked && !(qpos[e] >= 0 && (!causal || qpos[e] >= kpos[r]))) pv[e] = 0.f;
        dsv[e] = pv[e] * fmaf(dp[idx], scale, -ds[e]);
      }
      pa[n >> 1][2 * (n & 1) + r] = pack2<E>(pv[0], pv[1]);
      da[n >> 1][2 * (n & 1) + r] = pack2<E>(dsv[0], dsv[1]);
    }
  }
}

// dS = P (dP scale - delta scale) of one dQ visit, P = 2^(S scale log2e + kbias log2e - lse
// log2e), from its S and dP accumulators, the thread's two query rows (qpos, -1 in an empty
// slot; l2 = lse log2e, +inf where lse is NEG_INF, so that row's P is 0; dd = delta scale),
// the visit's key-bias slots (kb) and its entries (vm: the mask flag and the key units).  Only
// a flagged visit (kMasked) masks: an empty key slot, a key row from kend on (as qend in
// softmax_grad), and when causal a key after the query.  dS goes straight to E A
// fragments, as in softmax_grad; s and dp are only read.
template <int U, bool kMasked, bool kBias, typename E = bf16>
__device__ __forceinline__ void softmax_grad_dq(const float (&s)[32], const float (&dp)[32],
                                                uint32_t (&da)[4][4], const float* kb,
                                                const int* vm, const float (&l2)[2],
                                                const float (&dd)[2], const int (&qpos)[2],
                                                int qd, int causal, float scale, float scale2,
                                                int kend) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    // columns 8 n + qd + e (qd + e < 8) are rows row + e of the key slot `slot`; slot and
    // row - qd are constants
    const int slot = (8 * n) / U, row = (8 * n) % U + qd;
    float kb2[2] = {0.f, 0.f};
    if (kBias) {
      const float2 b = *reinterpret_cast<const float2*>(kb + slot * kStatSlot + row);
      kb2[0] = b.x * kLog2e;
      kb2[1] = b.y * kLog2e;
    }
    int kpos = -1;  // the key row of column 8 n + qd; -1 in an empty slot
    if (kMasked) {
      const int u = vm[1 + slot];
      kpos = u < 0 ? -1 : u * U + row;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * n + 2 * r + e;
        float pv = exp2_ftz(fmaf(s[idx], scale2, kBias ? kb2[e] - l2[r] : -l2[r]));
        if (kMasked && !(kpos >= 0 && kpos + e < kend && (!causal || qpos[r] >= kpos + e)))
          pv = 0.f;
        dsv[e] = pv * fmaf(dp[idx], scale, -dd[r]);
      }
      da[n >> 1][2 * (n & 1) + r] = pack2<E>(dsv[0], dsv[1]);
    }
  }
}

// The output products of one dK/dV visit, one commit group: dV += P^T dO and dK += dS^T Q
// from the A fragments of softmax_grad, the visit's dO and Q tiles read through the transpose
// bit (no transposed copy is made), of element type E.  The caller fences the registers first.
template <int kB, typename E = bf16>
__device__ __forceinline__ void issue_dvdk(float (&dv)[kB][32], float (&dk)[kB][32],
                                           const uint32_t (&pa)[4][4], const uint32_t (&da)[4][4],
                                           const unsigned char* tdO, const unsigned char* tQ) {
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < kB; ++x)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64_tb<E>(dv[x], pa[kk], desc_sw128(tdO + x * kBoxBytes + kk * 16 * 128,
                                                   kBoxBytes, 1024));
#pragma unroll
  for (int x = 0; x < kB; ++x)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64_tb<E>(dk[x], da[kk], desc_sw128(tQ + x * kBoxBytes + kk * 16 * 128,
                                                   kBoxBytes, 1024));
  wgmma_commit();
}

struct Params {
  GroupSchedule s;
  void* dk;                     // (B, T, H, D) of the element type E
  void* dv;
  int T, H, causal;
  float scale, scale2;          // scale; scale * log2 e
};

struct DqParams {
  GroupSchedule s;
  void* dq;
  int T, H, causal;
  float scale, scale2;          // scale; scale * log2 e
};

// ---------------------------------------------------------------- the kernel
// Accumulator layout of the warpgroup's 64 x 64 products (wgmma, fp32): warp w holds rows
// 16 w + g and 16 w + g + 8 (g = lane / 4); element 4 n + 2 r + e is row 16 w + g + 8 r,
// column 8 n + 2 (lane % 4) + e.  Rows are key rows of the output tile, columns query rows
// of the visit (in S^T and dP^T) or head-dim columns (in dK and dV).
//
// The producer hands each work item's and each visit's schedule entries to the consumers
// through shared memory, written before its arrival on the item's (visit's) full barrier,
// so the consumers read no global memory in their loop; it reads a visit's entries one
// visit ahead.  The consumers issue the next visit's S^T and dP^T right behind this
// visit's dV and dK, so the tensor cores run the two groups back to back.  E: the element type
// of q, k, v, dO, dK and dV (bf16, fp16).
template <int D, int U, bool kBias, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tlse,
                     const __grid_constant__ CUtensorMap tdelta,
                     const __grid_constant__ CUtensorMap tkb, Params p) {
  using C = Cfg<D>;
  constexpr int kB = C::kBoxes, kS = kStages, kTile = C::kTileBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // two pipes a block, each a consumer warpgroup fed by one producer thread (warp 0 or 1 of
  // the producer warpgroup, lane 0) through its own half of shared memory and barriers;
  // 128-byte swizzled tiles must start on 1024 bytes
  const int wg = threadIdx.x / kWgThreads;
  const int pipe = wg == 0 ? (threadIdx.x >> 5) & 1 : wg - 1;
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023) + pipe * C::kPipe;
  unsigned char* sK = smem;                      // [buffer][box][64 rows][128 bytes]
  unsigned char* sV = sK + 2 * kTile;            // the same
  unsigned char* sQ = sV + 2 * kTile;            // [stage][box][64 rows][128 bytes]
  unsigned char* sdO = sQ + kS * kTile;          // the same
  float* sLse = reinterpret_cast<float*>(sdO + kS * kTile);  // [stage][slot][kStatSlot]
  float* sDelta = sLse + kS * 4 * kStatSlot;                 // the same
  float* sKb = sDelta + kS * 4 * kStatSlot;                  // [buffer][slot][kStatSlot]
  int* sItem = reinterpret_cast<int*>(sKb + 2 * 4 * kStatSlot);  // [buffer][8]
  int* sVisit = sItem + 2 * 8;                                   // [stage][8]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sVisit + kS * 8);
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* full = kv_empty + 2;
  uint64_t* empty = full + kS;

  constexpr int R = kRows / U;  // slots per tile
  const int T = p.T, H = p.H;
  const GroupSchedule sc = p.s;
  // in round r pipe x = 2 blockIdx.x + pipe takes item r G + x, or r G + G - 1 - x when r is
  // odd (G = 2 gridDim.x): a snake over the longest-first items, as flash_fwd_sm90 deals them
  auto work = [&](int r) {
    const int G = 2 * gridDim.x, x = 2 * blockIdx.x + pipe;
    return r * G + ((r & 1) ? G - 1 - x : x);
  };

  if (threadIdx.x == 0 || threadIdx.x == 32) {  // each pipe's producer thread, its barriers
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&kv_full[b], 1);
      mbar_init(&kv_empty[b], 4);  // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 0 && threadIdx.x != 32) return;
    int vt = 0;  // visits issued to this pipe
    for (int i = 0, w = work(0); w < sc.n_work; w = work(++i)) {
      const int2 item = reinterpret_cast<const int2*>(sc.order)[w];  // (b * H + h, tile)
      const int b = item.x / H, h = item.x % H;
      const int v0 = sc.vbeg[item.y], v1 = sc.vbeg[item.y + 1];
      const int4 out = reinterpret_cast<const int4*>(sc.out_slots)[item.y];
      int4 next = v0 < v1 ? reinterpret_cast<const int4*>(sc.visit_slots)[v0] : out;
      int next_masked = v0 < v1 ? sc.masked[v0] : 0;
      // the item's K / V buffer: its entries, then (if it has visits) its loads
      const int kb = i & 1, kph = (i >> 1) & 1;
      mbar_wait(&kv_empty[kb], kph ^ 1);
      int* meta = sItem + kb * 8;
      meta[0] = b;
      meta[1] = h;
      meta[2] = v1 - v0;
      meta[3] = out.x;
      meta[4] = out.y;
      meta[5] = out.z;
      meta[6] = out.w;
      if (v0 == v1) {  // no visit: the consumers write zeros
        mbar_arrive(&kv_full[kb]);
        continue;
      }
      mbar_expect_tx(&kv_full[kb], 2 * kTile + (kBias ? kRows * 4 : 0));
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s >= R) break;
        const int u = (&out.x)[s];
        const int r0 = u < 0 ? T : u * U;  // an empty slot: rows past T, zeros
#pragma unroll
        for (int x = 0; x < kB; ++x) {
          const int off = kb * kTile + x * kBoxBytes + s * U * 128;
          tma_load4(sK + off, &tk, &kv_full[kb], x * kBox, h, r0, b);
          tma_load4(sV + off, &tv, &kv_full[kb], x * kBox, h, r0, b);
        }
        if (kBias) tma_load2(sKb + (kb * 4 + s) * kStatSlot, &tkb, &kv_full[kb], r0, b);
      }
      for (int v = v0; v < v1; ++v, ++vt) {
        const int4 slots = next;
        const int masked = next_masked;
        if (v + 1 < v1) {  // the next visit's entries, read while this one is issued
          next = reinterpret_cast<const int4*>(sc.visit_slots)[v + 1];
          next_masked = sc.masked[v + 1];
        }
        const int st = vt % kS, ph = (vt / kS) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        int* vm = sVisit + st * 8;
        vm[0] = masked;
        vm[1] = slots.x;
        vm[2] = slots.y;
        vm[3] = slots.z;
        vm[4] = slots.w;
        mbar_expect_tx(&full[st], 2 * kTile + 2 * kRows * 4);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s >= R) break;
          const int u = (&slots.x)[s];
          const int r0 = u < 0 ? T : u * U;
#pragma unroll
          for (int x = 0; x < kB; ++x) {
            const int off = st * kTile + x * kBoxBytes + s * U * 128;
            tma_load4(sQ + off, &tq, &full[st], x * kBox, h, r0, b);
            tma_load4(sdO + off, &tdo, &full[st], x * kBox, h, r0, b);
          }
          tma_load3(sLse + (st * 4 + s) * kStatSlot, &tlse, &full[st], r0, h, b);
          tma_load3(sDelta + (st * 4 + s) * kStatSlot, &tdelta, &full[st], r0, h, b);
        }
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tid = static_cast<int>(threadIdx.x) - wg * kWgThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = (lane & 3) * 2;
  const float scale = p.scale, scale2 = p.scale2;
  int vt = 0;  // visits consumed by this pipe
  for (int i = 0, w = work(0); w < sc.n_work; w = work(++i)) {
    const int kb = i & 1, kph = (i >> 1) & 1;
    mbar_wait(&kv_full[kb], kph);
    const int* meta = sItem + kb * 8;
    const int b = meta[0], h = meta[1], nv = meta[2];
    // this thread's two key rows: row 16 warp + g + 8 r of the tile, in slot row / U
    int kpos[2];
    float kb2[2] = {0.f, 0.f};  // their key bias, log2 units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = 16 * warp + g + 8 * r, slot = rl / U;
      const int u = meta[3 + slot];
      kpos[r] = u < 0 ? -1 : u * U + (rl & (U - 1));
      if (kBias) kb2[r] = sKb[(kb * 4 + slot) * kStatSlot + (rl & (U - 1))] * kLog2e;
    }
    float dk[kB][32], dv[kB][32];
#pragma unroll
    for (int x = 0; x < kB; ++x) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[x][e] = dv[x][e] = 0.f;
      fence_regs(dk[x]);  // zeroed here, before the first wgmma is issued
      fence_regs(dv[x]);
    }

    if (nv > 0) {
      const unsigned char* tK = sK + kb * kTile;
      const unsigned char* tV = sV + kb * kTile;
      float s[32], dp[32];
      uint32_t pa[4][4], da[4][4];
      int st = vt % kS;
      mbar_wait(&full[st], (vt / kS) & 1);
      issue_sdp<D, E>(s, dp, tK, tV, sQ + st * kTile, sdO + st * kTile);
      for (int j = 0; j < nv; ++j, ++vt) {
        // S^T and dP^T of this visit are done, and the last visit's dV and dK
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
#pragma unroll
        for (int x = 0; x < kB; ++x) {
          fence_regs(dv[x]);
          fence_regs(dk[x]);
        }
        fence_regs(pa);
        fence_regs(da);
        if (j > 0 && lane == 0) mbar_arrive(&empty[(vt - 1) % kS]);
        const float* sl = sLse + st * 4 * kStatSlot;
        const float* sd = sDelta + st * 4 * kStatSlot;
        const int* vm = sVisit + st * 8;

        if (vm[0] != 0)
          softmax_grad<U, true, kBias, E>(s, dp, pa, da, sl, sd, vm, kb2, kpos, qd, p.causal,
                                          scale, scale2, T);
        else
          softmax_grad<U, false, kBias, E>(s, dp, pa, da, sl, sd, vm, kb2, kpos, qd, p.causal,
                                           scale, scale2, T);

        // dV += P^T dO and dK += dS^T Q
#pragma unroll
        for (int x = 0; x < kB; ++x) {
          fence_regs(dv[x]);
          fence_regs(dk[x]);
        }
        fence_regs(pa);
        fence_regs(da);
        issue_dvdk<kB, E>(dv, dk, pa, da, sdO + st * kTile, sQ + st * kTile);
        // the next visit's S^T and dP^T right behind them; after the last visit, this
        // visit's again (its stage is still held; the results go unused): an issue that
        // every iteration makes keeps ptxas from serializing the wgmmas (C7515)
        if (j + 1 < nv) {
          st = (vt + 1) % kS;
          mbar_wait(&full[st], ((vt + 1) / kS) & 1);
        }
        issue_sdp<D, E>(s, dp, tK, tV, sQ + st * kTile, sdO + st * kTile);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < kB; ++x) {
        fence_regs(dv[x]);
        fence_regs(dk[x]);
      }
      fence_regs(pa);
      fence_regs(da);
      if (lane == 0) mbar_arrive(&empty[(vt - 1) % kS]);
    }
    if (lane == 0) mbar_arrive(&kv_empty[kb]);  // this item's entries and K / V are read

    // ---------------------------------------------------------- epilogue
    // each of the thread's rows in a live slot
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kpos[r] < 0) continue;
      const long long row = (static_cast<long long>(b) * T + kpos[r]) * H + h;
      store_row<kB>(static_cast<E*>(p.dk) + row * D, dk, r, qd);
      store_row<kB>(static_cast<E*>(p.dv) + row * D, dv, r, qd);
    }
  }
}

// The dQ kernel: dkdv_sm90_kernel with the roles of the rows swapped.  Rows of the
// accumulators are query rows of the output tile; columns are key rows of the visit (in S and
// dP) or head-dim columns (in dQ).  A pipe loads each work item's Q, dO, lse and delta slots
// once (two buffers) and streams each visit's K, V and key-bias slots through the ring; the
// producer hands the entries over in shared memory as in dkdv_sm90_kernel, and the consumers
// issue the next visit's S and dP right behind this visit's dQ.  E: the element type (bf16,
// fp16).
template <int D, int U, bool kBias, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    dq_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tlse,
                   const __grid_constant__ CUtensorMap tdelta,
                   const __grid_constant__ CUtensorMap tkb, DqParams p) {
  using C = Cfg<D>;
  constexpr int kB = C::kBoxes, kS = kStages, kTile = C::kTileBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int wg = threadIdx.x / kWgThreads;
  const int pipe = wg == 0 ? (threadIdx.x >> 5) & 1 : wg - 1;
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023) + pipe * C::kPipeDq;
  unsigned char* sQ = smem;                      // [buffer][box][64 rows][128 bytes]
  unsigned char* sdO = sQ + 2 * kTile;           // the same
  unsigned char* sK = sdO + 2 * kTile;           // [stage][box][64 rows][128 bytes]
  unsigned char* sV = sK + kS * kTile;           // the same
  float* sLse = reinterpret_cast<float*>(sV + kS * kTile);  // [buffer][slot][kStatSlot]
  float* sDelta = sLse + 2 * 4 * kStatSlot;                 // the same
  float* sKb = sDelta + 2 * 4 * kStatSlot;                  // [stage][slot][kStatSlot]
  int* sItem = reinterpret_cast<int*>(sKb + kS * 4 * kStatSlot);  // [buffer][8]
  int* sVisit = sItem + 2 * 8;                                    // [stage][8]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sVisit + kS * 8);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kS;

  constexpr int R = kRows / U;  // slots per tile
  const int T = p.T, H = p.H;
  const GroupSchedule sc = p.s;
  auto work = [&](int r) {  // the snake of dkdv_sm90_kernel
    const int G = 2 * gridDim.x, x = 2 * blockIdx.x + pipe;
    return r * G + ((r & 1) ? G - 1 - x : x);
  };

  if (threadIdx.x == 0 || threadIdx.x == 32) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 4);  // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 0 && threadIdx.x != 32) return;
    int vt = 0;  // visits issued to this pipe
    for (int i = 0, w = work(0); w < sc.n_work; w = work(++i)) {
      const int2 item = reinterpret_cast<const int2*>(sc.order)[w];  // (b * H + h, tile)
      const int b = item.x / H, h = item.x % H;
      const int v0 = sc.vbeg[item.y], v1 = sc.vbeg[item.y + 1];
      const int4 out = reinterpret_cast<const int4*>(sc.out_slots)[item.y];
      int4 next = v0 < v1 ? reinterpret_cast<const int4*>(sc.visit_slots)[v0] : out;
      int next_masked = v0 < v1 ? sc.masked[v0] : 0;
      // the item's Q / dO buffer: its entries, then (if it has visits) its loads
      const int qb = i & 1, qph = (i >> 1) & 1;
      mbar_wait(&q_empty[qb], qph ^ 1);
      int* meta = sItem + qb * 8;
      meta[0] = b;
      meta[1] = h;
      meta[2] = v1 - v0;
      meta[3] = out.x;
      meta[4] = out.y;
      meta[5] = out.z;
      meta[6] = out.w;
      if (v0 == v1) {  // no visit: the consumers write zeros
        mbar_arrive(&q_full[qb]);
        continue;
      }
      mbar_expect_tx(&q_full[qb], 2 * kTile + 2 * kRows * 4);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s >= R) break;
        const int u = (&out.x)[s];
        const int r0 = u < 0 ? T : u * U;  // an empty slot: rows past T, zeros
#pragma unroll
        for (int x = 0; x < kB; ++x) {
          const int off = qb * kTile + x * kBoxBytes + s * U * 128;
          tma_load4(sQ + off, &tq, &q_full[qb], x * kBox, h, r0, b);
          tma_load4(sdO + off, &tdo, &q_full[qb], x * kBox, h, r0, b);
        }
        tma_load3(sLse + (qb * 4 + s) * kStatSlot, &tlse, &q_full[qb], r0, h, b);
        tma_load3(sDelta + (qb * 4 + s) * kStatSlot, &tdelta, &q_full[qb], r0, h, b);
      }
      for (int v = v0; v < v1; ++v, ++vt) {
        const int4 slots = next;
        const int masked = next_masked;
        if (v + 1 < v1) {  // the next visit's entries, read while this one is issued
          next = reinterpret_cast<const int4*>(sc.visit_slots)[v + 1];
          next_masked = sc.masked[v + 1];
        }
        const int st = vt % kS, ph = (vt / kS) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        int* vm = sVisit + st * 8;
        vm[0] = masked;
        vm[1] = slots.x;
        vm[2] = slots.y;
        vm[3] = slots.z;
        vm[4] = slots.w;
        mbar_expect_tx(&full[st], 2 * kTile + (kBias ? kRows * 4 : 0));
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s >= R) break;
          const int u = (&slots.x)[s];
          const int r0 = u < 0 ? T : u * U;
#pragma unroll
          for (int x = 0; x < kB; ++x) {
            const int off = st * kTile + x * kBoxBytes + s * U * 128;
            tma_load4(sK + off, &tk, &full[st], x * kBox, h, r0, b);
            tma_load4(sV + off, &tv, &full[st], x * kBox, h, r0, b);
          }
          if (kBias) tma_load2(sKb + (st * 4 + s) * kStatSlot, &tkb, &full[st], r0, b);
        }
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tid = static_cast<int>(threadIdx.x) - wg * kWgThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = (lane & 3) * 2;
  const float scale = p.scale, scale2 = p.scale2;
  int vt = 0;  // visits consumed by this pipe
  for (int i = 0, w = work(0); w < sc.n_work; w = work(++i)) {
    const int qb = i & 1, qph = (i >> 1) & 1;
    mbar_wait(&q_full[qb], qph);
    const int* meta = sItem + qb * 8;
    const int b = meta[0], h = meta[1], nv = meta[2];
    // this thread's two query rows: row 16 warp + g + 8 r of the tile, in slot row / U
    int qpos[2], at[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = 16 * warp + g + 8 * r, slot = rl / U;
      const int u = meta[3 + slot];
      qpos[r] = u < 0 ? -1 : u * U + (rl & (U - 1));
      at[r] = (qb * 4 + slot) * kStatSlot + (rl & (U - 1));
    }
    float dq[kB][32];
#pragma unroll
    for (int x = 0; x < kB; ++x) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[x][e] = 0.f;
      fence_regs(dq[x]);  // zeroed here, before the first wgmma is issued
    }

    if (nv > 0) {
      float l2[2], dd[2];  // the rows' lse log2 e (+inf where lse is NEG_INF), delta scale
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lse = sLse[at[r]];
        l2[r] = lse > kNegInf * 0.5f ? lse * kLog2e : INFINITY;
        dd[r] = sDelta[at[r]] * scale;
      }
      const unsigned char* tQ = sQ + qb * kTile;
      const unsigned char* tdO = sdO + qb * kTile;
      float s[32], dp[32];
      uint32_t da[4][4];
      int st = vt % kS;
      mbar_wait(&full[st], (vt / kS) & 1);
      issue_sdp<D, E>(s, dp, tQ, tdO, sK + st * kTile, sV + st * kTile);
      for (int j = 0; j < nv; ++j, ++vt) {
        // S and dP of this visit are done, and the last visit's dQ
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
#pragma unroll
        for (int x = 0; x < kB; ++x) fence_regs(dq[x]);
        fence_regs(da);
        if (j > 0 && lane == 0) mbar_arrive(&empty[(vt - 1) % kS]);
        const float* kb = sKb + st * 4 * kStatSlot;
        const int* vm = sVisit + st * 8;

        if (vm[0] != 0)
          softmax_grad_dq<U, true, kBias, E>(s, dp, da, kb, vm, l2, dd, qpos, qd, p.causal,
                                             scale, scale2, T);
        else
          softmax_grad_dq<U, false, kBias, E>(s, dp, da, kb, vm, l2, dd, qpos, qd, p.causal,
                                              scale, scale2, T);

        // dQ += dS K
#pragma unroll
        for (int x = 0; x < kB; ++x) fence_regs(dq[x]);
        fence_regs(da);
        issue_dq<kB, E>(dq, da, sK + st * kTile);
        // the next visit's S and dP right behind it; after the last visit, this visit's again
        // (as in dkdv_sm90_kernel: an issue every iteration makes keeps the wgmmas unserialized)
        if (j + 1 < nv) {
          st = (vt + 1) % kS;
          mbar_wait(&full[st], ((vt + 1) / kS) & 1);
        }
        issue_sdp<D, E>(s, dp, tQ, tdO, sK + st * kTile, sV + st * kTile);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < kB; ++x) fence_regs(dq[x]);
      fence_regs(da);
      if (lane == 0) mbar_arrive(&empty[(vt - 1) % kS]);
    }
    if (lane == 0) mbar_arrive(&q_empty[qb]);  // this item's entries, Q, dO and stats are read

    // ---------------------------------------------------------- epilogue
    // each of the thread's rows in a live slot
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qpos[r] >= 0)
        store_row<kB>(
            static_cast<E*>(p.dq) + ((static_cast<long long>(b) * T + qpos[r]) * H + h) * D, dq,
            r, qd);
  }
}

// ---------------------------------------------------------------- the dense kernels
struct DenseParams {
  const float* lse;             // (B, H, T) fp32, contiguous
  const float* delta;           // the same
  const float* kbias;           // (B, T) fp32, contiguous: the key bias (kBias instances)
  void* out0;                   // dK (dense_dkdv_kernel) or dQ (dense_dq_kernel), of type E
  void* out1;                   // dV, or null
  int T, H, BH, nt, causal;     // nt = ceil(T / 64): tiles a side
  float scale, scale2;          // scale; scale * log2 e
};

// lse and delta of query rows r0 .. r0 + 63 of one (b, h) (at: its first element) into 64-float
// slots, two rows a lane of the producer warp by cp.async, zeros from T on; the copies arrive on
// bar when they have landed (its count holds these 32 arrivals)
__device__ __forceinline__ void load_stats(float* sl, float* sd, const DenseParams& p,
                                           long long at, int r0, int lane, uint64_t* bar) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = 32 * x + lane;
    const bool in = r0 + r < p.T;
    const long long src = in ? at + r0 + r : 0;
    cp_async4(sl + r, p.lse + src, in);
    cp_async4(sd + r, p.delta + src, in);
  }
  cp_async_arrive(bar);
}

// The key bias of key rows r0 .. r0 + 63 of batch row b into a 64-float slot, as load_stats
// copies lse and delta: two rows a lane of the producer warp by cp.async (a (B, T) fp32 row
// of any T has no 16-byte aligned stride, so no TMA map), zeros from T on, the copies arriving
// on bar
__device__ __forceinline__ void load_kbias(float* sb, const DenseParams& p, int b, int r0,
                                           int lane, uint64_t* bar) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = 32 * x + lane;
    const bool in = r0 + r < p.T;
    cp_async4(sb + r, p.kbias + (in ? static_cast<long long>(b) * p.T + r0 + r : 0), in);
  }
  cp_async_arrive(bar);
}

template <int D>
struct DenseCfg {
  static constexpr int kTileBytes = kRows * D * 2;        // a 64-row tile of K, V, Q or dO
  // one pipe: the item's two tiles in two buffers, the visits' two tiles in the ring, the
  // lse and delta of 64 rows in both (dK/dV: the ring; dQ: the buffers), the key bias of 64
  // rows in kStages slots (dK/dV: two, the item's buffers; dQ: the ring), the barriers; a
  // multiple of 1024 so the second pipe's tiles stay aligned
  static constexpr size_t kPipe = (4 * static_cast<size_t>(kTileBytes) +
                                   kStages * (2 * static_cast<size_t>(kTileBytes) +
                                              3 * kRows * 4) +
                                   4 * kRows * 4 + 8 * (4 + 2 * kStages) + 1023) / 1024 * 1024;
  static constexpr size_t kSmem = 1024 + 2 * kPipe;
};

// The dense dK/dV kernel.  Work item w (of nt * B * H) is key tile w / BH of (b, h) = w % BH,
// so the causal items come longest first; a pipe takes its items in the snake of
// dkdv_sm90_kernel, loads each item's K and V once (two buffers) and streams its visits' Q,
// dO, lse and delta (query tiles j .. nt - 1 when causal, else 0 .. nt - 1) through the ring.
// Producer and consumers derive the same schedule from (B, H, T, causal): nothing is read or
// handed over.  The accumulator layout and the loop are dkdv_sm90_kernel's.  kBias: the
// item's key bias (its 64 key rows, constant over its visits) comes once with its K and V,
// copied by the producer lanes, and each consumer thread keeps its two rows' in registers.
// E: the element type of q, k, v, dO, dK and dV (bf16, fp16).
template <int D, bool kBias, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    dense_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, DenseParams p) {
  using C = DenseCfg<D>;
  constexpr int kB = D / kBox, kS = kStages, kTile = C::kTileBytes;
  constexpr int kVisitTx = 2 * kTile;  // a visit's TMA bytes: Q, dO
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int wg = threadIdx.x / kWgThreads;
  const int pipe = wg == 0 ? (threadIdx.x >> 5) & 1 : wg - 1;
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023) + pipe * C::kPipe;
  unsigned char* sK = smem;                      // [buffer][box][64 rows][128 bytes]
  unsigned char* sV = sK + 2 * kTile;            // the same
  unsigned char* sQ = sV + 2 * kTile;            // [stage][box][64 rows][128 bytes]
  unsigned char* sdO = sQ + kS * kTile;          // the same
  float* sLse = reinterpret_cast<float*>(sdO + kS * kTile);  // [stage][64]
  float* sDelta = sLse + kS * kRows;                         // the same
  float* sKb = sDelta + kS * kRows;                          // [buffer][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sKb + kS * kRows);
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* full = kv_empty + 2;
  uint64_t* empty = full + kS;

  const int T = p.T, H = p.H, BH = p.BH, nt = p.nt, n_work = nt * BH;
  const int ragged = T % kRows != 0;
  auto work = [&](int r) {  // the snake of dkdv_sm90_kernel
    const int G = 2 * gridDim.x, x = 2 * blockIdx.x + pipe;
    return r * G + ((r & 1) ? G - 1 - x : x);
  };

  if (threadIdx.x == 0 || threadIdx.x == 32) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&kv_full[b], kBias ? 1 + 32 : 1);  // the TMA issue (and the key bias lanes)
      mbar_init(&kv_empty[b], 4);  // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA issue and the producer lanes' lse and delta
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    // warp x of the producer warpgroup feeds pipe x: lane 0 issues the TMA loads, every lane
    // copies two rows of each visit's lse and delta (kBias: and of each item's key bias)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 64) return;
    const int lane = threadIdx.x & 31;
    int vt = 0;  // visits issued to this pipe
    for (int i = 0, w = work(0); w < n_work; w = work(++i)) {
      const int kt = w / BH, bh = w - kt * BH, b = bh / H, h = bh - b * H;
      const int kb = i & 1, kph = (i >> 1) & 1;
      if (kBias || lane == 0) mbar_wait(&kv_empty[kb], kph ^ 1);
      if (kBias) load_kbias(sKb + kb * kRows, p, b, kt * kRows, lane, &kv_full[kb]);
      if (lane == 0) {
        mbar_expect_tx(&kv_full[kb], 2 * kTile);
#pragma unroll
        for (int x = 0; x < kB; ++x) {
          const int off = kb * kTile + x * kBoxBytes;
          tma_load4(sK + off, &tk, &kv_full[kb], x * kBox, h, kt * kRows, b);
          tma_load4(sV + off, &tv, &kv_full[kb], x * kBox, h, kt * kRows, b);
        }
      }
      for (int qt = p.causal ? kt : 0; qt < nt; ++qt, ++vt) {
        const int st = vt % kS, ph = (vt / kS) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[st], kVisitTx);
#pragma unroll
          for (int x = 0; x < kB; ++x) {
            const int off = st * kTile + x * kBoxBytes;
            tma_load4(sQ + off, &tq, &full[st], x * kBox, h, qt * kRows, b);
            tma_load4(sdO + off, &tdo, &full[st], x * kBox, h, qt * kRows, b);
          }
        }
        load_stats(sLse + st * kRows, sDelta + st * kRows, p, static_cast<long long>(bh) * T,
                   qt * kRows, lane, &full[st]);
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tid = static_cast<int>(threadIdx.x) - wg * kWgThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = (lane & 3) * 2;
  const float scale = p.scale, scale2 = p.scale2;
  int vt = 0;  // visits consumed by this pipe
  for (int i = 0, w = work(0); w < n_work; w = work(++i)) {
    const int kt = w / BH, bh = w - kt * BH;
    const int kb = i & 1, kph = (i >> 1) & 1;
    // this thread's two key rows: row 16 warp + g + 8 r of the tile
    int kpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) kpos[r] = kt * kRows + 16 * warp + g + 8 * r;
    float dk[kB][32], dv[kB][32];
#pragma unroll
    for (int x = 0; x < kB; ++x) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[x][e] = dv[x][e] = 0.f;
      fence_regs(dk[x]);  // zeroed here, before the first wgmma is issued
      fence_regs(dv[x]);
    }
    mbar_wait(&kv_full[kb], kph);
    float kb2[2] = {0.f, 0.f};  // the key rows' bias, log2 units
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (kBias) kb2[r] = sKb[kb * kRows + 16 * warp + g + 8 * r] * kLog2e;
    const unsigned char* tK = sK + kb * kTile;
    const unsigned char* tV = sV + kb * kTile;
    const int q0 = p.causal ? kt : 0, nv = nt - q0;  // every item has a visit
    float s[32], dp[32];
    uint32_t pa[4][4], da[4][4];
    int st = vt % kS;
    mbar_wait(&full[st], (vt / kS) & 1);
    issue_sdp<D, E>(s, dp, tK, tV, sQ + st * kTile, sdO + st * kTile);
    for (int j = 0; j < nv; ++j, ++vt) {
      // S^T and dP^T of this visit are done, and the last visit's dV and dK
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < kB; ++x) {
        fence_regs(dv[x]);
        fence_regs(dk[x]);
      }
      fence_regs(pa);
      fence_regs(da);
      if (j > 0 && lane == 0) mbar_arrive(&empty[(vt - 1) % kS]);
      const int qt = q0 + j;
      const int vm[2] = {1, qt};  // softmax_grad's entries: the visit's one 64-row unit
      const float* sl = sLse + st * kRows;
      const float* sd = sDelta + st * kRows;
      if ((p.causal && qt == kt) || (ragged && qt == nt - 1))
        softmax_grad<kRows, true, kBias, E>(s, dp, pa, da, sl, sd, vm, kb2, kpos, qd, p.causal,
                                            scale, scale2, T);
      else
        softmax_grad<kRows, false, kBias, E>(s, dp, pa, da, sl, sd, vm, kb2, kpos, qd,
                                             p.causal, scale, scale2, T);
#pragma unroll
      for (int x = 0; x < kB; ++x) {
        fence_regs(dv[x]);
        fence_regs(dk[x]);
      }
      fence_regs(pa);
      fence_regs(da);
      issue_dvdk<kB, E>(dv, dk, pa, da, sdO + st * kTile, sQ + st * kTile);
      // the next visit's S^T and dP^T right behind them; after the last visit this visit's
      // again, as in dkdv_sm90_kernel (an issue every iteration makes keeps the wgmmas
      // unserialized)
      if (j + 1 < nv) {
        st = (vt + 1) % kS;
        mbar_wait(&full[st], ((vt + 1) / kS) & 1);
      }
      issue_sdp<D, E>(s, dp, tK, tV, sQ + st * kTile, sdO + st * kTile);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < kB; ++x) {
      fence_regs(dv[x]);
      fence_regs(dk[x]);
    }
    fence_regs(pa);
    fence_regs(da);
    if (lane == 0) {
      mbar_arrive(&empty[(vt - 1) % kS]);
      mbar_arrive(&kv_empty[kb]);  // this item's K, V (and key bias) are read
    }

    // ---------------------------------------------------------- epilogue
    // each of the thread's rows under T
    const int b = bh / H, h = bh - b * H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kpos[r] >= T) continue;
      const long long row = (static_cast<long long>(b) * T + kpos[r]) * H + h;
      store_row<kB>(static_cast<E*>(p.out0) + row * D, dk, r, qd);
      store_row<kB>(static_cast<E*>(p.out1) + row * D, dv, r, qd);
    }
  }
}

// The dense dQ kernel: dense_dkdv_kernel with the roles of the rows swapped.  Work item w is
// query tile nt - 1 - w / BH of (b, h) = w % BH (the causal items longest first); a pipe loads
// each item's Q, dO, lse and delta once (two buffers) and streams its visits' K and V (key
// tiles 0 .. qt when causal, else 0 .. nt - 1) through the ring.  The accumulator layout and
// the loop are dq_sm90_kernel's.  kBias: each visit's key bias (64 other key rows each visit)
// rides the ring beside its K and V, copied by the producer lanes, and softmax_grad_dq reads
// it from the stage.  E: the element type (bf16, fp16).
template <int D, bool kBias, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    dense_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    DenseParams p) {
  using C = DenseCfg<D>;
  constexpr int kB = D / kBox, kS = kStages, kTile = C::kTileBytes;
  constexpr int kItemTx = 2 * kTile;  // an item's TMA bytes: Q, dO
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int wg = threadIdx.x / kWgThreads;
  const int pipe = wg == 0 ? (threadIdx.x >> 5) & 1 : wg - 1;
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023) + pipe * C::kPipe;
  unsigned char* sQ = smem;                      // [buffer][box][64 rows][128 bytes]
  unsigned char* sdO = sQ + 2 * kTile;           // the same
  unsigned char* sK = sdO + 2 * kTile;           // [stage][box][64 rows][128 bytes]
  unsigned char* sV = sK + kS * kTile;           // the same
  float* sLse = reinterpret_cast<float*>(sV + kS * kTile);  // [buffer][64]
  float* sDelta = sLse + 2 * kRows;                         // the same
  float* sKb = sDelta + 2 * kRows;                          // [stage][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKb + kS * kRows);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kS;

  const int T = p.T, H = p.H, BH = p.BH, nt = p.nt, n_work = nt * BH;
  const int ragged = T % kRows != 0;
  auto work = [&](int r) {  // the snake of dkdv_sm90_kernel
    const int G = 2 * gridDim.x, x = 2 * blockIdx.x + pipe;
    return r * G + ((r & 1) ? G - 1 - x : x);
  };

  if (threadIdx.x == 0 || threadIdx.x == 32) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1 + 32);  // the TMA issue and the producer lanes' lse and delta
      mbar_init(&q_empty[b], 4);      // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], kBias ? 1 + 32 : 1);  // the TMA issue (and the key bias lanes)
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    // warp x of the producer warpgroup feeds pipe x: lane 0 issues the TMA loads, every lane
    // copies two rows of each item's lse and delta (kBias: and of each visit's key bias)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 64) return;
    const int lane = threadIdx.x & 31;
    int vt = 0;  // visits issued to this pipe
    for (int i = 0, w = work(0); w < n_work; w = work(++i)) {
      const int y = w / BH, bh = w - y * BH, b = bh / H, h = bh - b * H, qt = nt - 1 - y;
      const int qb = i & 1, qph = (i >> 1) & 1;
      const int nv = p.causal ? qt + 1 : nt;
      mbar_wait(&q_empty[qb], qph ^ 1);
      load_stats(sLse + qb * kRows, sDelta + qb * kRows, p, static_cast<long long>(bh) * T,
                 qt * kRows, lane, &q_full[qb]);
      if (lane == 0) {
        mbar_expect_tx(&q_full[qb], kItemTx);
#pragma unroll
        for (int x = 0; x < kB; ++x) {
          const int off = qb * kTile + x * kBoxBytes;
          tma_load4(sQ + off, &tq, &q_full[qb], x * kBox, h, qt * kRows, b);
          tma_load4(sdO + off, &tdo, &q_full[qb], x * kBox, h, qt * kRows, b);
        }
      }
      // the visits: lane 0 issues their TMA loads (kBias: every lane copies their key bias)
      if (!kBias && lane != 0) continue;
      for (int kt = 0; kt < nv; ++kt, ++vt) {
        const int st = vt % kS, ph = (vt / kS) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        if (kBias) load_kbias(sKb + st * kRows, p, b, kt * kRows, lane, &full[st]);
        if (lane != 0) continue;
        mbar_expect_tx(&full[st], 2 * kTile);
#pragma unroll
        for (int x = 0; x < kB; ++x) {
          const int off = st * kTile + x * kBoxBytes;
          tma_load4(sK + off, &tk, &full[st], x * kBox, h, kt * kRows, b);
          tma_load4(sV + off, &tv, &full[st], x * kBox, h, kt * kRows, b);
        }
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tid = static_cast<int>(threadIdx.x) - wg * kWgThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = (lane & 3) * 2;
  const float scale = p.scale, scale2 = p.scale2;
  int vt = 0;  // visits consumed by this pipe
  for (int i = 0, w = work(0); w < n_work; w = work(++i)) {
    const int y = w / BH, bh = w - y * BH, qt = nt - 1 - y;
    const int qb = i & 1, qph = (i >> 1) & 1;
    // this thread's two query rows: row 16 warp + g + 8 r of the tile
    int qpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) qpos[r] = qt * kRows + 16 * warp + g + 8 * r;
    float dq[kB][32];
#pragma unroll
    for (int x = 0; x < kB; ++x) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[x][e] = 0.f;
      fence_regs(dq[x]);  // zeroed here, before the first wgmma is issued
    }
    mbar_wait(&q_full[qb], qph);
    float l2[2], dd[2];  // the rows' lse log2 e (+inf where lse is NEG_INF), delta scale
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = qb * kRows + 16 * warp + g + 8 * r;
      const float lse = sLse[at];
      l2[r] = lse > kNegInf * 0.5f ? lse * kLog2e : INFINITY;
      dd[r] = sDelta[at] * scale;
    }
    const unsigned char* tQ = sQ + qb * kTile;
    const unsigned char* tdO = sdO + qb * kTile;
    const int nv = p.causal ? qt + 1 : nt;  // every item has a visit
    float s[32], dp[32];
    uint32_t da[4][4];
    int st = vt % kS;
    mbar_wait(&full[st], (vt / kS) & 1);
    issue_sdp<D, E>(s, dp, tQ, tdO, sK + st * kTile, sV + st * kTile);
    for (int kt = 0; kt < nv; ++kt, ++vt) {
      // S and dP of this visit are done, and the last visit's dQ
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < kB; ++x) fence_regs(dq[x]);
      fence_regs(da);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(vt - 1) % kS]);
      const int vm[2] = {1, kt};  // softmax_grad_dq's entries: the visit's one 64-row unit
      const float* kbs = sKb + st * kRows;
      if ((p.causal && kt == qt) || (ragged && kt == nt - 1))
        softmax_grad_dq<kRows, true, kBias, E>(s, dp, da, kbs, vm, l2, dd, qpos, qd, p.causal,
                                               scale, scale2, T);
      else
        softmax_grad_dq<kRows, false, kBias, E>(s, dp, da, kbs, vm, l2, dd, qpos, qd,
                                                p.causal, scale, scale2, T);
#pragma unroll
      for (int x = 0; x < kB; ++x) fence_regs(dq[x]);
      fence_regs(da);
      issue_dq<kB, E>(dq, da, sK + st * kTile);
      // the next visit's S and dP right behind it; after the last visit this visit's again
      if (kt + 1 < nv) {
        st = (vt + 1) % kS;
        mbar_wait(&full[st], ((vt + 1) / kS) & 1);
      }
      issue_sdp<D, E>(s, dp, tQ, tdO, sK + st * kTile, sV + st * kTile);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < kB; ++x) fence_regs(dq[x]);
    fence_regs(da);
    if (lane == 0) {
      mbar_arrive(&empty[(vt - 1) % kS]);
      mbar_arrive(&q_empty[qb]);  // this item's Q, dO, lse and delta are read
    }

    // ---------------------------------------------------------- epilogue
    // each of the thread's rows under T
    const int b = bh / H, h = bh - b * H;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qpos[r] < T)
        store_row<kB>(
            static_cast<E*>(p.out0) + ((static_cast<long long>(b) * T + qpos[r]) * H + h) * D, dq,
            r, qd);
  }
}

// ---------------------------------------------------------------- host side
// dK/dV (kDq false: out0 dK, out1 dV) or dQ (kDq true: out0 dQ) of one instance, of element
// type E (bf16, fp16)
template <bool kDq, int D, int U, bool kBias, typename E>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* out0, void* out1, const long long* strides, int B, int T,
           int H, int causal, float scale, const GroupSchedule& s, cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -3;
  CUtensorMap mq, mk, mv, mdo, mlse, mdelta, mkb = {};
  if ((kBias && !make_bias_map(enc, &mkb, s.kbias, B, T, U)) ||
      !make_map(enc, &mq, q, strides, B, T, H, D, U, kMapType<E>) ||
      !make_map(enc, &mk, k, strides + 3, B, T, H, D, U, kMapType<E>) ||
      !make_map(enc, &mv, v, strides + 6, B, T, H, D, U, kMapType<E>) ||
      !make_map(enc, &mdo, dout, strides + 9, B, T, H, D, U, kMapType<E>) ||
      !make_stat_map(enc, &mlse, lse, B, T, H, U) ||
      !make_stat_map(enc, &mdelta, delta, B, T, H, U))
    return -2;
  if constexpr (kDq) {
    const DqParams p = {s, out0, T, H, causal, scale, scale * kLog2e};
    return launch_pipes(dq_sm90_kernel<D, U, kBias, E>, C::kSmemDq, s.n_work, stream, mq, mk, mv,
                        mdo, mlse, mdelta, mkb, p);
  } else {
    const Params p = {s, out0, out1, T, H, causal, scale, scale * kLog2e};
    return launch_pipes(dkdv_sm90_kernel<D, U, kBias, E>, C::kSmem, s.n_work, stream, mq, mk, mv,
                        mdo, mlse, mdelta, mkb, p);
  }
}

// the instance of a head dim: by the dtype code (1 bf16, 2 fp16), the slot rows and whether
// there is a key bias
template <bool kDq, int D>
int launch_any(int dtype, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* out0, void* out1,
               const long long* strides, int B, int T, int H, int causal, float scale,
               const GroupSchedule& s, cudaStream_t st) {
#define GROUP_LAUNCH(U, BIAS)                                                                  \
  (dtype == 2 ? launch<kDq, D, U, BIAS, f16>(q, k, v, dout, lse, delta, out0, out1, strides, B, \
                                             T, H, causal, scale, s, st)                       \
              : launch<kDq, D, U, BIAS, bf16>(q, k, v, dout, lse, delta, out0, out1, strides,  \
                                              B, T, H, causal, scale, s, st))
  const bool bias = s.kbias != nullptr;
  switch (s.unit) {
    case 16: return bias ? GROUP_LAUNCH(16, true) : GROUP_LAUNCH(16, false);
    case 32: return bias ? GROUP_LAUNCH(32, true) : GROUP_LAUNCH(32, false);
    case 64: return bias ? GROUP_LAUNCH(64, true) : GROUP_LAUNCH(64, false);
    default: return -1;
  }
#undef GROUP_LAUNCH
}

// dK/dV (kDq false: out0 dK, out1 dV) or dQ (kDq true: out0 dQ) of a dense call of element
// type E (kbias: the (B, T) key bias, or null for none)
template <bool kDq, typename E>
int launch_dense(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, void* out0, void* out1, const long long* strides, int B,
                 int T, int H, int causal, float scale, const float* kbias,
                 cudaStream_t stream) {
  constexpr int D = 64;
  constexpr CUtensorMapDataType type = kMapType<E>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -3;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(enc, &mq, q, strides, B, T, H, D, kRows, type) ||
      !make_map(enc, &mk, k, strides + 3, B, T, H, D, kRows, type) ||
      !make_map(enc, &mv, v, strides + 6, B, T, H, D, kRows, type) ||
      !make_map(enc, &mdo, dout, strides + 9, B, T, H, D, kRows, type))
    return -2;
  const int nt = (T + kRows - 1) / kRows;
  const DenseParams p = {lse, delta, kbias, out0, out1, T, H, B * H, nt, causal, scale,
                         scale * kLog2e};
  constexpr size_t smem = DenseCfg<D>::kSmem;
  const int n_work = nt * B * H;
  if constexpr (kDq) {
    if (kbias != nullptr)
      return launch_pipes(dense_dq_kernel<D, true, E>, smem, n_work, stream, mq, mk, mv, mdo, p);
    return launch_pipes(dense_dq_kernel<D, false, E>, smem, n_work, stream, mq, mk, mv, mdo, p);
  } else {
    if (kbias != nullptr)
      return launch_pipes(dense_dkdv_kernel<D, true, E>, smem, n_work, stream, mq, mk, mv, mdo,
                          p);
    return launch_pipes(dense_dkdv_kernel<D, false, E>, smem, n_work, stream, mq, mk, mv, mdo,
                        p);
  }
}

// whether the dense instances were built for a call: bf16 (dtype code 1) or fp16 (code 2), with
// or without a key bias; head dim 64; the work items within int
bool dense_built_for(int dtype, int head_dim, int B, int T, int H) {
  return (dtype == 1 || dtype == 2) && head_dim == 64 && B > 0 && T > 0 && H > 0 &&
         static_cast<long long>(B) * H * ((T + kRows - 1) / kRows) < (1ll << 31);
}

// a dense call of dtype code 1 (bf16) or 2 (fp16)
template <bool kDq>
int launch_dense_any(int dtype, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* out0, void* out1,
                     const long long* strides, int B, int T, int H, int causal, float scale,
                     const float* kbias, cudaStream_t stream) {
  return dtype == 2 ? launch_dense<kDq, f16>(q, k, v, dout, lse, delta, out0, out1, strides, B,
                                             T, H, causal, scale, kbias, stream)
                    : launch_dense<kDq, bf16>(q, k, v, dout, lse, delta, out0, out1, strides, B,
                                              T, H, causal, scale, kbias, stream);
}

}  // namespace

// dtype: 1 bf16, 2 fp16; strides: 12 int64, the (b, t, h) element strides of q, k, v and dout;
// s: the schedule (GroupLut side "k").
extern "C" int flash_bwd_dkdv_lut_sm90(int dtype, int head_dim, const void* q, const void* k,
                                       const void* v, const void* dout, const float* lse,
                                       const float* delta, void* dk, void* dv,
                                       const long long* strides, int B, int T, int H,
                                       int causal, float scale, const GroupSchedule* s,
                                       void* stream) {
  if (!built_for(dtype, head_dim, T, s)) return -1;
  if (s->n_work == 0) return 0;
  return launch_any<false, 64>(dtype, q, k, v, dout, lse, delta, dk, dv, strides, B, T, H,
                               causal, scale, *s, reinterpret_cast<cudaStream_t>(stream));
}

// The same arguments with one output; s: the schedule of GroupLut side "q".
extern "C" int flash_bwd_dq_lut_sm90(int dtype, int head_dim, const void* q, const void* k,
                                     const void* v, const void* dout, const float* lse,
                                     const float* delta, void* dq, const long long* strides,
                                     int B, int T, int H, int causal, float scale,
                                     const GroupSchedule* s, void* stream) {
  if (!built_for(dtype, head_dim, T, s)) return -1;
  if (s->n_work == 0) return 0;
  return launch_any<true, 64>(dtype, q, k, v, dout, lse, delta, dq, nullptr, strides, B, T, H,
                              causal, scale, *s, reinterpret_cast<cudaStream_t>(stream));
}

// The dense dK/dV: flash_bwd_dkdv's arguments (flash_attention.cu; dtype 1 bf16, 2 fp16), then
// kbias: the (B, T) fp32 key bias, contiguous, or null for none.
extern "C" int flash_bwd_dkdv_sm90(int dtype, int head_dim, const void* q, const void* k,
                                   const void* v, const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv,
                                   const long long* strides, int B, int T, int H, int causal,
                                   float scale, const float* kbias, void* stream) {
  if (!dense_built_for(dtype, head_dim, B, T, H)) return -1;
  return launch_dense_any<false>(dtype, q, k, v, dout, lse, delta, dk, dv, strides, B, T, H,
                                 causal, scale, kbias, reinterpret_cast<cudaStream_t>(stream));
}

// The dense dQ: flash_bwd_dq's arguments (flash_attention.cu), then kbias as above.
extern "C" int flash_bwd_dq_sm90(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* dout, const float* lse,
                                 const float* delta, void* dq, const long long* strides, int B,
                                 int T, int H, int causal, float scale, const float* kbias,
                                 void* stream) {
  if (!dense_built_for(dtype, head_dim, B, T, H)) return -1;
  return launch_dense_any<true>(dtype, q, k, v, dout, lse, delta, dq, nullptr, strides, B, T, H,
                                causal, scale, kbias, reinterpret_cast<cudaStream_t>(stream));
}

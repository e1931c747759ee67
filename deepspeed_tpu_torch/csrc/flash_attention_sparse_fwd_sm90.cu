// Block-sparse flash-attention forward for Hopper (sm_90a), bf16 and fp16, head dim 64: the
// entry flash_fwd_lut_sm90, the (B, T) key bias optional.
//
// Replaces the Pallas TPU kernels _fwd_kernel with use_lut and use_kbias (144-283) and
// _fwd_kernel_dma (306-415) of deepspeed_tpu/ops/transformer/flash_attention.py, built by _fwd
// (441-613) and reached through sparse_flash_attention (1108-1173) and _biased_call (1221).
// The template kernel fwd_kernel<kLut, kBias> of flash_attention.cuh (flash_fwd_lut with the
// biases, flash_fwd_lut_ring without: 4 warps, 64 x 64 tiles carrying a mask of their live
// layout cells, mma.sync, a cp.async ring) keeps fp32, head dims 96 and 128 and the (T, T)
// score bias; ops/transformer/flash_attention.py: sparse_fwd_kernel routes bf16 and fp16 at
// head dim 64 here.  It computes what the template computes:
//   S = Q K^T scale + kbias over the live pairs (the layout cell live, and when causal k <= q);
//   an online softmax with fp32 m, l and O, P rounded to bf16 before P V; O = acc / l, bf16,
//   contiguous (B, T, H, D); lse = m + log l, fp32 (B, H, T), natural log.  A row whose
//   maximum stays <= NEG_INF / 2 (no live key, or every live key biased by NEG_INF: a fully
//   padded batch row under a "mul" bias) writes O = 0 and lse = NEG_INF (row_live, 278-283),
//   and so does every row of an output tile with no visit.  The backward kernels read this lse.
//
// What bounds it: 4·D flops per live (q, k) pair (S and P V).  At BERT-large's shape with the
// tutorial layout (B=8, T=2048, H=16, D=64; Fixed, block 16, local 4, global 1, bidirectional;
// element density 0.2734) that is 37.6 GFLOP, 38.0 us at the H100's 989 bf16 TFLOP/s, against
// 135 MB of q, k, v, O, lse and the key bias, 40.4 us at 3.35 TB/s: the bytes bound it, just.
// The template computes every pair of each 64 x 64 tile that holds a live cell (at block 16
// that is every tile, 3.66x the live pairs) and masks each element.  This design is the
// block-sparse dQ kernel's (flash_attention_sparse_bwd_sm90.cu: dq_sm90_kernel) without the
// dP product, with the online softmax of flash_fwd_sm90 in place of the lse step:
//   * the schedule is GroupLut(side="q") (ops/transformer/flash_attention.py), the one dQ
//     runs: query blocks grouped by the set of key blocks live for them, packed R = 64 / U to
//     a 64-row output tile (U = min(block, 64) rows a slot), each tile visiting its group's
//     live key blocks R at a time; only a visit with an empty key slot or a causal diagonal
//     unit is flagged and takes the per-element mask.  The tutorial layout's 1024 tiles per
//     head become 288 visits on 32 output tiles, 97% live;
//   * a block (one an SM, 384 threads) holds two pipes, each a consumer warpgroup fed by one
//     thread of the producer warpgroup through its own half of shared memory: a pipe owns one
//     output tile at a time, loads its Q once (gathered from U-row TMA boxes, 128-byte
//     swizzled, an empty slot reading rows from T on as zeros; two buffers, so the next
//     tile's Q arrives during this one) and streams the visits' K, V and key-bias slots
//     through a ring of kStages stages with full and empty mbarriers; the producer hands the
//     schedule entries over in shared memory; setmaxnreg gives the consumers 224 registers;
//     an mbarrier wait longer than 2 s traps;
//   * per visit S = Q K^T is wgmma m64n64k16 with both operands in shared memory; the online
//     softmax runs on the accumulators in registers, in log2 units: the scores with the key
//     bias (one FMA), the row max across the quad, alpha = 2^(m_old - m_new) and the rescale
//     of the 32 O accumulators, P = 2^(x - m_new) (a masked pair enters as -inf, so its P is
//     0 with no select) straight into bf16 register-A fragments; O += P V is wgmma with V
//     read through the transpose bit (issue_dq of the shared header), and the next visit's S
//     is issued right behind it;
//   * the epilogue reduces l across the quad, scales O by 1 / l and stores each filled slot's
//     rows to their own positions (an empty slot's rows are not stored) and lse per row;
//     each output row belongs to one output tile, written once by its pipe: deterministic;
//   * instances by slot rows U (16, 32, 64) and key bias; the grid is persistent, one block
//     an SM, the work items (an output tile of one (b, h)) longest first, dealt over the
//     pipes in the snake of the group backward kernels.
// fp16 (dtype code 2): the same instances with the element type E a template parameter:
// wgmma .f32.f16.f16, P rounded to fp16 before P V (pack2<f16>, __floats2half2_rn), O written
// fp16 and the tensor maps of data type FLOAT16.  The scores, the key bias (a padded key's
// NEG_INF included), m, l and lse stay fp32: only P and O are fp16.  An O past 65504 (only an
// inf or a V past 65504 gives one: O is a convex mix of V rows) becomes inf, no conversion
// saturates.
// flash_fwd_lut_sm90_schedule in ops/transformer/flash_attention.py is this kernel's schedule
// in Python.  PERF.md holds its times; examples/sparse_fwd_check.py times variants with parts
// taken out.
//
// C interface for ctypes: flash_fwd's argument list (flash_attention.cu) with the schedule
// after it; returns cudaGetLastError() after the launch (0 on success), -1 for a dtype / head
// dim / slot size / shape it was not built for, -2 when a tensor map cannot be encoded and -3
// when cuTensorMapEncodeTiled cannot be found.

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kProducerRegs = 56, kConsumerRegs = 224;   // setmaxnreg: 128 x 56 + 256 x 224
constexpr int kStages = 4;                                // visits in the ring
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdCfg {
  static constexpr int kBoxes = D / kBox;
  static constexpr int kTileBytes = kRows * D * 2;        // a 64-row tile of Q, K or V
  // one pipe: Q in two buffers, K, V and the key-bias slots in the ring, the entries, the
  // barriers; a multiple of 1024 so the second pipe's tiles stay aligned
  static constexpr size_t kPipe = (2 * static_cast<size_t>(kTileBytes) +
                                   kStages * (2 * static_cast<size_t>(kTileBytes) +
                                              4 * kStatSlot * 4) +
                                   4 * 8 * (2 + kStages) + 8 * (4 + 2 * kStages) + 1023) /
                                  1024 * 1024;
  static constexpr size_t kSmem = 1024 + 2 * kPipe;
};

struct FwdParams {
  GroupSchedule s;
  void* o;                      // (B, T, H, D) of the element type E
  float* lse;
  int T, H, causal;
  float scale2;                 // scale * log2 e
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q K^T of one visit, both operands in shared memory (K-major, as TMA writes them), of
// element type E; one commit group.  It is issued while the last visit's O += P V is in
// flight, so it touches s with nothing but the wgmmas (see issue_sdp in
// flash_attention_sparse_bwd_sm90.cu).
template <int D, typename E>
__device__ __forceinline__ void issue_s(float (&s)[32], const unsigned char* tQ,
                                        const unsigned char* vK) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n64<E>(s, desc_sw128(tQ + off, 16, 1024), desc_sw128(vK + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// The online softmax of one visit, from its S accumulators (read only), its key-bias slots
// (kb) and entries (vm: the mask flag and the key units), the thread's two query rows (qpos,
// -1 in an empty slot): the scores x = S scale log2e + kbias log2e, -inf where a flagged visit
// (kMasked) masks (an empty key slot, and when causal a key after the query); m, the rows'
// running maxima (log2 units, quad-uniform), and l, the thread's partial row sums, move on;
// O is rescaled by 2^(m_old - m_new); P = 2^(x - m_new) goes to E A fragments (bf16 or fp16;
// columns 8 n + qd + e of row r are word 2 (n & 1) + r of fragment n / 2, as in softmax_grad).
template <int kB, int U, bool kMasked, bool kBias, typename E>
__device__ __forceinline__ void online_softmax(const float (&s)[32], float (&o)[kB][32],
                                               uint32_t (&pa)[4][4], float (&m)[2],
                                               float (&l)[2], const float* kb, const int* vm,
                                               const int (&qpos)[2], int qd, int causal,
                                               float scale2) {
  float x[32];
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};  // [row][n & 1]
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    // columns 8 n + qd + e are rows row + e of the key slot `slot`; slot and row - qd are
    // constants
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
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * n + 2 * r + e;
        float v = fmaf(s[idx], scale2, kb2[e]);
        if (kMasked && !(kpos >= 0 && (!causal || qpos[r] >= kpos + e))) v = -INFINITY;
        x[idx] = v;
        mx[r][n & 1] = fmaxf(mx[r][n & 1], v);
      }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(fmaxf(mx[r][0], mx[r][1])));
    alpha[r] = exp2_ftz(m[r] - mn);
    m[r] = mn;
  }
  float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = 4 * n + 2 * r;
      const float p0 = exp2_ftz(x[idx] - m[r]), p1 = exp2_ftz(x[idx + 1] - m[r]);
      ls[r][n & 1] += p0 + p1;
      pa[n >> 1][2 * (n & 1) + r] = pack2<E>(p0, p1);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (ls[r][0] + ls[r][1]);
#pragma unroll
  for (int xb = 0; xb < kB; ++xb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[xb][e] *= alpha[(e >> 1) & 1];
}

// ---------------------------------------------------------------- the kernel
// Accumulator layout of the warpgroup's 64 x 64 products (wgmma, fp32): warp w holds rows
// 16 w + g and 16 w + g + 8 (g = lane / 4); element 4 n + 2 r + e is row 16 w + g + 8 r,
// column 8 n + 2 (lane % 4) + e.  Rows are query rows of the output tile, columns key rows of
// the visit (in S) or head-dim columns (in O).  The producer and the loop are dq_sm90_kernel's
// with Q alone per item and K, V and the key-bias slots per visit.  E: the element type of q,
// k, v and O (bf16, fp16).
template <int D, int U, bool kBias, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_lut_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tkb, FwdParams p) {
  using C = FwdCfg<D>;
  constexpr int kB = C::kBoxes, kS = kStages, kTile = C::kTileBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // two pipes a block, each a consumer warpgroup fed by one producer thread (warp 0 or 1 of
  // the producer warpgroup, lane 0) through its own half of shared memory and barriers
  const int wg = threadIdx.x / kWgThreads;
  const int pipe = wg == 0 ? (threadIdx.x >> 5) & 1 : wg - 1;
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023) + pipe * C::kPipe;
  unsigned char* sQ = smem;                      // [buffer][box][64 rows][128 bytes]
  unsigned char* sK = sQ + 2 * kTile;            // [stage][box][64 rows][128 bytes]
  unsigned char* sV = sK + kS * kTile;           // the same
  float* sKb = reinterpret_cast<float*>(sV + kS * kTile);         // [stage][slot][kStatSlot]
  int* sItem = reinterpret_cast<int*>(sKb + kS * 4 * kStatSlot);  // [buffer][8]
  int* sVisit = sItem + 2 * 8;                                    // [stage][8]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sVisit + kS * 8);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kS;

  constexpr int R = kRows / U;  // slots per tile
  const int T = p.T, H = p.H;
  const GroupSchedule sc = p.s;
  // in round r pipe x = 2 blockIdx.x + pipe takes item r G + x, or r G + G - 1 - x when r is
  // odd (G = 2 gridDim.x): a snake over the longest-first items
  auto work = [&](int r) {
    const int G = 2 * gridDim.x, x = 2 * blockIdx.x + pipe;
    return r * G + ((r & 1) ? G - 1 - x : x);
  };

  if (threadIdx.x == 0 || threadIdx.x == 32) {  // each pipe's producer thread, its barriers
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
      // the item's Q buffer: its entries, then (if it has visits) its loads
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
      if (v0 == v1) {  // no visit: the consumers write O = 0 and lse = NEG_INF
        mbar_arrive(&q_full[qb]);
        continue;
      }
      mbar_expect_tx(&q_full[qb], kTile);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s >= R) break;
        const int u = (&out.x)[s];
        const int r0 = u < 0 ? T : u * U;  // an empty slot: rows past T, zeros
#pragma unroll
        for (int x = 0; x < kB; ++x)
          tma_load4(sQ + qb * kTile + x * kBoxBytes + s * U * 128, &tq, &q_full[qb], x * kBox, h,
                    r0, b);
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
  const float scale2 = p.scale2;
  int vt = 0;  // visits consumed by this pipe
  for (int i = 0, w = work(0); w < sc.n_work; w = work(++i)) {
    const int qb = i & 1, qph = (i >> 1) & 1;
    mbar_wait(&q_full[qb], qph);
    const int* meta = sItem + qb * 8;
    const int b = meta[0], h = meta[1], nv = meta[2];
    // this thread's two query rows: row 16 warp + g + 8 r of the tile, in slot row / U
    int qpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = 16 * warp + g + 8 * r, u = meta[3 + rl / U];
      qpos[r] = u < 0 ? -1 : u * U + (rl & (U - 1));
    }
    float o[kB][32];
#pragma unroll
    for (int x = 0; x < kB; ++x) {
#pragma unroll
      for (int e = 0; e < 32; ++e) o[x][e] = 0.f;
      fence_regs(o[x]);  // zeroed here, before the first wgmma is issued
    }
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's partial sums

    if (nv > 0) {
      const unsigned char* tQ = sQ + qb * kTile;
      float s[32];
      uint32_t pa[4][4];
      int st = vt % kS;
      mbar_wait(&full[st], (vt / kS) & 1);
      issue_s<D, E>(s, tQ, sK + st * kTile);
      for (int j = 0; j < nv; ++j, ++vt) {
        // S of this visit is done, and the last visit's O += P V
        wgmma_wait<0>();
        fence_regs(s);
#pragma unroll
        for (int x = 0; x < kB; ++x) fence_regs(o[x]);
        fence_regs(pa);
        if (j > 0 && lane == 0) mbar_arrive(&empty[(vt - 1) % kS]);
        const float* kb = sKb + st * 4 * kStatSlot;
        const int* vm = sVisit + st * 8;

        if (vm[0] != 0)
          online_softmax<kB, U, true, kBias, E>(s, o, pa, m, l, kb, vm, qpos, qd, p.causal,
                                                scale2);
        else
          online_softmax<kB, U, false, kBias, E>(s, o, pa, m, l, kb, vm, qpos, qd, p.causal,
                                                 scale2);

        // O += P V
#pragma unroll
        for (int x = 0; x < kB; ++x) fence_regs(o[x]);
        fence_regs(pa);
        issue_dq<kB, E>(o, pa, sV + st * kTile);
        // the next visit's S right behind it; after the last visit, this visit's again (its
        // stage is still held; the result goes unused), as in dq_sm90_kernel: an issue that
        // every iteration makes keeps ptxas from serializing the wgmmas (C7515)
        if (j + 1 < nv) {
          st = (vt + 1) % kS;
          mbar_wait(&full[st], ((vt + 1) / kS) & 1);
        }
        issue_s<D, E>(s, tQ, sK + st * kTile);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < kB; ++x) fence_regs(o[x]);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&empty[(vt - 1) % kS]);
    }
    if (lane == 0) mbar_arrive(&q_empty[qb]);  // this item's entries and Q are read

    // ---------------------------------------------------------- epilogue
    // O = acc / l and lse = m ln 2 + log l for each of the thread's rows in a filled slot; a
    // row whose maximum stayed at or below NEG_INF / 2 gets O = 0 and lse = NEG_INF
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lsum = quad_sum(l[r]);
      const bool live = m[r] > kNegInf * 0.5f;
      const float l_safe = lsum == 0.f ? 1.f : lsum;
      inv[r] = live ? 1.f / l_safe : 0.f;
      if ((lane & 3) == 0 && qpos[r] >= 0)
        p.lse[(static_cast<long long>(b) * H + h) * T + qpos[r]] =
            live ? m[r] * kLn2 + logf(l_safe) : kNegInf;
    }
#pragma unroll
    for (int x = 0; x < kB; ++x)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[x][e] *= inv[(e >> 1) & 1];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qpos[r] >= 0)
        store_row<kB>(
            static_cast<E*>(p.o) + ((static_cast<long long>(b) * T + qpos[r]) * H + h) * D, o, r,
            qd);
  }
}

// ---------------------------------------------------------------- host side
// one call of instance (D, U, kBias) of element type E (bf16, fp16)
template <int D, int U, bool kBias, typename E>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* strides, int B, int T, int H, int causal, float scale,
           const GroupSchedule& s, cudaStream_t stream) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -3;
  CUtensorMap mq, mk, mv, mkb = {};
  if ((kBias && !make_bias_map(enc, &mkb, s.kbias, B, T, U)) ||
      !make_map(enc, &mq, q, strides, B, T, H, D, U, kMapType<E>) ||
      !make_map(enc, &mk, k, strides + 3, B, T, H, D, U, kMapType<E>) ||
      !make_map(enc, &mv, v, strides + 6, B, T, H, D, U, kMapType<E>))
    return -2;
  const FwdParams p = {s, o, lse, T, H, causal, scale * kLog2e};
  return launch_pipes(fwd_lut_sm90_kernel<D, U, kBias, E>, FwdCfg<D>::kSmem, s.n_work, stream, mq,
                      mk, mv, mkb, p);
}

}  // namespace

// dtype: 1 bf16, 2 fp16; strides: 12 int64, the (b, t, h) element strides of q, k, v (and an
// unused fourth triple); s: the schedule of GroupLut side "q" with the key bias (or null).
extern "C" int flash_fwd_lut_sm90(int dtype, int head_dim, const void* q, const void* k,
                                  const void* v, void* out, float* lse, const long long* strides,
                                  int B, int T, int H, int causal, float scale,
                                  const GroupSchedule* s, void* stream) {
  if (!built_for(dtype, head_dim, T, s)) return -1;
  if (s->n_work == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define FWD_LAUNCH(U, BIAS)                                                                   \
  (dtype == 2 ? launch<64, U, BIAS, f16>(q, k, v, out, lse, strides, B, T, H, causal, scale, *s, \
                                         st)                                                     \
              : launch<64, U, BIAS, bf16>(q, k, v, out, lse, strides, B, T, H, causal, scale, *s, \
                                          st))
  const bool bias = s->kbias != nullptr;
  switch (s->unit) {
    case 16: return bias ? FWD_LAUNCH(16, true) : FWD_LAUNCH(16, false);
    case 32: return bias ? FWD_LAUNCH(32, true) : FWD_LAUNCH(32, false);
    case 64: return bias ? FWD_LAUNCH(64, true) : FWD_LAUNCH(64, false);
    default: return -1;
  }
#undef FWD_LAUNCH
}

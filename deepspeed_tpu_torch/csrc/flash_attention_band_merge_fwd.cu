// Flash attention for Hopper (sm_90a), the banded and merged-row forward entries.
//
// Replaces, from deepspeed_tpu/ops/transformer/flash_attention.py:
//   variant 4, flash_fwd_banded  <- _fwd_kernel with use_banded (180-198, 230-244; set up in
//                                   _fwd 453-458, 482-504; detected by _banded_structure
//                                   999-1034): causal attention over a layout shared by the
//                                   heads whose live blocks are a band of W layout blocks
//                                   below the diagonal plus global columns
//   variant 5, flash_fwd_merged  <- _fwd_kernel with use_merge (161-164, 245-255) and
//                                   _fwd_kernel_dma with use_merge (317-319, 384-390): two
//                                   q tiles share one kernel row over the union of their
//                                   live k tiles, each half under its own tile masks
// Both compute what the LUT forward computes for the same layout (O in the input dtype and
// the fp32 lse, a row with no live key gives O = 0 and lse = NEG_INF); they differ in how a
// block finds its k tiles and in how many q rows one K/V tile feeds.  What bounds them
// and the shared machinery (mma.sync tiles, cp.async staging, log2-unit online softmax)
// are in flash_attention.cuh.
//
// Banded: one block of 4 warps per 64-row q tile, as the LUT forward.  Its k tiles come
// from affine arithmetic on the band, not from a LUT in device memory: the global tiles
// that lie below the band of the tile's first layout row r0 (Band.gtile, ascending, a
// kernel parameter), then the band's tiles from floor(max(r0 - W + 1, 0) * Lb / 64) up to
// the diagonal tile.  The element mask is positional (k <= q, k < T, and
// layout_row(q) - layout_col(k) < W or layout_col(k) global, 230-244), so layout blocks 16
// and 32, where one q tile spans 4 or 2 layout rows with different band starts, stay
// exact with no cell bits; at blocks of 64 or more a band tile lies in the band of every
// row of the q tile and a global tile in one global column, so only the diagonal and the
// ragged end take the per-element pass.
//
// Merged: one block of 8 warps per 128-row kernel row (q tiles 2i and 2i+1); warps 0-3 own
// the upper tile, 4-7 the lower.  The k tiles are the union of the two tiles' LUT rows,
// each slot carrying one tile mask per half (-1, cell bits, or 0 where the half has no
// such tile); a warp whose half is not live on a slot, or whose rows all lie above the
// tile, skips that slot's products, and the element causal mask uses each row's own
// position.  Each K/V tile staged in shared memory feeds 128 query rows instead of 64.
//
// Both stage K/V through a ring of cp.async stages (3 where shared memory allows, as
// flash_fwd_lut_ring; fewer for the wide fp32 tiles) and take no biases.
//
// bf16 and fp16 at head dims 64 and 128 run the schedule instances of flash_fwd_sm90 instead
// (flash_fwd_banded_sm90 / flash_fwd_merged_sm90 in flash_attention_fwd_sm90.cu: TMA, wgmma,
// 128-row q tiles, a persistent grid); these entries keep fp32 and head dim 96 (bf16, fp16)
// and are called by name for the rest (flash_fwd_banded_template / flash_fwd_merged_template).
//
// C interface for ctypes: returns cudaGetLastError() after the launch (0 on success), or
// -1 for a variant / dtype / head dim / shape it was not built for.

#include "flash_attention.cuh"

namespace {

// kBanded: layout blocks of 64 or more (whole tiles in or out of the band); kBandedCells:
// blocks 16 and 32 (the band and global tests per element); kMerged: two q tiles per block
enum Sched { kBanded, kBandedCells, kMerged };

constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90

// shared memory of a forward with BQ q rows and S stages of K and V
template <typename T, int D, int BQ>
constexpr size_t sched_smem(int S) {
  return sizeof(T) * (static_cast<size_t>(BQ + 2 * S * kBK) * (D + kPad) +
                      (std::is_same<T, float>::value ? static_cast<size_t>(BQ) * kLdS : 0));
}

// the deepest ring (at most 3) that fits: fp32 at d=128 keeps 2 stages (64 rows) or 1
// (128 rows), fp32 at d=96 and 128 rows 2
template <typename T, int D, int BQ>
constexpr int sched_stages() {
  return sched_smem<T, D, BQ>(3) <= kMaxSmem ? 3 : sched_smem<T, D, BQ>(2) <= kMaxSmem ? 2 : 1;
}

template <typename T, int D, Sched S, int kStages>
__device__ __forceinline__ void fwd_sched(const Args& a, const Band* band) {
  constexpr bool kBand = S != kMerged;
  constexpr int BQ = kBand ? kBQ : 2 * kBQ;  // q rows per block
  constexpr int NT = 2 * BQ;                        // threads: 16 rows per warp
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDD = D + kPad, kStage = 2 * kBK * LDD;
  T* sQ = reinterpret_cast<T*>(smem);  // [BQ][LDD]
  T* sKV = sQ + BQ * LDD;              // kStages stages of K then V, [kBK][LDD] each
  T* sP = sKV + kStages * kStage;      // fp32 only: [BQ][kLdS], 16 rows per warp

  const int nq = cdiv(a.T, BQ);
  const int qt = nq - 1 - blockIdx.x;
  const int q0 = qt * BQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int warp = threadIdx.x >> 5, lane = lane_id();
  const int g = lane >> 2, qd = (lane & 3) * 2;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int row[2] = {w0 + g, w0 + g + 8};
  T* myP = sP + warp * 16 * kLdS;
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);

  // the schedule: nk visited k tiles, the j-th starting at key tile0(j)
  int nk, n_glob = 0, kt_lo = 0;
  const int* map = nullptr;
  const int* mask = nullptr;
  if constexpr (kBand) {
    kt_lo = max(q0 / band->lb - band->w + 1, 0) * band->lb / kBK;  // the band's first tile
    while (n_glob < band->n_gtiles && band->gtile[n_glob] < kt_lo) ++n_glob;
    nk = n_glob + max(qt - kt_lo + 1, 0);
  } else {
    const long long r = static_cast<long long>(a.lut_heads == 1 ? 0 : h) * nq + qt;
    map = a.lut_map + r * a.lut_width;
    mask = a.lut_mask + r * a.lut_width * 2;  // two halves per slot
    nk = a.lut_len[r];
  }
  auto tile0 = [&](int j) {
    if constexpr (kBand)
      return (j < n_glob ? static_cast<int>(band->gtile[j]) : kt_lo + j - n_glob) * kBK;
    else
      return map[j] * kBK;
  };
  auto issue = [&](int j, int stage) {
    T* dst = sKV + stage * kStage;
    const int k0 = tile0(j);
    load_rows<T, D, NT>(dst, LDD, K, a.sk, b, h, k0, a.T);
    load_rows<T, D, NT>(dst + kBK * LDD, LDD, V, a.sv, b, h, k0, a.T);
  };

#pragma unroll
  for (int r = 0; r < BQ; r += 64)
    load_rows<T, D, NT>(sQ + r * LDD, LDD, static_cast<const T*>(a.q), a.sq, b, h, q0 + r, a.T);
#pragma unroll
  for (int s = 0; s + 1 < kStages; ++s) {  // slots 0 .. kStages-2 in flight before slot 0 computes
    if (s < nk) issue(s, s);
    cp_async_commit();
  }
  FragA<T, D> qa;
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = a.scale * kLog2e;
  for (int j = 0; j < nk; ++j) {
    const int k0 = tile0(j);
    const int stage = j % kStages;
    const T* sK = sKV + stage * kStage;
    const T* sV = sK + kBK * LDD;
    // slot j + kStages - 1 refills the stage that slot j - 1 left (every warp passed the
    // barrier at the end of iteration j - 1); a group is committed even when empty, so
    // "all but the newest kStages - 1 groups" is always "slot j is in"
    if (j + kStages - 1 < nk) issue(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (j == 0) qa.load(sQ + warp * 16 * LDD, LDD);

    // which of this warp's (row, key) pairs are live: `visit` skips the slot's products
    // (warp-uniform), `masked` asks for the per-element pass
    bool visit = true, masked;
    int cmask = -1, gcells = 0, c0 = 0;
    if constexpr (kBand) {
      masked = k0 + kBK > a.T || k0 + kBK - 1 > w0;  // the ragged end, the diagonal
      if constexpr (S == kBandedCells) {
        // layout blocks 16 / 32: the tile's cells that are global columns, and whether
        // some row of the warp lies below the band of some cell of the tile
        c0 = k0 >> band->cell_shift;
        for (int u = 0; u < (kBK >> band->cell_shift); ++u)
          gcells |= ((band->gbits[(c0 + u) >> 5] >> ((c0 + u) & 31)) & 1) << u;
        masked = masked || ((w0 + 15) >> band->cell_shift) - c0 >= band->w;
      }
    } else {
      cmask = mask[2 * j + (warp >> 2)];
      visit = cmask != 0 && !(a.causal && k0 > w0 + 15);
      masked = k0 + kBK > a.T || (a.causal && k0 + kBK - 1 > w0) || cmask != -1;
    }
    if (visit) {
      float s[kBK / 8][4] = {};
      warp_mm<kBK, D, false>(s, qa, sK, LDD);  // S = Q K^T
      float mc[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = k0 + n * 8 + qd + (e & 1);
          // (the banded forward is causal)
          bool valid = !masked || (col < a.T && ((!kBand && !a.causal) || row[r] >= col));
          if (masked) {
            if constexpr (S == kBandedCells) {
              const int cc = col >> band->cell_shift;
              valid = valid && ((row[r] >> band->cell_shift) - cc < band->w ||
                                ((gcells >> (cc - c0)) & 1));
            } else if constexpr (S == kMerged) {
              valid = valid && (cmask == -1 || cell_live(cmask, a.cell_shift,
                                                         row[r] - (q0 + (warp >> 2) * kBQ),
                                                         col - k0));
            }
          }
          s[n][e] = valid ? s[n][e] * scale2 : kNegInf;
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
    }
    __syncthreads();  // this stage is refilled at the next iteration
  }
  cp_async_wait<0>();  // a row with no live tile, the ring's tail

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

template <typename T, int D, Sched S, int kStages>
__global__ void __launch_bounds__(kThreads) fwd_banded_kernel(Args a, const __grid_constant__ Band band) {
  fwd_sched<T, D, S, kStages>(a, &band);
}

template <typename T, int D, int kStages>
__global__ void __launch_bounds__(2 * kThreads) fwd_merged_kernel(Args a) {
  fwd_sched<T, D, kMerged, kStages>(a, nullptr);
}

template <Sched S, typename T, int D>
int launch_sched(const Args& a, const Band* band, cudaStream_t stream) {
  constexpr int BQ = S == kMerged ? 2 * kBQ : kBQ;
  constexpr int kStages = sched_stages<T, D, BQ>();
  constexpr size_t smem = sched_smem<T, D, BQ>(kStages);
  static_assert(smem <= kMaxSmem, "the tiles do not fit in shared memory");
  const dim3 grid(cdiv(a.T, BQ), a.B * a.H);
  if constexpr (S != kMerged) {
    void (*kernel)(Args, const Band) = fwd_banded_kernel<T, D, S, kStages>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, kThreads, smem, stream>>>(a, *band);
  } else {
    void (*kernel)(Args) = fwd_merged_kernel<T, D, kStages>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, 2 * kThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 fp32 (CUDA cores), 1 bf16, 2 fp16 (tensor cores); head dims 64, 96, 128
template <Sched S>
int dispatch_sched(int dtype, int head_dim, const Args& a, const Band* band,
                   cudaStream_t stream) {
  if (a.B * a.H > 65535) return -1;
  if (a.T == 0 || a.B * a.H == 0) return 0;
  if (dtype == 1) {
    switch (head_dim) {
      case 64: return launch_sched<S, bf16, 64>(a, band, stream);
      case 96: return launch_sched<S, bf16, 96>(a, band, stream);
      case 128: return launch_sched<S, bf16, 128>(a, band, stream);
      default: return -1;
    }
  }
  if (dtype == 2) {
    switch (head_dim) {
      case 64: return launch_sched<S, f16, 64>(a, band, stream);
      case 96: return launch_sched<S, f16, 96>(a, band, stream);
      case 128: return launch_sched<S, f16, 128>(a, band, stream);
      default: return -1;
    }
  }
  if (dtype == 0) {
    switch (head_dim) {
      case 64: return launch_sched<S, float, 64>(a, band, stream);
      case 96: return launch_sched<S, float, 96>(a, band, stream);
      case 128: return launch_sched<S, float, 128>(a, band, stream);
      default: return -1;
    }
  }
  return -1;
}

}  // namespace

// strides: 12 int64, the (b, t, h) element strides of q, k, v (and an unused fourth
// triple); x: the band (variant 4: x->band, causal only, T <= 65536) or the merged LUT
// (variant 5: map (heads, rows, width), mask (heads, rows, width, 2), len (heads, rows)
// over rows of 128 queries, with cell_shift as the tile LUTs have it).
extern "C" int flash_fwd_variant(int variant, int dtype, int head_dim, const void* q,
                                 const void* k, const void* v, void* out, float* lse,
                                 const long long* strides, int B, int T, int H, int causal,
                                 float scale, const Extra* x, void* stream) {
  Args a = make_args(q, k, v, nullptr, strides, B, T, H, causal, scale, x);
  a.out0 = out;
  a.lse = lse;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (variant) {
    case 4: {
      const Band* band = x == nullptr ? nullptr : x->band;
      if (band == nullptr || !causal || T > kMaxLayoutCols * 16 ||
          band->n_gtiles > kMaxGlobalTiles || band->w < 0 || band->lb <= 0)
        return -1;
      return band->cell_shift < 6 ? dispatch_sched<kBandedCells>(dtype, head_dim, a, band, s)
                                  : dispatch_sched<kBanded>(dtype, head_dim, a, band, s);
    }
    case 5:
      if (x == nullptr || x->map == nullptr) return -1;
      return dispatch_sched<kMerged>(dtype, head_dim, a, nullptr, s);
    default: return -1;
  }
}

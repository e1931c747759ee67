// A variant of the dense flash backward (dense_dkdv_kernel, dense_dq_kernel) of
// deepspeed_tpu_torch/csrc/flash_attention_sparse_bwd_sm90.cu, measured beside it by
// examples/dense_bwd_check.py --variants "pingpong 128"; nothing of the port includes it.
// The variant patch includes this file in a copy of that source, after its dense kernels, and
// sends launch_dense here.
//
// One pipe a block instead of two: a 128-row output tile (dK/dV: key rows; dQ: query rows)
// shared by the two consumer warpgroups, 64 rows each, so each visit's Q, dO, lse and delta
// (dK/dV) or K and V (dQ) is loaded once for both; the warpgroups take turns on the tensor
// cores through two named barriers (ping-pong): warpgroup c issues its output products and the
// next visit's S and dP after the other has issued its own, so one's softmax step runs while
// the other's products do.  Causal, warpgroup 1's first dK/dV visit and warpgroup 0's last dQ
// visit lie wholly above the diagonal and are masked to zero; a half tile wholly past T is
// computed and not stored.  The schedule: item w is 128-row tile w / BH (dK/dV) or
// nt2 - 1 - w / BH (dQ) of (b, h) = w % BH, dealt over the blocks in the snake.

constexpr int kPpStages = 4;

template <int D>
struct PpCfg {
  static constexpr int kTileBytes = kRows * D * 2;        // a 64-row tile
  // the item's four 64-row tiles in two buffers, the visit's two tiles and 64 rows of lse
  // and delta in the ring, 128 rows of lse and delta in two buffers (dQ), the barriers
  static constexpr size_t kSmem = 1024 + 8 * static_cast<size_t>(kTileBytes) +
                                  kPpStages * (2 * static_cast<size_t>(kTileBytes) +
                                               2 * kRows * 4) +
                                  8 * kRows * 4 + 8 * (4 + 2 * kPpStages);
};

__device__ __forceinline__ void pp_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pp_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    pp_dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   DenseParams p) {
  using C = PpCfg<D>;
  constexpr int kB = D / kBox, kS = kPpStages, kTile = C::kTileBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int wg = threadIdx.x / kWgThreads;
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;                      // [buffer][half][box][64 rows][128 bytes]
  unsigned char* sV = sK + 4 * kTile;            // the same
  unsigned char* sQ = sV + 4 * kTile;            // [stage][box][64 rows][128 bytes]
  unsigned char* sdO = sQ + kS * kTile;          // the same
  float* sLse = reinterpret_cast<float*>(sdO + kS * kTile);  // [stage][64]
  float* sDelta = sLse + kS * kRows;                         // the same
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDelta + kS * kRows);
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* full = kv_empty + 2;
  uint64_t* empty = full + kS;

  const int T = p.T, H = p.H, BH = p.BH, nt = p.nt, n_work = (T + 127) / 128 * BH;
  const int ragged = T % kRows != 0;
  auto work = [&](int r) {
    const int G = gridDim.x, x = blockIdx.x;
    return r * G + ((r & 1) ? G - 1 - x : x);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&kv_full[b], 1);
      mbar_init(&kv_empty[b], 8);  // one arrival per consumer warp of both warpgroups
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int vt = 0;
    for (int i = 0, w = work(0); w < n_work; w = work(++i)) {
      const int k2 = w / BH, bh = w - k2 * BH, b = bh / H, h = bh - b * H;
      const int kb = i & 1, kph = (i >> 1) & 1;
      if (lane == 0) {
        mbar_wait(&kv_empty[kb], kph ^ 1);
        mbar_expect_tx(&kv_full[kb], 4 * kTile);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int x = 0; x < kB; ++x) {
            const int off = (2 * kb + c) * kTile + x * kBoxBytes;
            tma_load4(sK + off, &tk, &kv_full[kb], x * kBox, h, (2 * k2 + c) * kRows, b);
            tma_load4(sV + off, &tv, &kv_full[kb], x * kBox, h, (2 * k2 + c) * kRows, b);
          }
      }
      for (int qt = p.causal ? 2 * k2 : 0; qt < nt; ++qt, ++vt) {
        const int st = vt % kS, ph = (vt / kS) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * kTile);
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;  // this warpgroup's half of the tile
  const int tid = static_cast<int>(threadIdx.x) - wg * kWgThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = (lane & 3) * 2;
  const float scale = p.scale, scale2 = p.scale2;
  const float no_bias[2] = {0.f, 0.f};
  if (c == 1) pp_arrive(1);  // warpgroup 0 takes the first turn
  int vt = 0;
  for (int i = 0, w = work(0); w < n_work; w = work(++i)) {
    const int k2 = w / BH, bh = w - k2 * BH, kt = 2 * k2 + c;
    const int kb = i & 1, kph = (i >> 1) & 1;
    int kpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) kpos[r] = kt * kRows + 16 * warp + g + 8 * r;
    float dk[kB][32], dv[kB][32];
#pragma unroll
    for (int x = 0; x < kB; ++x) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dk[x][e] = dv[x][e] = 0.f;
      fence_regs(dk[x]);
      fence_regs(dv[x]);
    }
    mbar_wait(&kv_full[kb], kph);
    const unsigned char* tK = sK + (2 * kb + c) * kTile;
    const unsigned char* tV = sV + (2 * kb + c) * kTile;
    const int q0 = p.causal ? 2 * k2 : 0, nv = nt - q0;
    float s[32], dp[32];
    uint32_t pa[4][4], da[4][4];
    int st = vt % kS;
    mbar_wait(&full[st], (vt / kS) & 1);
    pp_sync(1 + c);
    issue_sdp<D>(s, dp, tK, tV, sQ + st * kTile, sdO + st * kTile);
    pp_arrive(2 - c);
    for (int j = 0; j < nv; ++j, ++vt) {
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
      const int vm[2] = {1, qt};
      const float* sl = sLse + st * kRows;
      const float* sd = sDelta + st * kRows;
      if ((p.causal && qt <= kt) || (ragged && qt == nt - 1))
        softmax_grad<kRows, true, false>(s, dp, pa, da, sl, sd, vm, no_bias, kpos, qd, p.causal,
                                         scale, scale2, T);
      else
        softmax_grad<kRows, false, false>(s, dp, pa, da, sl, sd, vm, no_bias, kpos, qd,
                                          p.causal, scale, scale2, T);
#pragma unroll
      for (int x = 0; x < kB; ++x) {
        fence_regs(dv[x]);
        fence_regs(dk[x]);
      }
      fence_regs(pa);
      fence_regs(da);
      pp_sync(1 + c);  // this warpgroup's turn on the tensor cores
      issue_dvdk<kB>(dv, dk, pa, da, sdO + st * kTile, sQ + st * kTile);
      if (j + 1 < nv) {
        st = (vt + 1) % kS;
        mbar_wait(&full[st], ((vt + 1) / kS) & 1);
      }
      issue_sdp<D>(s, dp, tK, tV, sQ + st * kTile, sdO + st * kTile);
      pp_arrive(2 - c);  // the other's
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
      mbar_arrive(&kv_empty[kb]);
    }
    const int b = bh / H, h = bh - b * H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kpos[r] >= T) continue;
      const long long row = (static_cast<long long>(b) * T + kpos[r]) * H + h;
      store_row<kB>(p.out0 + row * D, dk, r, qd);
      store_row<kB>(p.out1 + row * D, dv, r, qd);
    }
  }
  if (c == 0) pp_sync(1);  // warpgroup 1's last arrival
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    pp_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 DenseParams p) {
  using C = PpCfg<D>;
  constexpr int kB = D / kBox, kS = kPpStages, kTile = C::kTileBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int wg = threadIdx.x / kWgThreads;
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;                      // [buffer][half][box][64 rows][128 bytes]
  unsigned char* sdO = sQ + 4 * kTile;           // the same
  unsigned char* sK = sdO + 4 * kTile;           // [stage][box][64 rows][128 bytes]
  unsigned char* sV = sK + kS * kTile;           // the same
  float* sLse = reinterpret_cast<float*>(sV + kS * kTile);  // [buffer][half][64]
  float* sDelta = sLse + 4 * kRows;                         // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sDelta + 4 * kRows);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kS;

  const int T = p.T, H = p.H, BH = p.BH, nt = p.nt, nt2 = (T + 127) / 128, n_work = nt2 * BH;
  const int ragged = T % kRows != 0;
  auto work = [&](int r) {
    const int G = gridDim.x, x = blockIdx.x;
    return r * G + ((r & 1) ? G - 1 - x : x);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1 + 64);  // the TMA issue, two stat copies a producer lane
      mbar_init(&q_empty[b], 8);
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int vt = 0;
    for (int i = 0, w = work(0); w < n_work; w = work(++i)) {
      const int y = w / BH, bh = w - y * BH, b = bh / H, h = bh - b * H, q2 = nt2 - 1 - y;
      const int qb = i & 1, qph = (i >> 1) & 1;
      const int nv = p.causal ? min(2 * q2 + 2, nt) : nt;
      mbar_wait(&q_empty[qb], qph ^ 1);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        load_stats(sLse + (2 * qb + c) * kRows, sDelta + (2 * qb + c) * kRows, p,
                   static_cast<long long>(bh) * T, (2 * q2 + c) * kRows, lane, &q_full[qb]);
      if (lane != 0) continue;
      mbar_expect_tx(&q_full[qb], 4 * kTile);
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int x = 0; x < kB; ++x) {
          const int off = (2 * qb + c) * kTile + x * kBoxBytes;
          tma_load4(sQ + off, &tq, &q_full[qb], x * kBox, h, (2 * q2 + c) * kRows, b);
          tma_load4(sdO + off, &tdo, &q_full[qb], x * kBox, h, (2 * q2 + c) * kRows, b);
        }
      for (int kt = 0; kt < nv; ++kt, ++vt) {
        const int st = vt % kS, ph = (vt / kS) & 1;
        mbar_wait(&empty[st], ph ^ 1);
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int tid = static_cast<int>(threadIdx.x) - wg * kWgThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = (lane & 3) * 2;
  const float scale = p.scale, scale2 = p.scale2;
  if (c == 1) pp_arrive(1);
  int vt = 0;
  for (int i = 0, w = work(0); w < n_work; w = work(++i)) {
    const int y = w / BH, bh = w - y * BH, q2 = nt2 - 1 - y, qt = 2 * q2 + c;
    const int qb = i & 1, qph = (i >> 1) & 1;
    int qpos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) qpos[r] = qt * kRows + 16 * warp + g + 8 * r;
    float dq[kB][32];
#pragma unroll
    for (int x = 0; x < kB; ++x) {
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[x][e] = 0.f;
      fence_regs(dq[x]);
    }
    mbar_wait(&q_full[qb], qph);
    float l2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = (2 * qb + c) * kRows + 16 * warp + g + 8 * r;
      const float lse = sLse[at];
      l2[r] = lse > kNegInf * 0.5f ? lse * kLog2e : INFINITY;
      dd[r] = sDelta[at] * scale;
    }
    const unsigned char* tQ = sQ + (2 * qb + c) * kTile;
    const unsigned char* tdO = sdO + (2 * qb + c) * kTile;
    const int nv = p.causal ? min(2 * q2 + 2, nt) : nt;
    float s[32], dp[32];
    uint32_t da[4][4];
    int st = vt % kS;
    mbar_wait(&full[st], (vt / kS) & 1);
    pp_sync(1 + c);
    issue_sdp<D>(s, dp, tQ, tdO, sK + st * kTile, sV + st * kTile);
    pp_arrive(2 - c);
    for (int kt = 0; kt < nv; ++kt, ++vt) {
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < kB; ++x) fence_regs(dq[x]);
      fence_regs(da);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(vt - 1) % kS]);
      const int vm[2] = {1, kt};
      if ((p.causal && kt >= qt) || (ragged && kt == nt - 1))
        softmax_grad_dq<kRows, true, false>(s, dp, da, nullptr, vm, l2, dd, qpos, qd, p.causal,
                                            scale, scale2, T);
      else
        softmax_grad_dq<kRows, false, false>(s, dp, da, nullptr, vm, l2, dd, qpos, qd,
                                             p.causal, scale, scale2, T);
#pragma unroll
      for (int x = 0; x < kB; ++x) fence_regs(dq[x]);
      fence_regs(da);
      pp_sync(1 + c);
      issue_dq<kB>(dq, da, sK + st * kTile);
      if (kt + 1 < nv) {
        st = (vt + 1) % kS;
        mbar_wait(&full[st], ((vt + 1) / kS) & 1);
      }
      issue_sdp<D>(s, dp, tQ, tdO, sK + st * kTile, sV + st * kTile);
      pp_arrive(2 - c);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < kB; ++x) fence_regs(dq[x]);
    fence_regs(da);
    if (lane == 0) {
      mbar_arrive(&empty[(vt - 1) % kS]);
      mbar_arrive(&q_empty[qb]);
    }
    const int b = bh / H, h = bh - b * H;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qpos[r] < T)
        store_row<kB>(p.out0 + ((static_cast<long long>(b) * T + qpos[r]) * H + h) * D, dq, r,
                      qd);
  }
  if (c == 0) pp_sync(1);
}

// one block an SM at most, one pipe a block, one block for each item at most
template <typename Kernel, typename... Args>
int launch_pp_grid(Kernel kernel, size_t smem, int n_work, cudaStream_t stream,
                   const Args&... args) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<sms < n_work ? sms : n_work, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDq>
int launch_pp(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
              const CUtensorMap& mdo, const DenseParams& p, cudaStream_t stream) {
  const int n_work = (p.T + 127) / 128 * p.BH;
  if constexpr (kDq)
    return launch_pp_grid(pp_dq_kernel<64>, PpCfg<64>::kSmem, n_work, stream, mq, mk, mv, mdo,
                          p);
  else
    return launch_pp_grid(pp_dkdv_kernel<64>, PpCfg<64>::kSmem, n_work, stream, mq, mk, mv, mdo,
                          p);
}

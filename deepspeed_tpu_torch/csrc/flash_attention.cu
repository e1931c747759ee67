// Flash attention for Hopper (sm_90a), dense path: the entries flash_fwd,
// flash_bwd_dkdv and flash_bwd_dq.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/transformer/flash_attention.py
// (dense path, no biases, no LUT):
//   flash_fwd       <- _fwd_kernel      (flash_attention.py:144-283, built by _fwd 441-613)
//   flash_bwd_dkdv  <- _bwd_dkdv_kernel (flash_attention.py:617-688, called at 842)
//   flash_bwd_dq    <- _bwd_dq_kernel   (flash_attention.py:691-753, called at 886)
// The kernels, what they compute, what bounds them and their design are in
// flash_attention.cuh; here they run with every variant flag off.  The route sends bf16 and
// fp16 at head dim 64 to flash_fwd_sm90 (flash_attention_fwd_sm90.cu) and to
// flash_bwd_dkdv_sm90 / flash_bwd_dq_sm90 (flash_attention_sparse_bwd_sm90.cu), and bf16 and
// fp16 at head dim 128 to flash_fwd_sm90; these entries keep the rest (fp32; bf16 and fp16 at
// head dim 96, and the backward at 128).
//
// dtype: 0 fp32, 1 bf16, 2 fp16.
//
// C interface for ctypes: each entry returns cudaGetLastError() after the launch
// (0 on success), or -1 for a dtype / head dim / shape it was not built for.

#include "flash_attention.cuh"

// strides: 12 int64, the (b, t, h) element strides of q, k, v and dout (dout's ignored
// by the forward).
extern "C" int flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                         void* out, float* lse, const long long* strides, int B, int T, int H,
                         int causal, float scale, void* stream) {
  Args a = make_args(q, k, v, nullptr, strides, B, T, H, causal, scale);
  a.out0 = out;
  a.lse = lse;
  return dispatch<kFwd, false, false>(dtype, head_dim, a, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkdv(int dtype, int head_dim, const void* q, const void* k,
                              const void* v, const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv, const long long* strides,
                              int B, int T, int H, int causal, float scale, void* stream) {
  Args a = make_args(q, k, v, dout, strides, B, T, H, causal, scale);
  a.out0 = dk;
  a.out1 = dv;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  return dispatch<kDkdv, false, false>(dtype, head_dim, a,
                                       reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                            const void* v, const void* dout, const float* lse,
                            const float* delta, void* dq, const long long* strides, int B,
                            int T, int H, int causal, float scale, void* stream) {
  Args a = make_args(q, k, v, dout, strides, B, T, H, causal, scale);
  a.out0 = dq;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  return dispatch<kDq, false, false>(dtype, head_dim, a, reinterpret_cast<cudaStream_t>(stream));
}

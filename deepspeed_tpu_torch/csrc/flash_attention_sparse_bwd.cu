// Flash attention for Hopper (sm_90a), the biased and block-sparse backward entries.
//
// Replaces, from deepspeed_tpu/ops/transformer/flash_attention.py (_bwd 756-891):
//   variant 1, flash_bwd_dkdv_biased / flash_bwd_dq_biased <- _bwd_dkdv_kernel (617) /
//              _bwd_dq_kernel (691) with use_kbias / use_abias
//   variant 2, flash_bwd_dkdv_lut / flash_bwd_dq_lut       <- the same kernels with
//              use_lut (dK/dV over the transposed LUT qmap/qlen, dQ over kmap/klen) and
//              the biases, each optional
// The kernels, what they compute, what bounds them and their design are in
// flash_attention.cuh.  ops/transformer/flash_attention.py sends the LUT dK/dV and dQ in bf16
// and fp16 at head dim 64 without a (T, T) score bias to flash_attention_sparse_bwd_sm90.cu
// instead.
//
// C interface for ctypes: returns cudaGetLastError() after the launch (0 on success), or
// -1 for a variant / dtype / head dim / shape it was not built for.

#include "flash_attention.cuh"

// strides: 12 int64, the (b, t, h) element strides of q, k, v and dout; x: the LUT
// (variant 2: the k-tile rows for dK/dV, the q-tile rows for dQ) and the biases.
extern "C" int flash_bwd_dkdv_variant(int variant, int dtype, int head_dim, const void* q,
                                      const void* k, const void* v, const void* dout,
                                      const float* lse, const float* delta, void* dk, void* dv,
                                      const long long* strides, int B, int T, int H,
                                      int causal, float scale, const Extra* x, void* stream) {
  Args a = make_args(q, k, v, dout, strides, B, T, H, causal, scale, x);
  a.out0 = dk;
  a.out1 = dv;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (variant) {
    case 1: return dispatch<kDkdv, false, true>(dtype, head_dim, a, s);
    case 2: return dispatch<kDkdv, true, true>(dtype, head_dim, a, s);
    default: return -1;
  }
}

extern "C" int flash_bwd_dq_variant(int variant, int dtype, int head_dim, const void* q,
                                    const void* k, const void* v, const void* dout,
                                    const float* lse, const float* delta, void* dq,
                                    const long long* strides, int B, int T, int H, int causal,
                                    float scale, const Extra* x, void* stream) {
  Args a = make_args(q, k, v, dout, strides, B, T, H, causal, scale, x);
  a.out0 = dq;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (variant) {
    case 1: return dispatch<kDq, false, true>(dtype, head_dim, a, s);
    case 2: return dispatch<kDq, true, true>(dtype, head_dim, a, s);
    default: return -1;
  }
}

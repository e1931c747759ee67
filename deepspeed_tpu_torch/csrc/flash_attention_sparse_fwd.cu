// Flash attention for Hopper (sm_90a), the biased and block-sparse forward entries.
//
// Replaces, from deepspeed_tpu/ops/transformer/flash_attention.py:
//   variant 1, flash_fwd_biased    <- _fwd_kernel with use_kbias / use_abias (144-283;
//                                     flash_attention(key_padding_bias=, attn_bias=) 923)
//   variant 2, flash_fwd_lut       <- _fwd_kernel with use_lut and the biases (the
//                                     masked sparse path, _biased_call 1221 -> _fwd 441)
//   variant 3, flash_fwd_lut_ring  <- _fwd_kernel_dma (306-415): the unbiased LUT
//                                     forward with a 3-deep ring of K/V tiles in shared
//                                     memory, slot j+2's cp.async issued before slot j
//                                     computes (one stage less for fp32 at d=128)
// The kernels, what they compute, what bounds them and their design are in
// flash_attention.cuh.
//
// C interface for ctypes: returns cudaGetLastError() after the launch (0 on success), or
// -1 for a variant / dtype / head dim / shape it was not built for.

#include "flash_attention.cuh"

// strides: 12 int64, the (b, t, h) element strides of q, k, v (and an unused fourth
// triple); x: the LUT (variants 2 and 3) and the biases (variants 1 and 2, each may be
// null).
extern "C" int flash_fwd_variant(int variant, int dtype, int head_dim, const void* q,
                                 const void* k, const void* v, void* out, float* lse,
                                 const long long* strides, int B, int T, int H, int causal,
                                 float scale, const Extra* x, void* stream) {
  Args a = make_args(q, k, v, nullptr, strides, B, T, H, causal, scale, x);
  a.out0 = out;
  a.lse = lse;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (variant) {
    case 1: return dispatch<kFwd, false, true>(dtype, head_dim, a, s);
    case 2: return dispatch<kFwd, true, true>(dtype, head_dim, a, s);
    case 3: return dispatch<kFwd, true, false, 3>(dtype, head_dim, a, s);
    default: return -1;
  }
}

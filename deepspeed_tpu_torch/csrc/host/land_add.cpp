// The streamed parameter tier's land-and-accumulate on the host, in one pass:
// dst[i] += float(bf16 src[i]) for i < n (deepspeed_tpu_torch/runtime/zero/wire.py,
// LayerWire._land_add).  Each bf16 word widens exactly; the add is one fp32
// rounding, the sum torch's mixed-dtype add_ gives, with one read of each input
// and one write (a widen into a buffer, then an add, costs a memory pass more).
// OpenMP over the elements, vectorized by the compiler (-O3 -march=native).
// Built with g++ at first use by ops/op_builder/builder.py (HostLandAddBuilder).

#include <cstdint>
#include <cstring>

extern "C" {

int ds_bf16_accumulate(const uint16_t* src, float* dst, int64_t n) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t x = static_cast<uint32_t>(src[i]) << 16;
    float f;
    std::memcpy(&f, &x, sizeof(float));
    dst[i] += f;
  }
  return 0;
}

}  // extern "C"

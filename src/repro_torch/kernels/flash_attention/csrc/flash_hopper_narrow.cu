// K8's Hopper kernel at 64 <= D <= 128 (tiling A: 128-key tiles), one
// instantiation per head dim; flash_attention.cu's flash_attention_bf16_hopper
// calls launch_narrow. Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py) with flash_attention.cu and
// flash_hopper_wide.cu. The kernel is in flash_hopper.cuh; every launch returns
// cudaGetLastError().
#include "flash_hopper.cuh"

namespace k8_hopper {

int launch_narrow(const void* q, const void* k, const void* v, void* o,
                  int B, int S, int H, int KV, int D, int window,
                  float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 80:
      return launch<80>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 96:
      return launch<96>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 112:
      return launch<112>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, B, S, H, KV, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace k8_hopper

// K8's Hopper kernel at 128 < D <= 256 (tiling B: 64-key tiles), one
// instantiation per head dim; flash_attention.cu's flash_attention_bf16_hopper
// calls launch_wide. Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py) with flash_attention.cu and
// flash_hopper_narrow.cu. The kernel is in flash_hopper.cuh; every launch
// returns cudaGetLastError().
#include "flash_hopper.cuh"

namespace k8_hopper {

int launch_wide(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KV, int D, int window, float scale,
                cudaStream_t stream) {
  switch (D) {
    case 144:
      return launch<144>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 160:
      return launch<160>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 176:
      return launch<176>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 192:
      return launch<192>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 208:
      return launch<208>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 224:
      return launch<224>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 240:
      return launch<240>(q, k, v, o, B, S, H, KV, window, scale, stream);
    case 256:
      return launch<256>(q, k, v, o, B, S, H, KV, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace k8_hopper

// Kernel and C entry point of the long-sequence attention forward (device
// code and its design notes: flash_attn.cuh). Built with nvcc for sm_90a
// into the port's kernel library and called through ctypes
// (vggsfm_tpu_torch/ops/_build.py `load_library`,
// vggsfm_tpu_torch/ops/attention.py).
//
// The entry point takes device pointers to bf16 q, k, v (BH, L, 64) and
// out (BH / H, L, H, 64), the shapes and a cudaStream_t. It launches once
// on that stream, allocates nothing, does not synchronise, and returns 0
// on success, -1 for shapes the kernel does not take, -7 for a pointer not
// 16-byte aligned, or the cudaError_t of the launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attn.cuh"

namespace vfa {

__global__ void __launch_bounds__(kThreads)
    attn_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int L, int H, float scale) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  attn_body(q, k, v, out, L, H, scale, smem);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace vfa

extern "C" {

int vf_flash_attn(const void* q, const void* k, const void* v, void* out,
                  int BH, int L, int H, int D, float scale, void* stream) {
  using bf = __nv_bfloat16;
  if (D != vfa::kD || L < 1 || BH < 1 || H < 1 || BH % H != 0
      || BH > 65535)
    return -1;
  if (!(vfa::aligned16(q) && vfa::aligned16(k) && vfa::aligned16(v)
        && vfa::aligned16(out)))
    return -7;
  const dim3 grid((L + vfa::kBM - 1) / vfa::kBM, BH);
  vfa::attn_kernel<<<grid, vfa::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<bf*>(out), L, H, scale);
  return int(cudaGetLastError());
}

}  // extern "C"

// Kernel and C entry point of the long-sequence attention forward (device
// code and its design notes: flash_attn.cuh). Built with nvcc for sm_90a
// into the port's kernel library and called through ctypes
// (vggsfm_tpu_torch/ops/_build.py `load_library`,
// vggsfm_tpu_torch/ops/attention.py).
//
// The entry point takes device pointers to bf16 q, k, v (BH, L, 64) and
// out (BH / H, L, H, 64), the shapes and a cudaStream_t. It builds the
// three tensor maps the kernel's TMA loads read (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint so the library needs no -lcuda),
// launches once on that stream, allocates nothing, does not synchronise,
// and returns 0 on success, -1 for shapes the kernel does not take, -7 for
// a pointer not 16-byte aligned, or the cudaError_t of the launch (or of
// finding the driver's encoder).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_attn.cuh"

namespace vfa {

__global__ void __launch_bounds__(kThreads, 1)
    attn_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int L, int H, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  attn_body(&tq, &tk, &tv, out, L, H, scale, smem);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !p)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// (BH, L, 64) bf16 at p as a 3-d map, boxes of `rows` rows of one head,
// 128-byte swizzled, rows past L read as zeros
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* p, int BH,
              int L, int rows) {
  const cuuint64_t dim[3] = {cuuint64_t(kD), cuuint64_t(L), cuuint64_t(BH)};
  const cuuint64_t stride[2] = {cuuint64_t(kRowBytes),
                                cuuint64_t(L) * kRowBytes};
  const cuuint32_t box[3] = {cuuint32_t(kD), cuuint32_t(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
             dim, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  vfa::EncodeTiled enc;
  cudaError_t err = vfa::encoder(&enc);
  if (err != cudaSuccess) return int(err);
  CUtensorMap tq, tk, tv;
  if (!(vfa::make_map(enc, &tq, q, BH, L, vfa::kWM)
        && vfa::make_map(enc, &tk, k, BH, L, vfa::kBN)
        && vfa::make_map(enc, &tv, v, BH, L, vfa::kBN)))
    return -1;
  err = cudaFuncSetAttribute(vfa::attn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             vfa::kSmemBytes);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((L + vfa::kBM - 1) / vfa::kBM, BH);
  vfa::attn_kernel<<<grid, vfa::kThreads, vfa::kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf*>(out), L, H, scale);
  return int(cudaGetLastError());
}

}  // extern "C"

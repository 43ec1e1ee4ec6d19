// Kernels and C entry point of the correlation-sampling op (device code and
// its design notes: corr_sample.cuh). Built with nvcc for sm_90a into the
// port's shared library and called through ctypes
// (vggsfm_tpu_torch/ops/_build.py, vggsfm_tpu_torch/ops/corr.py).
//
// The entry point takes the dtype of the map and the features (0 = float32,
// 1 = bfloat16), device pointers, the shapes and a cudaStream_t. It launches
// one block per (frame, track) on that stream, allocates nothing, does not
// synchronise, and returns 0 on success, a negative code for inputs the
// kernel does not take (check_shape), or the cudaError_t of the launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "corr_sample.cuh"

namespace vcorr {

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    corr_kernel(const T* __restrict__ fmap, const float* __restrict__ coords,
                const T* __restrict__ feats, float* __restrict__ out, int N,
                int H, int W, int C, int radius) {
  extern __shared__ __align__(16) unsigned char corr_smem[];
  corr_body<T, VEC>(fmap, coords, feats, out, N, H, W, C, radius, corr_smem);
}

template <typename T, bool VEC>
int launch(const void* fmap, const void* coords, const void* feats, void* out,
           int S, int N, int H, int W, int C, int radius,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(C, radius, VEC ? int(16 / sizeof(T)) : 1);
  corr_kernel<T, VEC><<<S * N, kThreads, smem, stream>>>(
      static_cast<const T*>(fmap), static_cast<const float*>(coords),
      static_cast<const T*>(feats), static_cast<float*>(out), N, H, W, C,
      radius);
  return int(cudaGetLastError());
}

template <typename T>
int launch_any(const void* fmap, const void* coords, const void* feats,
               void* out, int S, int N, int H, int W, int C, int radius,
               cudaStream_t stream) {
  const bool vec = C % int(16 / sizeof(T)) == 0
                   && reinterpret_cast<uintptr_t>(fmap) % 16 == 0;
  if (vec)
    return launch<T, true>(fmap, coords, feats, out, S, N, H, W, C, radius,
                           stream);
  return launch<T, false>(fmap, coords, feats, out, S, N, H, W, C, radius,
                          stream);
}

}  // namespace vcorr

extern "C" {

int vf_corr_sample(int dtype, const void* fmap, const void* coords,
                   const void* feats, void* out, int S, int N, int H, int W,
                   int C, int radius, void* stream) {
  const int bad = vcorr::check_shape(S, N, H, W, C, radius);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vcorr::launch_any<float>(fmap, coords, feats, out, S, N, H, W, C,
                                    radius, st);
  if (dtype != 1) return -100;
  return vcorr::launch_any<__nv_bfloat16>(fmap, coords, feats, out, S, N, H,
                                          W, C, radius, st);
}

// Shared memory one block takes, for reports and tests.
size_t vf_corr_smem_bytes(int C, int radius, int tsize) {
  return vcorr::smem_bytes(C, radius, C % (16 / tsize) == 0 ? 16 / tsize : 1);
}

}  // extern "C"

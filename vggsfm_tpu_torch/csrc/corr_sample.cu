// Kernels and C entry point of the correlation-sampling op (device code and
// its design notes: corr_sample.cuh). Built with nvcc for sm_90a into the
// port's shared library and called through ctypes
// (vggsfm_tpu_torch/ops/_build.py, vggsfm_tpu_torch/ops/corr.py).
//
// The entry point takes the dtype of the maps and the features (0 =
// float32, 1 = bfloat16), whether the output is bfloat16, the level table
// (L device pointers, L (H, W) pairs, L (frame, row, column, channel)
// strides in elements: host arrays), device pointers, the shapes and a
// cudaStream_t. It launches once for all levels, one warp per (track,
// level), on that stream; it allocates nothing, does not synchronise, and
// returns 0 on success, a negative code for inputs the kernel does not
// take (check_shape, plan), or the cudaError_t of the launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "corr_sample.cuh"

namespace vcorr {

template <typename T, int V, bool ONE, bool FLAT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    corr_kernel(const Args a) {
  extern __shared__ __align__(16) float corr_smem[];
  corr_body<T, V, ONE, FLAT>(a, corr_smem);
}

template <typename T, int V, bool ONE, bool FLAT>
int launch(Args a, cudaStream_t stream) {
  size_t smem;
  const unsigned blocks = geometry(a, FLAT, &smem);
  corr_kernel<T, V, ONE, FLAT><<<blocks, a.wpb * 32, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_variant(const Args& a, Variant v, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  switch (v) {
    case kFlat: return launch<T, 1, false, true>(a, stream);
    case kVecOne: return launch<T, kVec, true, false>(a, stream);
    case kScalarOne: return launch<T, 1, true, false>(a, stream);
    default: return launch<T, 1, false, false>(a, stream);
  }
}

}  // namespace vcorr

extern "C" {

int vf_corr_sample(int dtype, int out_bf16, int L, const long long* ptrs,
                   const int* hw, const long long* strides,
                   const void* coords, const void* feats, long long sfF,
                   long long sfN, void* out, int F, int N, int C,
                   int radius, void* stream) {
  vcorr::Args a;
  vcorr::Variant v;
  const int rc = vcorr::make_args(a, &v, dtype, out_bf16, L, ptrs, hw,
                                  strides, coords, feats, sfF, sfN, out, F,
                                  N, C, radius);
  if (rc) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return vcorr::launch_variant<float>(a, v, st);
  return vcorr::launch_variant<__nv_bfloat16>(a, v, st);
}

// The variant a call with these levels takes (vcorr::Variant), or the
// negative code of plan; for reports and tests.
int vf_corr_variant(int dtype, int L, const long long* ptrs, const int* hw,
                    const long long* strides, int C) {
  vcorr::Args a{};
  a.L = L;
  a.C = C;
  vcorr::Variant v;
  const int rc = vcorr::plan(a, ptrs, hw, strides, dtype == 0 ? 4 : 2, &v);
  return rc ? rc : int(v);
}

// Shared memory one block takes, for reports and tests.
size_t vf_corr_smem_bytes(int C, int radius, int flat) {
  return size_t(vcorr::warps_per_block(C, radius, flat != 0))
         * vcorr::warp_floats(C, radius, flat != 0) * sizeof(float);
}

}  // extern "C"

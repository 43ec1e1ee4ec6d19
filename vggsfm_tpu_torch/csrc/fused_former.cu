// Kernels and C entry points of the fused former ops (device code and its
// design notes: fused_former.cuh). Built with nvcc for sm_90a into a shared
// library and called through ctypes (vggsfm_tpu_torch/ops/_build.py,
// vggsfm_tpu_torch/ops/fused_mlp.py).
//
// Each entry point takes the working dtype (0 = float32, 1 = bfloat16),
// device pointers, the shapes and a cudaStream_t. It launches on that
// stream, allocates nothing, does not synchronise, and returns 0 on
// success, a negative code for inputs the kernel does not take (see
// check_*_shape; -7: a weight or scratch tile not 32-byte aligned for the
// tensor cores), or the cudaError_t of the launch. bf16 inputs whose
// dimensions the 16-wide tensor-core tiles divide take the tensor-core
// instantiation (use_tc).
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_former.cuh"

namespace vf {

template <typename T, bool TC, class TL>
__global__ void __launch_bounds__(kThreads, 1)
    ln_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ b1, const T* __restrict__ w2,
                  const T* __restrict__ b2, T* __restrict__ out, int R, int C,
                  int M) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln_mlp_body<T, TC, TL>(x, w1, b1, w2, b2, out, R, C, M, smem);
}

template <typename T, bool TC>
__global__ void __launch_bounds__(kThreads, 1)
    block_kernel(const T* __restrict__ x, const T* __restrict__ w_in,
                 const T* __restrict__ b_in, const T* __restrict__ w_out,
                 const T* __restrict__ b_out, const T* __restrict__ w1,
                 const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ b2, T* __restrict__ out, int R, int C,
                 int M, int L, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  block_body<T, TC>(x, w_in, b_in, w_out, b_out, w1, b1, w2, b2, out, R, C,
                    M, L, H, smem);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    attn_ln_kernel(const T* __restrict__ x, T* xs, int R, int C, int L,
                   int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn_ln_body<T, BM>(x, xs, R, C, L, H, smem);
}

template <typename T, bool TC, int BM>
__global__ void __launch_bounds__(kThreads)
    attn_heads_kernel(const T* __restrict__ w_in, const T* __restrict__ b_in,
                      const T* xs, T* os, int R, int C, int L, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn_heads_body<T, TC, BM>(w_in, b_in, xs, os, R, C, L, H, smem);
}

template <typename T, bool TC, int BM>
__global__ void __launch_bounds__(kThreads)
    attn_out_kernel(const T* __restrict__ x, const T* __restrict__ w_out,
                    const T* __restrict__ b_out, T* __restrict__ out,
                    const T* os, int R, int C, int L, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn_out_body<T, TC, BM>(x, w_out, b_out, out, os, R, C, L, H, smem);
}

inline bool aligned32(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 32 == 0;
}

template <typename T, bool TC, class TL>
int launch_ln_mlp(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* out, int R, int C,
                  int M, cudaStream_t stream) {
  if (TC && !(aligned32(w1) && aligned32(w2))) return -7;
  const size_t smem = ln_mlp_smem_bytes(C, M, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      ln_mlp_kernel<T, TC, TL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  const int grid = (R + TL::BM - 1) / TL::BM;
  ln_mlp_kernel<T, TC, TL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), R, C, M);
  return int(cudaGetLastError());
}

template <typename T, bool TC>
int launch_block(const void* x, const void* w_in, const void* b_in,
                 const void* w_out, const void* b_out, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* out,
                 int R, int C, int M, int L, int H, cudaStream_t stream) {
  if (TC && !(aligned32(w_in) && aligned32(w_out) && aligned32(w1)
              && aligned32(w2)))
    return -7;
  const size_t smem = block_smem_bytes(C, H, L, M, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      block_kernel<T, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  const int br = block_rows(L);
  const int grid = (R + br - 1) / br;
  block_kernel<T, TC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_in),
      static_cast<const T*>(b_in), static_cast<const T*>(w_out),
      static_cast<const T*>(b_out), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), R, C, M, L, H);
  return int(cudaGetLastError());
}

template <typename T, bool TC>
int launch_ln_mlp_tile(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int R,
                       int C, int M, cudaStream_t stream) {
  if (C <= kMaxC)
    return launch_ln_mlp<T, TC, NarrowTile>(x, w1, b1, w2, b2, out, R, C, M,
                                            stream);
  return launch_ln_mlp<T, TC, WideTile>(x, w1, b1, w2, b2, out, R, C, M,
                                        stream);
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <typename T, bool TC, int BM>
int launch_attn(const void* x, const void* w_in, const void* b_in,
                const void* w_out, const void* b_out, void* out, void* xs,
                void* os, int R, int C, int L, int H, cudaStream_t stream) {
  if (TC && !(aligned32(w_in) && aligned32(w_out) && aligned32(xs)
              && aligned32(os)))
    return -7;
  const size_t smem = attn_smem_bytes(C, H, L, sizeof(T));
  int e = allow_smem(attn_ln_kernel<T, BM>, smem);
  if (!e) e = allow_smem(attn_heads_kernel<T, TC, BM>, smem);
  if (!e) e = allow_smem(attn_out_kernel<T, TC, BM>, smem);
  if (e) return e;
  const int br = block_rows(L, BM);
  const int tiles = (R + br - 1) / br;
  const T* xt = static_cast<const T*>(x);
  attn_ln_kernel<T, BM><<<tiles, kThreads, smem, stream>>>(
      xt, static_cast<T*>(xs), R, C, L, H);
  if ((e = int(cudaGetLastError()))) return e;
  attn_heads_kernel<T, TC, BM><<<dim3(tiles, H), kThreads, smem, stream>>>(
      static_cast<const T*>(w_in), static_cast<const T*>(b_in),
      static_cast<const T*>(xs), static_cast<T*>(os), R, C, L, H);
  if ((e = int(cudaGetLastError()))) return e;
  attn_out_kernel<T, TC, BM>
      <<<dim3(tiles, (C + kAttnNC - 1) / kAttnNC), kThreads, smem, stream>>>(
          xt, static_cast<const T*>(w_out), static_cast<const T*>(b_out),
          static_cast<T*>(out), static_cast<const T*>(os), R, C, L, H);
  return int(cudaGetLastError());
}

template <typename T, bool TC>
int launch_attn_rows(const void* x, const void* w_in, const void* b_in,
                     const void* w_out, const void* b_out, void* out,
                     void* xs, void* os, int R, int C, int L, int H,
                     cudaStream_t stream) {
  const int BM = attn_tile_rows(L);
  if (BM == 16)
    return launch_attn<T, TC, 16>(x, w_in, b_in, w_out, b_out, out, xs, os, R,
                                  C, L, H, stream);
  if (BM == 32)
    return launch_attn<T, TC, 32>(x, w_in, b_in, w_out, b_out, out, xs, os, R,
                                  C, L, H, stream);
  return launch_attn<T, TC, 64>(x, w_in, b_in, w_out, b_out, out, xs, os, R,
                                C, L, H, stream);
}

}  // namespace vf

extern "C" {

int vf_fused_ln_mlp(int dtype, const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, int R, int C,
                    int M, void* stream) {
  const int bad = vf::check_mlp_shape(R, C, M);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vf::launch_ln_mlp_tile<float, false>(x, w1, b1, w2, b2, out, R, C,
                                                M, st);
  if (dtype != 1) return -100;
  if (vf::use_tc(2, C, 16, M))
    return vf::launch_ln_mlp_tile<__nv_bfloat16, true>(x, w1, b1, w2, b2, out,
                                                       R, C, M, st);
  return vf::launch_ln_mlp_tile<__nv_bfloat16, false>(x, w1, b1, w2, b2, out,
                                                      R, C, M, st);
}

int vf_fused_block(int dtype, const void* x, const void* w_in,
                   const void* b_in, const void* w_out, const void* b_out,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int R, int C, int M, int L,
                   int H, void* stream) {
  const int bad = vf::check_block_shape(R, C, M, L, H);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vf::launch_block<float, false>(x, w_in, b_in, w_out, b_out, w1, b1,
                                          w2, b2, out, R, C, M, L, H, st);
  if (dtype != 1) return -100;
  if (vf::use_tc(2, C, C / H, M))
    return vf::launch_block<__nv_bfloat16, true>(
        x, w_in, b_in, w_out, b_out, w1, b1, w2, b2, out, R, C, M, L, H, st);
  return vf::launch_block<__nv_bfloat16, false>(
      x, w_in, b_in, w_out, b_out, w1, b1, w2, b2, out, R, C, M, L, H, st);
}

// xs, os: scratch of vf_attn_scratch_rows(R, L) * C elements each.
// Launches the attention half's three kernels (fused_former.cuh).
int vf_fused_ln_attn(int dtype, const void* x, const void* w_in,
                     const void* b_in, const void* w_out, const void* b_out,
                     void* out, void* xs, void* os, int R, int C, int L,
                     int H, void* stream) {
  const int bad = vf::check_attn_shape(R, C, L, H);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vf::launch_attn_rows<float, false>(x, w_in, b_in, w_out, b_out,
                                              out, xs, os, R, C, L, H, st);
  if (dtype != 1) return -100;
  if (vf::use_tc(2, C, C / H, 16))
    return vf::launch_attn_rows<__nv_bfloat16, true>(
        x, w_in, b_in, w_out, b_out, out, xs, os, R, C, L, H, st);
  return vf::launch_attn_rows<__nv_bfloat16, false>(
      x, w_in, b_in, w_out, b_out, out, xs, os, R, C, L, H, st);
}

long vf_attn_scratch_rows(int R, int L) { return vf::attn_scratch_rows(R, L); }

// Shared memory one block of each kernel takes, for reports and tests.
size_t vf_block_smem_bytes(int C, int H, int L, int M, int tsize) {
  return vf::block_smem_bytes(C, H, L, M, tsize);
}

size_t vf_ln_mlp_smem_bytes(int C, int M, int tsize) {
  return vf::ln_mlp_smem_bytes(C, M, tsize);
}

size_t vf_attn_smem_bytes(int C, int H, int L, int tsize) {
  return vf::attn_smem_bytes(C, H, L, tsize);
}

}  // extern "C"

// Kernels and C entry points of the fused former ops (device code and its
// design notes: fused_former.cuh). Built with nvcc for sm_90a into a shared
// library and called through ctypes (vggsfm_tpu_torch/ops/_build.py,
// vggsfm_tpu_torch/ops/fused_mlp.py).
//
// Each entry point takes the working dtype (0 = float32, 1 = bfloat16),
// device pointers, the shapes and a cudaStream_t. It launches on that
// stream, allocates nothing (scratch arrays are the caller's), does not
// synchronise, and returns 0 on success, a negative code for inputs the
// kernels do not take (see check_*_shape; -7: an array not aligned, 32
// bytes for the ring path's weights, 16 for the 16-byte copies; -9: the
// three-kernel MLP path's scratch missing; -100: a dtype the kernel does
// not take, where the block takes bfloat16 only), or the cudaError_t of a
// launch, each checked as it is made.
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "fused_former.cuh"

namespace vf {

__global__ void __launch_bounds__(kThreads, 1)
    ln_mlp_kernel(const bf* __restrict__ x, const bf* __restrict__ w1,
                  const bf* __restrict__ b1, const bf* __restrict__ w2,
                  const bf* __restrict__ b2, bf* __restrict__ out, int R,
                  int C, int M) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln_mlp_body(x, w1, b1, w2, b2, out, R, C, M, smem);
}

__global__ void __launch_bounds__(kThreads, 1)
    block_kernel(const bf* __restrict__ x, const bf* __restrict__ w_in,
                 const bf* __restrict__ b_in,
                 const bf* __restrict__ w_out,
                 const bf* __restrict__ b_out, const bf* __restrict__ w1,
                 const bf* __restrict__ b1, const bf* __restrict__ w2,
                 const bf* __restrict__ b2, bf* __restrict__ out, int R,
                 int C, int M, int L, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  block_body(x, w_in, b_in, w_out, b_out, w1, b1, w2, b2, out, R, C, M, L, H,
             smem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_rows_kernel(const T* __restrict__ x, T* __restrict__ xn,
                   float* __restrict__ stats, int R, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln_rows_body<T>(x, xn, stats, R, C, smem);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads, kGBlocksPerSM)
    tc_gemm_kernel(const __nv_bfloat16* __restrict__ A, int lda,
                   const __nv_bfloat16* __restrict__ W, int ldw, int R,
                   int N, int K, Epi<__nv_bfloat16> epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  tc_gemm_body<KIND>(A, lda, W, ldw, R, N, K, epi, smem);
}

template <typename T, int RT, int CT, int KIND>
__global__ void __launch_bounds__(kThreads)
    cc_gemm_kernel(const T* __restrict__ A, int lda, const T* __restrict__ W,
                   int ldw, int R, int N, int K, Epi<T> epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  cc_gemm_body<T, RT, CT, KIND>(A, lda, W, ldw, R, N, K, epi, smem);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    attn_core_kernel(const T* __restrict__ qkv, T* __restrict__ os, int R,
                     int C, int L, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  attn_core_body<T, BM>(qkv, os, R, C, L, H, smem);
}

// Raises a kernel's dynamic shared-memory limit to smem on the current
// device, once: later launches skip cudaFuncSetAttribute.
inline int allow_smem_fn(const void* fn, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> raised;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  std::lock_guard<std::mutex> lock(mu);
  size_t& done = raised[{fn, dev}];
  if (done >= smem) return 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(smem));
  if (e != cudaSuccess) return int(e);
  done = smem;
  return 0;
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  return allow_smem_fn(reinterpret_cast<const void*>(kernel), smem);
}

inline bool aligned32(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 32 == 0;
}

// The ring path's ln_mlp (C <= 384).
int launch_ln_mlp(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* out, int R, int C,
                  int M, cudaStream_t stream) {
  if (!(aligned32(w1) && aligned32(w2))) return -7;
  const size_t smem = ln_mlp_smem_bytes(C);
  const int e = allow_smem(ln_mlp_kernel, smem);
  if (e) return e;
  const int grid = cdiv(R, NarrowTile::BM);
  ln_mlp_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(w1),
      static_cast<const bf*>(b1), static_cast<const bf*>(w2),
      static_cast<const bf*>(b2), static_cast<bf*>(out), R, C, M);
  return int(cudaGetLastError());
}

int launch_block(const void* x, const void* w_in, const void* b_in,
                 const void* w_out, const void* b_out, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* out,
                 int R, int C, int M, int L, int H, cudaStream_t stream) {
  if (!(aligned32(w_in) && aligned32(w_out) && aligned32(w1)
        && aligned32(w2)))
    return -7;
  const size_t smem = block_smem_bytes(C, H, L);
  const int e = allow_smem(block_kernel, smem);
  if (e) return e;
  const int grid = cdiv(R, block_rows(L));
  block_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(w_in),
      static_cast<const bf*>(b_in), static_cast<const bf*>(w_out),
      static_cast<const bf*>(b_out), static_cast<const bf*>(w1),
      static_cast<const bf*>(b1), static_cast<const bf*>(w2),
      static_cast<const bf*>(b2), static_cast<bf*>(out), R, C, M, L, H);
  return int(cudaGetLastError());
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch_ln_rows(const void* x, void* xn, float* stats, int R, int C,
                   cudaStream_t stream) {
  ln_rows_kernel<T><<<cdiv(R, kLnRows), kThreads, ln_rows_smem_bytes(),
                      stream>>>(static_cast<const T*>(x), static_cast<T*>(xn),
                                stats, R, C);
  return int(cudaGetLastError());
}

// The wide MLP path: xn = LN(x), h = gelu(xn w1^T + b1), out = x + (h w2^T
// + b2); xn (R, C) and h (R, M) are the caller's bf16 scratch
// (split_mlp_scratch_bytes).
int launch_wide_mlp(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, void* scratch,
                    int R, int C, int M, cudaStream_t stream) {
  if (!scratch) return -9;
  void* xn = scratch;
  void* h = static_cast<bf*>(scratch) + size_t(R) * C;
  if (!(aligned16(x) && aligned16(w1) && aligned16(w2) && aligned16(out)
        && aligned16(xn) && aligned16(h)))
    return -7;
  const size_t smem = tc_gemm_smem_bytes();
  int e = allow_smem(tc_gemm_kernel<kEpiGelu>, smem);
  if (!e) e = allow_smem(tc_gemm_kernel<kEpiResid>, smem);
  if (!e) e = launch_ln_rows<bf>(x, xn, nullptr, R, C, stream);
  if (e) return e;
  const Epi<bf> fc1{static_cast<const bf*>(b1), nullptr, nullptr,
                    static_cast<bf*>(h), M};
  tc_gemm_kernel<kEpiGelu><<<dim3(cdiv(M, kGN), cdiv(R, kGM)), kThreads,
                             smem, stream>>>(static_cast<const bf*>(xn), C,
                                             static_cast<const bf*>(w1), C,
                                             R, M, C, fc1);
  if ((e = int(cudaGetLastError()))) return e;
  const Epi<bf> fc2{static_cast<const bf*>(b2), static_cast<const bf*>(x),
                    nullptr, static_cast<bf*>(out), C};
  tc_gemm_kernel<kEpiResid><<<dim3(cdiv(C, kGN), cdiv(R, kGM)), kThreads,
                              smem, stream>>>(static_cast<const bf*>(h), M,
                                              static_cast<const bf*>(w2), M,
                                              R, C, M, fc2);
  return int(cudaGetLastError());
}

// One cc_gemm_body product (R x N, depth K) at the tile cc_tile picks.
template <typename T, int KIND>
int launch_cc_gemm(const T* A, const T* W, int R, int N, int K,
                   const Epi<T>& epi, int sms, cudaStream_t stream) {
  const int tile = cc_tile(R, N, sms), rt = tile / 10, ct = tile % 10;
  const size_t smem = cc_gemm_smem_bytes(rt, ct);
  const dim3 grid(cdiv(N, 16 * ct), cdiv(R, 16 * rt));
  int e;
  if (tile == 44) {
    if ((e = allow_smem(cc_gemm_kernel<T, 4, 4, KIND>, smem))) return e;
    cc_gemm_kernel<T, 4, 4, KIND><<<grid, kThreads, smem, stream>>>(
        A, K, W, K, R, N, K, epi);
  } else if (tile == 41) {
    if ((e = allow_smem(cc_gemm_kernel<T, 4, 1, KIND>, smem))) return e;
    cc_gemm_kernel<T, 4, 1, KIND><<<grid, kThreads, smem, stream>>>(
        A, K, W, K, R, N, K, epi);
  } else {
    if ((e = allow_smem(cc_gemm_kernel<T, 1, 1, KIND>, smem))) return e;
    cc_gemm_kernel<T, 1, 1, KIND><<<grid, kThreads, smem, stream>>>(
        A, K, W, K, R, N, K, epi);
  }
  return int(cudaGetLastError());
}

// The f32 MLP path: the wide path's three steps with the two products on
// cc_gemm_body; xn (R, C) and h (R, M) are the caller's f32 scratch
// (split_mlp_scratch_bytes).
int launch_cc_mlp(const void* x, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* out, void* scratch,
                  int R, int C, int M, cudaStream_t stream) {
  if (!scratch) return -9;
  float* xn = static_cast<float*>(scratch);
  float* h = xn + size_t(R) * C;
  if (!(aligned16(x) && aligned16(w1) && aligned16(w2) && aligned16(out)
        && aligned16(xn) && aligned16(h)))
    return -7;
  int dev = 0, sms = 0;
  int e = int(cudaGetDevice(&dev));
  if (!e)
    e = int(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev));
  if (!e) e = launch_ln_rows<float>(x, xn, nullptr, R, C, stream);
  if (e) return e;
  const Epi<float> fc1{static_cast<const float*>(b1), nullptr, nullptr, h,
                       M};
  e = launch_cc_gemm<float, kEpiGelu>(xn, static_cast<const float*>(w1), R,
                                      M, C, fc1, sms, stream);
  if (e) return e;
  const Epi<float> fc2{static_cast<const float*>(b2),
                       static_cast<const float*>(x), nullptr,
                       static_cast<float*>(out), C};
  return launch_cc_gemm<float, kEpiResid>(h, static_cast<const float*>(w2), R,
                                          C, M, fc2, sms, stream);
}

template <typename T, int BM>
int launch_attn_core(const T* qkv, T* os, int R, int C, int L, int H,
                     cudaStream_t stream) {
  const size_t smem = attn_core_smem_bytes(C, H, L, sizeof(T));
  const int e = allow_smem(attn_core_kernel<T, BM>, smem);
  if (e) return e;
  attn_core_kernel<T, BM>
      <<<dim3(cdiv(R, block_rows(L, BM)), H), kThreads, smem, stream>>>(
          qkv, os, R, C, L, H);
  return int(cudaGetLastError());
}

// The attention half's four kernels: xs = LN(x) and the row statistics;
// qkv = xs w_in^T + b_in; the attention core into os; out = LN(x) +
// (os w_out^T + b_out). xs, qkv, os and the statistics: the caller's
// scratch (attn_scratch_bytes).
template <typename T>
int launch_attn(const void* x, const void* w_in, const void* b_in,
                const void* w_out, const void* b_out, void* out,
                void* scratch, int R, int C, int L, int H, int sms,
                cudaStream_t stream) {
  if (!(aligned16(x) && aligned16(w_in) && aligned16(w_out)
        && aligned16(scratch)))
    return -7;
  const AttnScratch sc = attn_scratch_carve(scratch, R, C, sizeof(T));
  const T* xt = static_cast<const T*>(x);
  T* xst = static_cast<T*>(sc.xs);
  T* qt = static_cast<T*>(sc.qkv);
  T* ot = static_cast<T*>(sc.os);
  float* st = sc.stats;
  int e = launch_ln_rows<T>(x, xst, st, R, C, stream);
  if (e) return e;
  const Epi<T> proj{static_cast<const T*>(b_in), nullptr, nullptr, qt,
                    3 * C};
  e = launch_cc_gemm<T, kEpiBias>(xst, static_cast<const T*>(w_in), R, 3 * C,
                                  C, proj, sms, stream);
  if (e) return e;
  const int BM = attn_tile_rows(L);
  e = BM == 16   ? launch_attn_core<T, 16>(qt, ot, R, C, L, H, stream)
      : BM == 32 ? launch_attn_core<T, 32>(qt, ot, R, C, L, H, stream)
                 : launch_attn_core<T, 64>(qt, ot, R, C, L, H, stream);
  if (e) return e;
  const Epi<T> res{static_cast<const T*>(b_out), xt, st,
                   static_cast<T*>(out), C};
  return launch_cc_gemm<T, kEpiNormResid>(ot, static_cast<const T*>(w_out), R,
                                          C, C, res, sms, stream);
}

}  // namespace vf

extern "C" {

// scratch: vf_ln_mlp_scratch_bytes of device memory (the three-kernel
// path's xn and h; null where that is 0).
int vf_fused_ln_mlp(int dtype, const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, void* scratch,
                    int R, int C, int M, void* stream) {
  const int bad = vf::check_mlp_shape(R, C, M);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vf::launch_cc_mlp(x, w1, b1, w2, b2, out, scratch, R, C, M, st);
  if (dtype != 1) return -100;
  if (vf::split_mlp(2, C))
    return vf::launch_wide_mlp(x, w1, b1, w2, b2, out, scratch, R, C, M, st);
  return vf::launch_ln_mlp(x, w1, b1, w2, b2, out, R, C, M, st);
}

// Kernels one vf_fused_ln_mlp call launches: 3 in f32 and on the wide
// path, else 1.
int vf_ln_mlp_kernels(int dtype, int C) {
  return vf::ln_mlp_kernels(dtype == 1 ? 2 : 4, C);
}

size_t vf_ln_mlp_scratch_bytes(int dtype, int R, int C, int M) {
  return vf::split_mlp_scratch_bytes(dtype == 1 ? 2 : 4, R, C, M);
}

int vf_fused_block(int dtype, const void* x, const void* w_in,
                   const void* b_in, const void* w_out, const void* b_out,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int R, int C, int M, int L,
                   int H, void* stream) {
  const int bad = vf::check_block_shape(R, C, M, L, H);
  if (bad) return bad;
  if (dtype != 1) return -100;
  return vf::launch_block(x, w_in, b_in, w_out, b_out, w1, b1, w2, b2, out, R,
                          C, M, L, H, static_cast<cudaStream_t>(stream));
}

// Launches the attention half's four kernels (fused_former.cuh). scratch:
// vf_attn_scratch_bytes of device memory. sms: the card's SM count, which
// sets the GEMM tiles (cc_tile).
int vf_fused_ln_attn(int dtype, const void* x, const void* w_in,
                     const void* b_in, const void* w_out, const void* b_out,
                     void* out, void* scratch, int R, int C, int L, int H,
                     int sms, void* stream) {
  const int bad = vf::check_attn_shape(R, C, L, H);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vf::launch_attn<float>(x, w_in, b_in, w_out, b_out, out, scratch,
                                  R, C, L, H, sms, st);
  if (dtype != 1) return -100;
  return vf::launch_attn<__nv_bfloat16>(x, w_in, b_in, w_out, b_out, out,
                                        scratch, R, C, L, H, sms, st);
}

size_t vf_attn_scratch_bytes(int dtype, int R, int C) {
  return vf::attn_scratch_bytes(R, C, dtype == 1 ? 2 : 4);
}

// The tile of an (R x N) product of the attention half, as 10 RT + CT.
int vf_cc_tile(int R, int N, int sms) { return vf::cc_tile(R, N, sms); }

// Shared memory one block of each kernel takes, for reports and tests.
size_t vf_block_smem_bytes(int C, int H, int L) {
  return vf::block_smem_bytes(C, H, L);
}

size_t vf_ln_mlp_smem_bytes(int C) { return vf::ln_mlp_smem_bytes(C); }

size_t vf_attn_smem_bytes(int C, int H, int L, int tsize) {
  return vf::attn_smem_bytes(C, H, L, tsize);
}

}  // extern "C"

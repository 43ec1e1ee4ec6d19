// CPU build of the fused former kernels' device code (host_emu.h), with
// the same C entry points as fused_former.cu on host pointers and without
// the stream: lets the tests run the CUDA source's arithmetic, indexing and
// barriers on a machine with no GPU.
#include "host_emu.h"

#include "fused_former.cuh"

namespace {

template <typename T, bool TC>
int run_ln_mlp(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* out, int R, int C, int M) {
  const size_t smem = vf::ln_mlp_smem_bytes(C, M, sizeof(T));
  const int grid = (R + vf::kBM - 1) / vf::kBM;
  emu_launch(grid, vf::kThreads, smem, [&](unsigned char* s) {
    vf::ln_mlp_body<T, TC>(
        static_cast<const T*>(x), static_cast<const T*>(w1),
        static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<T*>(out), R, C, M, s);
  });
  return 0;
}

template <typename T, bool TC>
int run_block(const void* x, const void* w_in, const void* b_in,
              const void* w_out, const void* b_out, const void* w1,
              const void* b1, const void* w2, const void* b2, void* out,
              int R, int C, int M, int L, int H) {
  const size_t smem = vf::block_smem_bytes(C, H, L, M, sizeof(T));
  const int br = vf::block_rows(L);
  const int grid = (R + br - 1) / br;
  emu_launch(grid, vf::kThreads, smem, [&](unsigned char* s) {
    vf::block_body<T, TC>(
        static_cast<const T*>(x), static_cast<const T*>(w_in),
        static_cast<const T*>(b_in), static_cast<const T*>(w_out),
        static_cast<const T*>(b_out), static_cast<const T*>(w1),
        static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<T*>(out), R, C, M, L, H, s);
  });
  return 0;
}

}  // namespace

extern "C" {

int vf_fused_ln_mlp(int dtype, const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, int R, int C,
                    int M) {
  const int bad = vf::check_mlp_shape(R, C, M);
  if (bad) return bad;
  if (dtype == 0)
    return run_ln_mlp<float, false>(x, w1, b1, w2, b2, out, R, C, M);
  if (dtype != 1) return -100;
  if (vf::use_tc(2, C, 16, M))
    return run_ln_mlp<__nv_bfloat16, true>(x, w1, b1, w2, b2, out, R, C, M);
  return run_ln_mlp<__nv_bfloat16, false>(x, w1, b1, w2, b2, out, R, C, M);
}

int vf_fused_block(int dtype, const void* x, const void* w_in,
                   const void* b_in, const void* w_out, const void* b_out,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int R, int C, int M, int L,
                   int H) {
  const int bad = vf::check_block_shape(R, C, M, L, H);
  if (bad) return bad;
  if (dtype == 0)
    return run_block<float, false>(x, w_in, b_in, w_out, b_out, w1, b1, w2,
                                   b2, out, R, C, M, L, H);
  if (dtype != 1) return -100;
  if (vf::use_tc(2, C, C / H, M))
    return run_block<__nv_bfloat16, true>(x, w_in, b_in, w_out, b_out, w1, b1,
                                          w2, b2, out, R, C, M, L, H);
  return run_block<__nv_bfloat16, false>(x, w_in, b_in, w_out, b_out, w1, b1,
                                         w2, b2, out, R, C, M, L, H);
}

size_t vf_block_smem_bytes(int C, int H, int L, int M, int tsize) {
  return vf::block_smem_bytes(C, H, L, M, tsize);
}

size_t vf_ln_mlp_smem_bytes(int C, int M, int tsize) {
  return vf::ln_mlp_smem_bytes(C, M, tsize);
}

}  // extern "C"

// CPU build of the kernels' device code (host_emu.h), with the same C entry
// points as fused_former.cu and corr_sample.cu on host pointers and without
// the stream: lets the tests run the CUDA sources' arithmetic, indexing and
// barriers on a machine with no GPU.
#include "host_emu.h"

#include "corr_sample.cuh"
#include "fused_former.cuh"

namespace {

using bf = __nv_bfloat16;

// The ring path's ln_mlp (C <= 384).
int run_ln_mlp(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* out, int R, int C, int M) {
  emu_launch(vf::cdiv(R, vf::NarrowTile::BM), vf::kThreads,
             vf::ln_mlp_smem_bytes(C), [&](unsigned char* s) {
               vf::ln_mlp_body(
                   static_cast<const bf*>(x), static_cast<const bf*>(w1),
                   static_cast<const bf*>(b1), static_cast<const bf*>(w2),
                   static_cast<const bf*>(b2), static_cast<bf*>(out), R, C, M,
                   s);
             });
  return 0;
}

template <typename T>
void run_ln_rows(const void* x, void* xn, float* stats, int R, int C) {
  emu_launch(vf::cdiv(R, vf::kLnRows), vf::kThreads, vf::ln_rows_smem_bytes(),
             [&](unsigned char* s) {
               vf::ln_rows_body<T>(static_cast<const T*>(x),
                                   static_cast<T*>(xn), stats, R, C, s);
             });
}

int run_wide_mlp(const void* x, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* out, void* scratch,
                 int R, int C, int M) {
  if (!scratch) return -9;
  void* xn = scratch;
  void* h = static_cast<bf*>(scratch) + size_t(R) * C;
  run_ln_rows<bf>(x, xn, nullptr, R, C);
  const vf::Epi<bf> fc1{static_cast<const bf*>(b1), nullptr, nullptr,
                        static_cast<bf*>(h), M};
  emu_launch(vf::cdiv(M, vf::kGN), vf::kThreads, vf::tc_gemm_smem_bytes(),
             [&](unsigned char* s) {
               vf::tc_gemm_body<vf::kEpiGelu>(
                   static_cast<const bf*>(xn), C, static_cast<const bf*>(w1),
                   C, R, M, C, fc1, s);
             }, vf::cdiv(R, vf::kGM));
  const vf::Epi<bf> fc2{static_cast<const bf*>(b2), static_cast<const bf*>(x),
                        nullptr, static_cast<bf*>(out), C};
  emu_launch(vf::cdiv(C, vf::kGN), vf::kThreads, vf::tc_gemm_smem_bytes(),
             [&](unsigned char* s) {
               vf::tc_gemm_body<vf::kEpiResid>(
                   static_cast<const bf*>(h), M, static_cast<const bf*>(w2),
                   M, R, C, M, fc2, s);
             }, vf::cdiv(R, vf::kGM));
  return 0;
}

template <typename T, int RT, int CT, int KIND>
void run_cc_gemm_tile(const T* A, const T* W, int R, int N, int K,
                      const vf::Epi<T>& epi) {
  emu_launch(vf::cdiv(N, 16 * CT), vf::kThreads,
             vf::cc_gemm_smem_bytes(RT, CT), [&](unsigned char* s) {
               vf::cc_gemm_body<T, RT, CT, KIND>(A, K, W, K, R, N, K, epi, s);
             }, vf::cdiv(R, 16 * RT));
}

template <typename T, int KIND>
void run_cc_gemm(const T* A, const T* W, int R, int N, int K,
                 const vf::Epi<T>& epi, int sms) {
  const int tile = vf::cc_tile(R, N, sms);
  if (tile == 44)
    run_cc_gemm_tile<T, 4, 4, KIND>(A, W, R, N, K, epi);
  else if (tile == 41)
    run_cc_gemm_tile<T, 4, 1, KIND>(A, W, R, N, K, epi);
  else
    run_cc_gemm_tile<T, 1, 1, KIND>(A, W, R, N, K, epi);
}

// The f32 MLP path: the LayerNorm pass, then the two products on
// cc_gemm_body at the tiles an H100 SXM's 132 SMs give (cc_tile).
int run_cc_mlp(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, void* out, void* scratch, int R, int C,
               int M) {
  constexpr int kSms = 132;
  if (!scratch) return -9;
  float* xn = static_cast<float*>(scratch);
  float* h = xn + size_t(R) * C;
  run_ln_rows<float>(x, xn, nullptr, R, C);
  const vf::Epi<float> fc1{static_cast<const float*>(b1), nullptr, nullptr,
                           h, M};
  run_cc_gemm<float, vf::kEpiGelu>(xn, static_cast<const float*>(w1), R, M,
                                   C, fc1, kSms);
  const vf::Epi<float> fc2{static_cast<const float*>(b2),
                           static_cast<const float*>(x), nullptr,
                           static_cast<float*>(out), C};
  run_cc_gemm<float, vf::kEpiResid>(h, static_cast<const float*>(w2), R, C, M,
                                    fc2, kSms);
  return 0;
}

template <typename T, int BM>
void run_attn_core(const T* qkv, T* os, int R, int C, int L, int H) {
  emu_launch(vf::cdiv(R, vf::block_rows(L, BM)), vf::kThreads,
             vf::attn_core_smem_bytes(C, H, L, sizeof(T)),
             [&](unsigned char* s) {
               vf::attn_core_body<T, BM>(qkv, os, R, C, L, H, s);
             }, H);
}

template <typename T>
int run_attn(const void* x, const void* w_in, const void* b_in,
             const void* w_out, const void* b_out, void* out, void* scratch,
             int R, int C, int L, int H, int sms) {
  const vf::AttnScratch sc = vf::attn_scratch_carve(scratch, R, C, sizeof(T));
  const T* xt = static_cast<const T*>(x);
  T* xst = static_cast<T*>(sc.xs);
  T* qt = static_cast<T*>(sc.qkv);
  T* ot = static_cast<T*>(sc.os);
  float* st = sc.stats;
  run_ln_rows<T>(x, xst, st, R, C);
  const vf::Epi<T> proj{static_cast<const T*>(b_in), nullptr, nullptr, qt,
                        3 * C};
  run_cc_gemm<T, vf::kEpiBias>(xst, static_cast<const T*>(w_in), R, 3 * C, C,
                               proj, sms);
  const int bm = vf::attn_tile_rows(L);
  if (bm == 16)
    run_attn_core<T, 16>(qt, ot, R, C, L, H);
  else if (bm == 32)
    run_attn_core<T, 32>(qt, ot, R, C, L, H);
  else
    run_attn_core<T, 64>(qt, ot, R, C, L, H);
  const vf::Epi<T> res{static_cast<const T*>(b_out), xt, st,
                       static_cast<T*>(out), C};
  run_cc_gemm<T, vf::kEpiNormResid>(ot, static_cast<const T*>(w_out), R, C,
                                    C, res, sms);
  return 0;
}

int run_block(const void* x, const void* w_in, const void* b_in,
              const void* w_out, const void* b_out, const void* w1,
              const void* b1, const void* w2, const void* b2, void* out,
              int R, int C, int M, int L, int H) {
  emu_launch(vf::cdiv(R, vf::block_rows(L)), vf::kThreads,
             vf::block_smem_bytes(C, H, L), [&](unsigned char* s) {
               vf::block_body(
                   static_cast<const bf*>(x), static_cast<const bf*>(w_in),
                   static_cast<const bf*>(b_in), static_cast<const bf*>(w_out),
                   static_cast<const bf*>(b_out), static_cast<const bf*>(w1),
                   static_cast<const bf*>(b1), static_cast<const bf*>(w2),
                   static_cast<const bf*>(b2), static_cast<bf*>(out), R, C, M,
                   L, H, s);
             });
  return 0;
}

template <typename T, int V, bool ONE, bool FLAT>
int run_corr(vcorr::Args a) {
  size_t smem;
  const unsigned blocks = vcorr::geometry(a, FLAT, &smem);
  emu_launch(int(blocks), a.wpb * 32, smem, [&](unsigned char* s) {
    vcorr::corr_body<T, V, ONE, FLAT>(a, reinterpret_cast<float*>(s));
  });
  return 0;
}

template <typename T>
int run_corr_variant(const vcorr::Args& a, vcorr::Variant v) {
  constexpr int kVec = 16 / sizeof(T);
  switch (v) {
    case vcorr::kFlat: return run_corr<T, 1, false, true>(a);
    case vcorr::kVecOne: return run_corr<T, kVec, true, false>(a);
    case vcorr::kScalarOne: return run_corr<T, 1, true, false>(a);
    default: return run_corr<T, 1, false, false>(a);
  }
}

}  // namespace

extern "C" {

int vf_corr_sample(int dtype, int out_bf16, int L, const long long* ptrs,
                   const int* hw, const long long* strides,
                   const void* coords, const void* feats, long long sfF,
                   long long sfN, void* out, int F, int N, int C,
                   int radius) {
  vcorr::Args a;
  vcorr::Variant v;
  const int rc = vcorr::make_args(a, &v, dtype, out_bf16, L, ptrs, hw,
                                  strides, coords, feats, sfF, sfN, out, F,
                                  N, C, radius);
  if (rc) return rc;
  if (dtype == 0) return run_corr_variant<float>(a, v);
  return run_corr_variant<__nv_bfloat16>(a, v);
}

int vf_corr_variant(int dtype, int L, const long long* ptrs, const int* hw,
                    const long long* strides, int C) {
  vcorr::Args a{};
  a.L = L;
  a.C = C;
  vcorr::Variant v;
  const int rc = vcorr::plan(a, ptrs, hw, strides, dtype == 0 ? 4 : 2, &v);
  return rc ? rc : int(v);
}

size_t vf_corr_smem_bytes(int C, int radius, int flat) {
  return size_t(vcorr::warps_per_block(C, radius, flat != 0))
         * vcorr::warp_floats(C, radius, flat != 0) * sizeof(float);
}

int vf_fused_ln_mlp(int dtype, const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, void* scratch,
                    int R, int C, int M) {
  const int bad = vf::check_mlp_shape(R, C, M);
  if (bad) return bad;
  if (dtype == 0)
    return run_cc_mlp(x, w1, b1, w2, b2, out, scratch, R, C, M);
  if (dtype != 1) return -100;
  if (vf::split_mlp(2, C))
    return run_wide_mlp(x, w1, b1, w2, b2, out, scratch, R, C, M);
  return run_ln_mlp(x, w1, b1, w2, b2, out, R, C, M);
}

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
                   int H) {
  const int bad = vf::check_block_shape(R, C, M, L, H);
  if (bad) return bad;
  if (dtype != 1) return -100;
  return run_block(x, w_in, b_in, w_out, b_out, w1, b1, w2, b2, out, R, C, M,
                   L, H);
}

int vf_fused_ln_attn(int dtype, const void* x, const void* w_in,
                     const void* b_in, const void* w_out, const void* b_out,
                     void* out, void* scratch, int R, int C, int L, int H,
                     int sms) {
  const int bad = vf::check_attn_shape(R, C, L, H);
  if (bad) return bad;
  if (dtype == 0)
    return run_attn<float>(x, w_in, b_in, w_out, b_out, out, scratch, R, C, L,
                           H, sms);
  if (dtype != 1) return -100;
  return run_attn<__nv_bfloat16>(x, w_in, b_in, w_out, b_out, out, scratch,
                                 R, C, L, H, sms);
}

size_t vf_attn_scratch_bytes(int dtype, int R, int C) {
  return vf::attn_scratch_bytes(R, C, dtype == 1 ? 2 : 4);
}

int vf_cc_tile(int R, int N, int sms) { return vf::cc_tile(R, N, sms); }

size_t vf_block_smem_bytes(int C, int H, int L) {
  return vf::block_smem_bytes(C, H, L);
}

size_t vf_ln_mlp_smem_bytes(int C) { return vf::ln_mlp_smem_bytes(C); }

size_t vf_attn_smem_bytes(int C, int H, int L, int tsize) {
  return vf::attn_smem_bytes(C, H, L, tsize);
}

// One warp of the ring path's primitives, for the tests: a (16, 32) bf16
// A and a (16, 32) bf16 W (rows = output columns, k contiguous) go to
// padded shared rows by cp.async; then d = A W^T (16 x 16, f32) from
// ldmatrix.x4 fragments and two mma.sync m16n8k16 per 16-deep step, and
// d8 = A W[8:16]^T (16 x 8) through ldmatrix.x2. Row-major outputs.
int vf_emu_warp_mma(const void* a, const void* w, float* d, float* d8) {
  constexpr int ld = 32 + vf::kPad;
  emu_launch(1, 32, 2 * 16 * ld * sizeof(bf), [&](unsigned char* s) {
    bf* As = reinterpret_cast<bf*>(s);
    bf* Ws = As + 16 * ld;
    const int lane = threadIdx.x;
    for (int idx = lane; idx < 2 * 16 * 4; idx += 32) {
      const int m = idx / 64, r = (idx / 4) % 16, c8 = idx % 4;
      cp_async_16((m ? Ws : As) + r * ld + c8 * 8,
                  static_cast<const bf*>(m ? w : a) + r * 32 + c8 * 8);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float acc[2][4] = {}, acc8[4] = {};
    for (int k = 0; k < 32; k += 16) {
      unsigned fa[4], fb[4], fb8[2];
      ldsm_x4(fa, As + (lane & 15) * ld + k + (lane >> 4) * 8);
      const bf* bp = Ws + (lane & 7) * ld + k + ((lane >> 3) & 1) * 8;
      ldsm_x4(fb, bp + (lane >> 4) * 8 * ld);
      ldsm_x2(fb8, bp + 8 * ld);
      const unsigned lo[2] = {fb[0], fb[1]}, hi[2] = {fb[2], fb[3]};
      mma_16816(acc[0], fa, lo);
      mma_16816(acc[1], fa, hi);
      mma_16816(acc8, fa, fb8);
    }
    const int g = lane / 4, t = lane % 4;
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e / 2), c = 2 * t + e % 2;
      d[r * 16 + c] = acc[0][e];
      d[r * 16 + 8 + c] = acc[1][e];
      d8[r * 8 + c] = acc8[e];
    }
  });
  return 0;
}

}  // extern "C"

// CPU build of the attention kernel's device code (host_emu.h), with the
// same C entry point as flash_attn.cu on host pointers and without the
// stream: lets the tests run the CUDA source's arithmetic, indexing,
// fragment layouts and barriers on a machine with no GPU.
#include "host_emu.h"

// ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16: lanes 8i..8i+7 give the
// row addresses of matrix i; lane l receives, of each matrix, column l / 4
// of rows 2 (l % 4) and 2 (l % 4) + 1 (the lower row in the low half).
inline void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x % 32;
  w.addr[lane] = p;
  w.bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const uint16_t* r0 =
        static_cast<const uint16_t*>(w.addr[8 * i + 2 * (lane % 4)]);
    const uint16_t* r1 =
        static_cast<const uint16_t*>(w.addr[8 * i + 2 * (lane % 4) + 1]);
    r[i] = unsigned(r0[lane / 4]) | unsigned(r1[lane / 4]) << 16;
  }
  w.bar->arrive_and_wait();
}

#include "flash_attn.cuh"

extern "C" {

int vf_flash_attn(const void* q, const void* k, const void* v, void* out,
                  int BH, int L, int H, int D, float scale) {
  using bf = __nv_bfloat16;
  if (D != vfa::kD || L < 1 || BH < 1 || H < 1 || BH % H != 0) return -1;
  emu_launch(
      (L + vfa::kBM - 1) / vfa::kBM, vfa::kThreads, vfa::kSmemBytes,
      [&](unsigned char* s) {
        vfa::attn_body(static_cast<const bf*>(q), static_cast<const bf*>(k),
                       static_cast<const bf*>(v), static_cast<bf*>(out), L, H,
                       scale, s);
      },
      BH);
  return 0;
}

}  // extern "C"

// CPU build of the attention kernel's device code (host_emu.h), with the
// same C entry point as flash_attn.cu on host pointers and without the
// stream: lets the tests run the CUDA source's warp specialisation, TMA
// ring, wgmma layouts, softmax and barriers on a machine with no GPU. The
// tensor maps are host_emu.h's stand-ins with the same dimensions, strides,
// boxes and swizzle as the entry point's.
#include "host_emu.h"

#include "flash_attn.cuh"

namespace {

CUtensorMap make_map(const void* p, int BH, int L, int rows) {
  CUtensorMap m;
  m.base = static_cast<const unsigned char*>(p);
  m.dim[0] = vfa::kD;
  m.dim[1] = uint64_t(L);
  m.dim[2] = uint64_t(BH);
  m.stride[0] = 2;
  m.stride[1] = vfa::kRowBytes;
  m.stride[2] = uint64_t(L) * vfa::kRowBytes;
  m.box[0] = vfa::kD;
  m.box[1] = uint32_t(rows);
  m.box[2] = 1;
  m.swizzle = 128;
  return m;
}

}  // namespace

extern "C" {

int vf_flash_attn(const void* q, const void* k, const void* v, void* out,
                  int BH, int L, int H, int D, float scale) {
  using bf = __nv_bfloat16;
  if (D != vfa::kD || L < 1 || BH < 1 || H < 1 || BH % H != 0) return -1;
  const CUtensorMap tq = make_map(q, BH, L, vfa::kWM);
  const CUtensorMap tk = make_map(k, BH, L, vfa::kBN);
  const CUtensorMap tv = make_map(v, BH, L, vfa::kBN);
  emu_launch(
      (L + vfa::kBM - 1) / vfa::kBM, vfa::kThreads, vfa::kSmemBytes,
      [&](unsigned char* s) {
        vfa::attn_body(&tq, &tk, &tv, static_cast<bf*>(out), L, H, scale, s);
      },
      BH);
  return 0;
}

}  // extern "C"

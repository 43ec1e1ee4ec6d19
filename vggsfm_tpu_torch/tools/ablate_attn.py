"""Where the attention kernel's time goes: csrc/flash_attn.cuh with one
part changed.

    python -m vggsfm_tpu_torch.tools.ablate_attn     # from the repo root, one GPU

Builds variants of csrc/flash_attn.cuh, each with one text substitution
(a part removed, or a design choice undone), into vggsfm_tpu_torch/_build/
ablate_attn/ (nvcc, sm_90a, all variants at once, flash_attn.cu alone),
then times VGGT's two calls of each by CUDA events, the unchanged source
first and last: the global call (16 heads x 65,952) and the frame-sized
call (48 x 16 heads x 1,374). A variant without a part computes a wrong
result: only its time means anything. Prints the card and one line per
variant; exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import sys

import torch

from vggsfm_tpu_torch.ops import _build
from vggsfm_tpu_torch.tools.ablate_ring import time_ms, variant_source

_LOAD_K = ("        mbar_arrive_expect_tx(full_k + st, kTileBytes);\n"
           "        tma_load_3d(sk + st * kTileBytes, tk, 0, kBN * j, bh, "
           "full_k + st);\n")

# name -> [(old text, new text)] (ablate_ring.variant_source)
VARIANTS = {
    "unchanged": [],
    # the consumers issue their products whenever they are ready
    "no ping-pong": [
        ('asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(count) '
         ': "memory");', "(void)id; (void)count;"),
        ('asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(count) '
         ': "memory");', "(void)id; (void)count;")],
    # the softmax of tile j waits for tile j - 1's p.v as well
    "no overlap in a warpgroup": [
        ("    wgmma_wait<1>();  // q.k of tile j done",
         "    wgmma_wait<0>();  // q.k of tile j done")],
    "2 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "3 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    # the scores' exponentials become copies (the SFU idles)
    "no exponentials": [
        ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = x;")],
    "no p.v": [
        ("      wgmma_pv(o, p + 4 * kk, sw128_desc(vt + 16 * kRowBytes * kk,"
         " 1024, 1024));", "      (void)vt;")],
    # K and V tiles past the first kStages are not copied: the consumers
    # read stale stages, and no K/V bytes leave L2 after the ring fills
    "no K/V copies after the ring fills": [
        (_LOAD_K, "        if (j >= kStages) {\n"
                  "          mbar_arrive(full_k + st);\n"
                  "          mbar_arrive(full_v + st);\n"
                  "          continue;\n        }\n" + _LOAD_K)],
}


def build_all(root: str, variants=None) -> dict:
    """One library per variant (default: this module's VARIANTS) holding
    flash_attn.cu alone, built side by side."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    with open(os.path.join(_build.CSRC, "flash_attn.cuh")) as f:
        base = f.read()
    procs = {}
    for i, (name, subs) in enumerate((variants or VARIANTS).items()):
        d = os.path.join(root, str(i))
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(_build.CSRC, "flash_attn.cu"), d)
        with open(os.path.join(d, "flash_attn.cuh"), "w") as f:
            f.write(variant_source(base, subs))
        cmd = [nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "flash_attn.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (d, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"building {name!r} failed:\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.vf_flash_attn.argtypes = [vp] * 4 + [ci] * 4 \
            + [ctypes.c_float, vp]
        lib.vf_flash_attn.restype = ci
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_attn: no CUDA GPU available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    libs = build_all(os.path.join(_build.BUILD_DIR, "ablate_attn"))

    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [(1, 16, 65952), (48, 16, 1374)]
    data = {}
    for B, H, L in cases:
        q, k, v = (torch.randn(B * H, L, 64, generator=g, device="cuda")
                   .bfloat16() for _ in range(3))
        data[L] = (q, k, v, torch.empty(B, L, H * 64, dtype=torch.bfloat16,
                                        device="cuda"), B, H)
    stream = torch.cuda.current_stream().cuda_stream
    scale = math.log2(math.e) / 8

    def launch(lib, L):
        q, k, v, out, B, H = data[L]
        rc = lib.vf_flash_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), B * H, L, H, 64, scale,
                               stream)
        if rc:
            raise RuntimeError(f"launch failed: code {rc}")

    print("ms per launch, bf16: " + ", ".join(
        f"B={B} H={H} L={L}" for B, H, L in cases), flush=True)
    for name in [*VARIANTS, "unchanged"]:
        lib = libs[name]
        row = [time_ms(lambda: launch(lib, L), 5 if L > 4096 else 20)
               for _, _, L in cases]
        print(f"  {name:36s} " + "  ".join(f"{t:.4f}" for t in row),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

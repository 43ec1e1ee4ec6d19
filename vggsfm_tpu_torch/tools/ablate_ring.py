"""Where the ring path's time goes: its kernels with one part changed.

    python -m vggsfm_tpu_torch.tools.ablate_ring     # from the repo root, one GPU

Builds variants of csrc/fused_former.cuh, each with one text substitution
(a part removed, or a design choice undone), into vggsfm_tpu_torch/_build/
ablate/ (nvcc, sm_90a, all variants at once), then times the bf16 block
kernel (coarse time block R=33280 and the few-track R=896; L=8, C=384,
H=8) and the 384-wide ln_mlp (R=32768 and 896) of each, by CUDA events,
the unchanged source first and last. A variant without a part computes
a wrong result: only its time means anything. Prints the card and one
line per variant; exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

from vggsfm_tpu_torch.ops import _build

_COPY = "cp_async_16(dst + n * (bk + kPad), src + size_t(wr) * ldw);"
_NEXT_SLAB = "    ws.issue(g + kStages - 1);\n    for (int kk = 0; kk < kb; kk += 16) {"
_KK_END = ("          for (int i = 0; i < MT; ++i) mma_16816(acc[i][j], a[i], b);"
           "\n        }\n      }\n    }\n")

# name -> [(old text, new text)]; "mma" is a regular expression
VARIANTS = {
    "unchanged": [],
    "no weight copies": [(_COPY, "(void)wr; (void)dst; (void)src;")],
    "no mma": [("mma", "")],
    "no per-slab barrier": [
        ("    cp_async_wait<kStages - 2>();\n    __syncthreads();\n",
         "    cp_async_wait<kStages - 2>();\n")],
    "no GELU": [("from_f<T>(gelu_erf(h[0][j][e] + to_f<T>(b1[m0 + n])))",
                 "from_f<T>(h[0][j][e] + to_f<T>(b1[m0 + n]))")],
    "no attention": [
        ("    ring_head_attention<bf, BM>(qkv, sc, oh, ldo, rows, L, D, scale);\n",
         "")],
    "scalar attention": [("    ring_head_attention<bf, BM>(qkv, sc, oh, ldo",
                          "    head_attention<bf, BM>(qkv, sc, oh, ldo")],
    # each slab's copies spread over the previous slab's 16-deep steps
    "copies issued in parts": [
        ("void issue(int g) const {",
         "void issue(int g, int part = 0, int parts = 1) const {"),
        ("for (int n = threadIdx.x / cpr; n < N; n += step) {",
         "for (int n = threadIdx.x / cpr + part * step; n < N;"
         " n += parts * step) {"),
        ("    cp_async_commit();\n  }\n};",
         "    if (part == parts - 1) cp_async_commit();\n  }\n};"),
        (_NEXT_SLAB, _NEXT_SLAB.replace("    ws.issue(", "    if (kb <= 0) ws.issue(")),
        (_KK_END, _KK_END[:-6] + "      ws.issue(g + kStages - 1, kk / 16,"
                                 " kb / 16);\n    }\n")],
    "4 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "7 stages, 16 deep": [
        ("constexpr int kStages = 3;", "constexpr int kStages = 7;"),
        ("constexpr int kRingBK = 32;", "constexpr int kRingBK = 16;")],
}


def variant_source(base: str, subs) -> str:
    text = base
    for old, new in subs:
        if old == "mma":
            text, n = re.subn(r'asm\("mma\.sync.*?\);\n',
                              "(void)a; (void)b;\n", text, flags=re.S)
        else:
            n = text.count(old)
            text = text.replace(old, new)
        if n != 1:
            raise RuntimeError(f"substitution {old[:50]!r} matched {n} times")
    return text


def build_all(root: str, variants=None) -> dict:
    """One library per variant (default: this module's VARIANTS), built
    side by side, with the C interface of ops/_build.py."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    with open(os.path.join(_build.CSRC, "fused_former.cuh")) as f:
        base = f.read()
    procs = {}
    for i, (name, subs) in enumerate((variants or VARIANTS).items()):
        d = os.path.join(root, str(i))
        os.makedirs(d, exist_ok=True)
        for src in ("fused_former.cu", "corr_sample.cu", "corr_sample.cuh"):
            shutil.copy(os.path.join(_build.CSRC, src), d)
        with open(os.path.join(d, "fused_former.cuh"), "w") as f:
            f.write(variant_source(base, subs))
        cmd = [nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "fused_former.cu"),
               os.path.join(d, "corr_sample.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (d, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"building {name!r} failed:\n{log[-4000:]}")
        libs[name] = _build._declare(ctypes.CDLL(os.path.join(d, "lib.so")),
                                     with_stream=True)
    return libs


def time_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_ring: no CUDA GPU available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    libs = build_all(os.path.join(_build.BUILD_DIR, "ablate"))

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=0.05):
        return (torch.randn(*shape, generator=g) * scale).to("cuda",
                                                            torch.bfloat16)

    C, L, H = 384, 8, 8
    M = 4 * C
    ws = [rnd(3 * C, C), rnd(3 * C), rnd(C, C), rnd(C), rnd(M, C), rnd(M),
          rnd(C, M), rnd(C)]
    stream = torch.cuda.current_stream().cuda_stream
    cases = [("block", 33280), ("block", 896), ("ln_mlp", 32768),
             ("ln_mlp", 896)]
    xs = {R: rnd(R, C, scale=1.5) for _, R in cases}
    outs = {R: torch.empty_like(x) for R, x in xs.items()}

    def launch(lib, kind, R):
        x, o = xs[R], outs[R]
        if kind == "block":
            rc = lib.vf_fused_block(1, x.data_ptr(),
                                    *[w.data_ptr() for w in ws],
                                    o.data_ptr(), R, C, M, L, H, stream)
        else:
            rc = lib.vf_fused_ln_mlp(1, x.data_ptr(),
                                     *[w.data_ptr() for w in ws[4:]],
                                     o.data_ptr(), None, R, C, M, stream)
        if rc:
            raise RuntimeError(f"launch failed: code {rc}")

    print("ms per launch, bf16, C=384: " + ", ".join(
        f"{k} R={R}" for k, R in cases), flush=True)
    for name in [*VARIANTS, "unchanged"]:
        lib = libs[name]
        row = [time_ms(lambda: launch(lib, k, R), 10 if R > 4096 else 30)
               for k, R in cases]
        print(f"  {name:24s} " + "  ".join(f"{t:.4f}" for t in row),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

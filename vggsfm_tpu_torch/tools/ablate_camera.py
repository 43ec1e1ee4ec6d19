"""Where the camera kernels' time goes: the wide MLP path and the
attention half with one design choice changed.

    python -m vggsfm_tpu_torch.tools.ablate_camera   # from the repo root, one GPU

Builds variants of csrc/fused_former.cuh, each with one text substitution
(tools/ablate_ring.py's build_all: nvcc, sm_90a, all variants at once, into
vggsfm_tpu_torch/_build/ablate_camera/), then times, the unchanged
source first and last: the 768-wide bf16 ln_mlp at the camera's
cross-attention tails (R=32312, M=3072) and fused_ln_attn at the camera
trunk (R=64, L=8, C=768, H=8) in f32 and bf16 and at R=4096 in f32. Each
time is the device time per call (torch.profiler, the kernels' sum), and
beside it the time per call by CUDA events. Every variant's output is
held against the unchanged one's (a variant without a part computes a
wrong result: only its time means anything). Prints the card and one
line per variant; exits non-zero without a GPU.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from vggsfm_tpu_torch.ops import _build
from vggsfm_tpu_torch.tools.ablate_ring import build_all, time_ms


# name -> [(old text, new text)] in fused_former.cuh
VARIANTS = {
    "unchanged": [],
    "GEMM 32-deep slabs, 4 stages": [
        ("constexpr int kGK = 64;", "constexpr int kGK = 32;"),
        ("constexpr int kGStages = 3;", "constexpr int kGStages = 4;")],
    "GEMM 4 stages, 1 block/SM": [
        ("constexpr int kGStages = 3;", "constexpr int kGStages = 4;"),
        ("constexpr int kGBlocksPerSM = 2;",
         "constexpr int kGBlocksPerSM = 1;")],
    "GEMM 128-deep slabs, 2 stages": [
        ("constexpr int kGK = 64;", "constexpr int kGK = 128;"),
        ("constexpr int kGStages = 3;", "constexpr int kGStages = 2;")],
    "GEMM 128 x 256 tiles, 1 block/SM": [
        ("constexpr int kGN = 128;", "constexpr int kGN = 256;"),
        ("constexpr int kGBlocksPerSM = 2;",
         "constexpr int kGBlocksPerSM = 1;")],
    "GEMM 128 x 256 tiles, 32-deep slabs, 4 stages, 1 block/SM": [
        ("constexpr int kGN = 128;", "constexpr int kGN = 256;"),
        ("constexpr int kGK = 64;", "constexpr int kGK = 32;"),
        ("constexpr int kGStages = 3;", "constexpr int kGStages = 4;"),
        ("constexpr int kGBlocksPerSM = 2;",
         "constexpr int kGBlocksPerSM = 1;")],
    "GEMM 2 stages": [("constexpr int kGStages = 3;",
                       "constexpr int kGStages = 2;")],
    # a wrong result: only the time of fc1's epilogue without GELU counts
    "fc1 epilogue without GELU": [("    return gelu_erf(v);",
                                   "    return v;")],
    "attention GEMM rings 3 deep": [("constexpr int kCStages = 2;",
                                     "constexpr int kCStages = 3;")],
    "attention GEMM rings 4 deep": [("constexpr int kCStages = 2;",
                                     "constexpr int kCStages = 4;")],
    "attention GEMM 64 x 16 tiles at most": [
        ("  if (long(cdiv(R, 64)) * cdiv(N, 64) >= 2L * sms) return 44;\n",
         "")],
    "attention core with scalar loads": [
        ("  if (D % 8 == 0)  // 16-byte aligned rows of q|k|v and o\n",
         "  if (false)\n")],
}


def _device_ms(fn, iters: int) -> float:
    """Device time per call of fn: the sum of its kernels' times."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
             for ev in prof.key_averages())
    return us / 1e3 / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_camera: no CUDA GPU available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    libs = build_all(os.path.join(_build.BUILD_DIR, "ablate_camera"),
                     VARIANTS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype, scale=0.05):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

    bf, f32 = torch.bfloat16, torch.float32
    C, M, L, H = 768, 3072, 8, 8
    cases = [("ln_mlp", 32312, bf), ("ln_attn", 64, f32),
             ("ln_attn", 64, bf), ("ln_attn", 4096, f32)]
    inputs = []
    for kind, R, dt in cases:
        x = rnd(R, C, dtype=dt, scale=1.5)
        shapes = ((M, C), (M,), (C, M), (C,)) if kind == "ln_mlp" else \
            ((3 * C, C), (3 * C,), (C, C), (C,))
        ws = [rnd(*s, dtype=dt) for s in shapes]
        code = 1 if dt == bf else 0
        nbytes = (libs["unchanged"].vf_ln_mlp_scratch_bytes(code, R, C, M)
                  if kind == "ln_mlp" else
                  libs["unchanged"].vf_attn_scratch_bytes(code, R, C))
        scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        inputs.append((x, ws, torch.empty_like(x), scratch, code))

    def launch(lib, i):
        (kind, R, _), (x, ws, out, scratch, code) = cases[i], inputs[i]
        ptrs = [x.data_ptr(), *[w.data_ptr() for w in ws], out.data_ptr(),
                scratch.data_ptr()]
        if kind == "ln_mlp":
            rc = lib.vf_fused_ln_mlp(code, *ptrs, R, C, M, stream)
        else:
            rc = lib.vf_fused_ln_attn(code, *ptrs, R, C, L, H, sms, stream)
        if rc:
            raise RuntimeError(f"launch failed: code {rc}")
        return out

    ref = []
    for i in range(len(cases)):
        ref.append(launch(libs["unchanged"], i).clone())
    print("device ms per call (events ms), " + ", ".join(
        f"{k} R={R} {str(dt).split('.')[1]}" for k, R, dt in cases)
        + "; max |variant - unchanged|", flush=True)
    for name in [*VARIANTS, "unchanged"]:
        lib = libs[name]
        row, diff = [], 0.0
        for i, (_, R, _) in enumerate(cases):
            iters = 10 if R > 4096 else 50
            dev = _device_ms(lambda: launch(lib, i), iters)
            ev = time_ms(lambda: launch(lib, i), iters)
            diff = max(diff, float((launch(lib, i).float()
                                    - ref[i].float()).abs().max()))
            row.append(f"{dev:.4f} ({ev:.4f})")
        print(f"  {name:44s} " + "  ".join(row) + f"  {diff:.2e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

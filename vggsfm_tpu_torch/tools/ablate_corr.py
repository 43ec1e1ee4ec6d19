"""The tracker's correlation routes against the ones before the one-launch
kernel, timed in turns on one card.

    python -m vggsfm_tpu_torch.tools.ablate_corr   # from the repo root, one GPU

The previous routes (`previous_corr_sample`, `previous_corr_sample_flat`)
are the tracker's correlation as it stood before every call went through
the kernel: for N >= 64 tracks the full correlation map as one bf16
matrix product per level and the windows gathered out of it; for one track
per small NHWC map a full-map multiply-reduce; below 64 tracks the kernel
once per level (float32 maps at C >= 128, the pyramid cast once per
forward); on the flat fine path the full map per level from a float32 copy
of the pyramid. They are kept here as
the yardstick of the routes and called by nothing else in the port.

First the kernel's design choices: variants of csrc/corr_sample.cuh, each
with one constant changed (built side by side with nvcc, sm_90a, into
vggsfm_tpu_torch/_build/ablate_corr/), each timed on the device (torch.profiler) at the tracker's two calls per
iteration (coarse: 8 frames x 4096 tracks, 5 levels, C = 128; fine: 4096
x 8 track-frames, 3 flat levels, C = 32; bf16), the unchanged source
first and last, every output held against the unchanged one's.

Then the tracker slice of chip_smoke.py (8 frames at 1024 px, 4096 query
points, one query frame, bf16, seeded weights) with the previous routes
and with the kernel's, in turns (previous, kernel, kernel, previous),
`reps` runs per turn: for each turn the `coarse` and `fine` stage times
(host clock, ending in a synchronize; the mean of the runs), the wall
time and the peak device memory, then both routes' means. Prints the
card first; exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import time

import torch

from vggsfm_tpu_torch.models import tracker as ttr
from vggsfm_tpu_torch.ops import _build
from vggsfm_tpu_torch.ops.corr import (
    SMALL_C,
    corr_sample_kernel,
    window_from_dots,
    window_index,
)

# name -> [(old text, new text)] in corr_sample.cuh
KERNEL_VARIANTS = {
    "unchanged": [],
    "8 warps per block": [("constexpr int kWarpsPerBlock = 4;",
                           "constexpr int kWarpsPerBlock = 8;")],
    "16 warps per block": [("constexpr int kWarpsPerBlock = 4;",
                            "constexpr int kWarpsPerBlock = 16;")],
    "NHWC: 2 cells per lane and load batch": [
        ("constexpr int kCells = 4;", "constexpr int kCells = 2;")],
    "NHWC: 8 cells per lane and load batch": [
        ("constexpr int kCells = 4;", "constexpr int kCells = 8;")],
    "flat: 2 cells x 8 channels per load batch": [
        ("constexpr int kFlatCells = 1;", "constexpr int kFlatCells = 2;"),
        ("constexpr int kFlatChannels = 16;",
         "constexpr int kFlatChannels = 8;")],
    "flat: 1 cell x 8 channels per load batch": [
        ("constexpr int kFlatChannels = 16;",
         "constexpr int kFlatChannels = 8;")],
    "maps read through the read-only path (__restrict__)": [
        ("void nhwc_dots(const Level& lv, const T* map,",
         "void nhwc_dots(const Level& lv, const T* __restrict__ map,"),
        ("void flat_dots(const Level& lv, const T* map,",
         "void flat_dots(const Level& lv, const T* __restrict__ map,")],
}


def build_variants(root: str) -> dict:
    """One library of csrc/corr_sample.cu per KERNEL_VARIANTS entry, built
    side by side; each declares the correlation entry points."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    with open(os.path.join(_build.CSRC, "corr_sample.cuh")) as f:
        base = f.read()
    procs = {}
    for i, (name, subs) in enumerate(KERNEL_VARIANTS.items()):
        src = base
        for old, new in subs:
            if old not in src:
                raise ValueError(f"{name!r}: {old!r} not in the source")
            src = src.replace(old, new)
        d = os.path.join(root, str(i))
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(_build.CSRC, "corr_sample.cu"), d)
        with open(os.path.join(d, "corr_sample.cuh"), "w") as f:
            f.write(src)
        cmd = [nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "corr_sample.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (d, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"building {name!r} failed:\n{log[-4000:]}")
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        lib.vf_corr_sample.argtypes = ([ci] * 3 + [vp] * 5 + [cll] * 2
                                       + [vp] + [ci] * 4 + [vp])
        lib.vf_corr_sample.restype = ci
        libs[name] = lib
    return libs


def kernel_variants(cs) -> None:
    """Device ms per call of each variant at the two main-path calls."""
    root = os.path.join(_build.BUILD_DIR, "ablate_corr")
    libs = build_variants(root)
    g = torch.Generator().manual_seed(1)
    bf16 = torch.bfloat16
    calls = {
        "coarse": cs.corr_inputs(g, 8, [(128 >> i, 128 >> i)
                                        for i in range(5)], 128, 4096,
                                 bf16, False, (0.0, 128.0)) + (4,),
        "fine": cs.corr_inputs(g, 4096 * 8, [(31, 31), (15, 15), (7, 7)],
                               32, 1, bf16, True, (11.0, 19.0)) + (3,)}
    saved = _build.load_library
    rows = list(KERNEL_VARIANTS) + ["unchanged (again)"]
    ref = {}
    try:
        for row in rows:
            lib = libs["unchanged" if row.startswith("unchanged") else row]
            _build.load_library = lambda lib=lib: lib
            times = []
            for call, (levels, coords, feats, r) in calls.items():

                def run():
                    return corr_sample_kernel(levels, coords, feats, r,
                                              bf16)

                out = run()
                torch.cuda.synchronize()
                ref.setdefault(call, out)
                same = torch.equal(out, ref[call])
                ms = cs.device_time_ms(run, 20, "vcorr")
                times.append(f"{call} {ms} ms"
                             + ("" if same else " (output differs)"))
            print(f"variant [{row}]: " + ", ".join(times), flush=True)
    finally:
        _build.load_library = saved


def window_from_cmap(cmap: torch.Tensor, centers: torch.Tensor, r: int,
                     hw: tuple, dt) -> torch.Tensor:
    """Bilinear (2r+1)^2 windows of scalar correlation maps: cmap
    (..., H*W), centers (..., 2) -> (..., (2r+1)^2) in dtype `dt` (the
    JAX package's `_bilinear_window_matmul`)."""
    H, W = hw
    w = 2 * r + 2
    idx, ok, frac = window_index(centers, r, H, W)
    ci = torch.gather(cmap.to(dt), -1, idx) * ok.to(dt)
    ci = ci.reshape(*ci.shape[:-1], w, w)
    return window_from_dots(ci, frac.to(dt), r)


# the pyramid in float32 and the list it was cast from (one entry)
_f32_pyramid = {"of": None, "levels": None}


def f32_pyramid(pyramid: list) -> list:
    """`pyramid` in float32, cast once per forward: the tracker's forward
    did so before the one-launch kernel when the kernel would read the
    maps (N < 64, C >= 128). The copy is kept for the list it was made
    from, which a forward passes unchanged to every iteration."""
    if _f32_pyramid["of"] is not pyramid:
        _f32_pyramid.update(of=None, levels=None)  # free the last copy
        _f32_pyramid.update(of=pyramid,
                            levels=[lvl.float() for lvl in pyramid])
    return _f32_pyramid["levels"]


def previous_corr_sample(pyramid: list, coords: torch.Tensor,
                         track_feats: torch.Tensor, radius: int,
                         cfirst: bool = False) -> torch.Tensor:
    """The NHWC correlation route before the one-launch kernel (same
    signature as models/tracker.corr_sample; channel-first levels are
    read through NHWC views)."""
    if cfirst:
        pyramid = [lvl.permute(0, 1, 3, 4, 2) for lvl in pyramid]
    B, S, N, _ = coords.shape
    C = track_feats.shape[-1]
    if N < 64 and C >= SMALL_C:
        pyramid = f32_pyramid(pyramid)
    dt = track_feats.dtype
    r = radius
    scale = torch.tensor(float(C), dtype=dt).sqrt()
    out = []
    for i, fmap in enumerate(pyramid):
        _, _, H, W, _ = fmap.shape
        centers = coords / (2.0 ** i)
        if N >= 64:
            fm = fmap.reshape(B, S, H * W, C).to(dt)
            max_chunk = max(64, (1 << 30) // max(
                1, B * S * H * W * track_feats.element_size()))
            chunks = []
            for n0 in range(0, N, max_chunk):
                tf_c = track_feats[:, :, n0: n0 + max_chunk]
                cmap = torch.matmul(tf_c, fm.transpose(-1, -2))
                chunks.append(window_from_cmap(
                    cmap, centers[:, :, n0: n0 + max_chunk], r, (H, W), dt))
            corr = torch.cat(chunks, dim=2) / scale
        elif N == 1 and C < SMALL_C and H * W <= 4096:
            cmap = (fmap.reshape(B, S, H * W, C) * track_feats).float().sum(-1)
            corr = window_from_cmap(cmap[:, :, None], centers, r, (H, W),
                                    dt) / scale
        else:
            kdt = torch.float32 if C >= SMALL_C else fmap.dtype
            corr = corr_sample_kernel(
                [fmap.reshape(B * S, H, W, C).to(kdt).contiguous()],
                centers.reshape(B * S, N, 2).float().contiguous(),
                track_feats.reshape(B * S, N, C).to(kdt).contiguous(),
                r).reshape(B, S, N, -1).to(dt)
        out.append(corr)
    return torch.cat(out, dim=-1)


def previous_corr_sample_flat(levels: list, hws: list, coords: torch.Tensor,
                              track_feats: torch.Tensor, radius: int):
    """The flat channel-first route before the one-launch kernel (same
    signature as models/tracker.corr_sample_flat)."""
    C = track_feats.shape[-1]
    dt = track_feats.dtype
    out = []
    for i, (lvl, hw) in enumerate(zip(levels, hws)):
        cm = torch.matmul(track_feats.float(), lvl.float())  # (B,S,N,HW)
        corr = window_from_cmap(cm, coords / (2.0 ** i), radius, hw, dt)
        out.append(corr / torch.tensor(float(C), dtype=dt).sqrt())
    return torch.cat(out, dim=-1)


class previous_routes:
    """Context: the tracker's correlation takes the previous routes."""

    def __enter__(self):
        self.saved = ttr.corr_sample, ttr.corr_sample_flat
        ttr.corr_sample = previous_corr_sample
        ttr.corr_sample_flat = previous_corr_sample_flat
        return self

    def __exit__(self, *exc):
        ttr.corr_sample, ttr.corr_sample_flat = self.saved
        _f32_pyramid.update(of=None, levels=None)


def route_turns(name: str, runner, drive, reps: int) -> None:
    """The stages of `drive` with the previous routes and the kernel's, in
    turns (previous, kernel, kernel, previous), `reps` runs each."""

    def turn(previous: bool) -> dict:
        runs = []
        for _ in range(reps):
            runner.timings.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if previous:
                with previous_routes():
                    tracks = drive()[0]
            else:
                tracks = drive()[0]
            torch.cuda.synchronize()
            runs.append({"wall": time.perf_counter() - t0,
                         "coarse": runner.timings["coarse"],
                         "fine": runner.timings["fine"],
                         "peak_gib":
                             torch.cuda.max_memory_allocated() / 2**30})
            assert bool(torch.isfinite(tracks).all())
        return {k: sum(r[k] for r in runs) / reps for k in runs[0]}

    with torch.inference_mode():
        drive()  # warm-up: cuDNN algorithm search, the kernels' build
        with previous_routes():
            drive()
        torch.cuda.synchronize()
        rows = {"previous": [], "kernel": []}
        for previous in (True, False, False, True):
            route = "previous" if previous else "kernel"
            row = turn(previous)
            rows[route].append(row)
            print(f"{name}, {route:8s} route: coarse {row['coarse']:.4f} s, "
                  f"fine {row['fine']:.4f} s, wall {row['wall']:.4f} s, "
                  f"peak {row['peak_gib']:.2f} GiB (mean of {reps} runs)",
                  flush=True)
    for route, rs in rows.items():
        mean = {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
        print(f"{name}, mean {route}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in mean.items()), flush=True)


def main(reps: int = 2) -> int:
    if not torch.cuda.is_available():
        print("ablate_corr: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs  # the slices' frames, runners and points

    print(f"card: {cs.card_line()}", flush=True)
    kernel_variants(cs)
    S, size, N, shift = 8, 1024, 4096, (3, 2)
    images = cs.make_frames(S, size, shift, "cuda")
    qp = cs.query_points(N, size, 40 + S * max(shift))
    runner = cs.make_runner("bf16", "cuda")

    def drive():
        fmaps = runner.fmaps(images)
        return runner.predict_tracks(images, fmaps, [0], [qp])

    route_turns("slice (1 query frame x 4096 points)", runner, drive, reps)

    # the few-track path: every frame a query frame, 48 ALIKED points each
    few_images = cs.make_frames(S, size, shift, "cuda", seed=6)
    few = cs.make_runner("bf16", "cuda", seed=6, query_method="aliked",
                         max_query_pts=48)

    def drive_few():
        return few.predict_tracks(few_images, few.fmaps(few_images),
                                  list(range(S)))

    route_turns("few tracks (8 query frames x 48 points)", few, drive_few,
                reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

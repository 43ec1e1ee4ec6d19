#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vggsfm_tpu_torch) on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each of which must pass (the script exits non-zero otherwise and
prints no result line):

1. card: the GPU's name and power limit (nvidia-smi), then the build of
   the kernels from vggsfm_tpu_torch/csrc (nvcc, sm_90a) and its time;
2. kernels: each hand-written kernel on the card at the main path's
   shapes (the tracker's, the camera trunk's and cross-attention tails',
   and the attention probe's), in bf16 and f32, against its plain PyTorch
   version on the same inputs (each element within the stated bound:
   `err_over_bound`), with both times and the bound;
3. slice: the full-width tracker through VGGSfMRunner.predict_tracks:
   8 frames at 1024 px, 4096 query points, one query frame, 6 coarse
   iterations and fine tracking, bf16, seeded random weights with a
   non-zero flow_head. Frames are shifted crops of one seeded texture, so
   the median error against the planted shift is printed. Checks shapes,
   finite values, the pinned query frame, and that the fused kernels
   carried every transformer block (launch counters);
4. agree: the same weights at a reduced size (4 frames, 256 px, 128
   points, f32, TF32 off) on the card and on the CPU; the tracks must
   agree;
5. camera: the full-width camera slice through VGGSfMRunner: 8 frames at
   1024 px, bf16, seeded random camera weights; select_query_frames with
   query_frame_num 8 (DINOv2 descriptors, farthest-point ranking), then
   camera_init with avg_pose over the 8 orderings, one (8, 8, 336, 336, 3)
   forward. Checks the query indices, the cameras (shapes, finite,
   orthonormal rotations, frame 0 = [I | 0], principal point, focal range)
   and the kernels' launch counts per camera forward;
6. camera agree: the same camera weights at a reduced size (3 frames,
   3 orderings, 112 px predictor input, one trunk iteration, f32, TF32
   off) on the card and on the CPU; features, pose encodings and cameras
   must agree. It also prints, on the CPU alone, how far the pose
   encodings move when the frames move by one f32 ulp, after one and
   after four trunk iterations.

Then one JSON line describing each kernel, the card line again, and as the
last line {"ok": true, "device": {...}}. Needs a CUDA GPU and the repo
checkout around this file; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
# where the run's full report and profiler table go (listed in .gitignore)
OUT_DIR = os.path.join(HERE, "smoke_out")

# published dense peaks of an H100 SXM at its 700 W limit (NVIDIA data
# sheet): memory rate, bf16 tensor-core rate, f32 CUDA-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# a kernel's output against its plain version on the same inputs,
# element by element. f32: the two sum in different orders (products of
# up to 3072 terms), so 1e-4 absolute on O(1-10) outputs. bf16, two parts:
# both sides round f32 results that differ a little, so they may land on
# neighbouring bf16 values: one ulp of the output, bounded by 2 ulp of
# |ref| (ulp = 2^(e-7) for |ref| in [2^e, 2^(e+1))); and those f32 results
# differ where a rounding point (normalized input, q/k/v, probabilities,
# head outputs, GELU output) flipped an O(1-8) intermediate by its ulp,
# weighted by 0.05-scale weights: an absolute part that grows with the
# number of rows, bounded by 2^-5, about twice the largest measured (the
# `small-output` column: the max error where |ref| < 1, PERF.md).
F32_TOL = 1e-4
BF16_ATOL = 2.0 ** -5


def err_over_bound(out, ref):
    """max |out - ref| / bound over the elements (the check: <= 1), max
    |out - ref|, and max |out - ref| where |ref| < 1."""
    import torch

    err = (out.float() - ref.float()).abs()
    if ref.dtype == torch.float32:
        bound = torch.full_like(err, F32_TOL)
    else:
        _, e = torch.frexp(ref.float().abs())  # |ref| = m 2^e, m in [.5, 1)
        bound = 2 * torch.ldexp(torch.ones_like(err), e - 8) + BF16_ATOL
    small = err[ref.float().abs() < 1]
    return (float((err / bound).max()), float(err.max()),
            float(small.max()) if small.numel() else 0.0)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------- phase 2

def block_work(R, L, C, M, tsize):
    flops = R * (8 * C * C + 4 * L * C + 4 * C * M)
    nbytes = tsize * (2 * R * C + 4 * C * C + 2 * C * M + 5 * C + M)
    return flops, nbytes


def mlp_work(R, C, M, tsize):
    return R * 4 * C * M, tsize * (2 * R * C + 2 * C * M + C + M)


def attn_work(R, L, C, tsize):
    return R * (8 * C * C + 4 * L * C), tsize * (2 * R * C + 4 * C * C
                                                  + 4 * C)


def bound_ms(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def kernel_phase(report: dict) -> None:
    import torch

    from vggsfm_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=0.05):
        return torch.randn(*shape, generator=g) * scale

    # (label, kind, R, L, C, H) at the main path's shapes; L=9 is a real
    # scene's odd frame count
    cases = [
        ("coarse time block", "block", 33280, 8, 384, 8),
        ("virtual-track block", "block", 512, 64, 384, 8),
        ("fine time block", "block", 32768, 8, 256, 8),
        ("time block, 9 frames", "block", 9 * 4160, 9, 384, 8),
        ("cross-attn tail, virtual2point", "mlp", 512, 0, 384, 0),
        ("cross-attn tail, point2virtual", "mlp", 32768, 0, 384, 0),
        ("camera cross-attn tail", "mlp", 8 * 7 * 577, 0, 768, 0),
        ("camera trunk", "attn", 64, 8, 768, 8),
        ("camera trunk, R=4096", "attn", 8 * 512, 8, 768, 8),
        ("camera trunk, 9 frames", "attn", 72, 9, 768, 8),
        ("attention probe shape", "attn", 2048, 8, 384, 8),
    ]
    # the shape each kernel's JSON entry reports: its main-path shape
    main_case = {"fused_transformer_block": ("coarse time block", "bfloat16"),
                 "fused_ln_mlp": ("cross-attn tail, point2virtual",
                                  "bfloat16"),
                 "fused_ln_attn": ("camera trunk", "float32")}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        tsize = torch.tensor([], dtype=dtype).element_size()
        for label, kind, R, L, C, H in cases:
            M = 4 * C
            x = (rnd(R, C, scale=1.0) * 1.5).to("cuda", dtype)
            if kind == "block":
                ws = [rnd(3 * C, C), rnd(3 * C), rnd(C, C), rnd(C),
                      rnd(M, C), rnd(M), rnd(C, M), rnd(C)]
                ws = [w.to("cuda", dtype) for w in ws]

                def kern():
                    return fm.fused_transformer_block(x, *ws, L, H)

                def plain():
                    return fm.fused_transformer_block_ref(x, *ws, L, H)

                flops, nbytes = block_work(R, L, C, M, tsize)
                name = "fused_transformer_block"
            elif kind == "attn":
                ws = [rnd(3 * C, C), rnd(3 * C), rnd(C, C), rnd(C)]
                ws = [w.to("cuda", dtype) for w in ws]

                def kern():
                    return fm.fused_ln_attn(x, *ws, L, H)

                def plain():
                    return fm.fused_ln_attn_ref(x, *ws, L, H)

                flops, nbytes = attn_work(R, L, C, tsize)
                name = "fused_ln_attn"
            else:
                ws = [rnd(M, C), rnd(M), rnd(C, M), rnd(C)]
                ws = [w.to("cuda", dtype) for w in ws]

                def kern():
                    return fm.fused_ln_mlp(x, *ws)

                def plain():
                    return fm.fused_ln_mlp_ref(x, *ws)

                flops, nbytes = mlp_work(R, C, M, tsize)
                name = "fused_ln_mlp"
            out = kern()
            torch.cuda.synchronize()
            ref = plain()
            frac, err, err_small = err_over_bound(out, ref)
            finite = bool(torch.isfinite(out.float()).all())
            iters = 5 if R > 4096 else 20
            ms = cuda_time_ms(kern, iters)
            plain_ms = cuda_time_ms(plain, iters)
            bms, by = bound_ms(flops, nbytes, dn)
            ok = finite and frac <= 1.0
            print(f"kernel {name} [{label}] R={R} L={L} C={C} H={H} {dn}: "
                  f"max_abs_err={err:.3e} (small-output {err_small:.3e}; "
                  f"{frac:.3f} of the bound) "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} "
                  f"({by}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} [{label}] {dn}: err {err}, "
                                     f"{frac} of the bound, finite {finite}")
            if main_case[name] == (label, dn):
                report[name].update(
                    max_abs_err=err, err_over_bound=frac, ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=None)
            del x, ws, out, ref


# ------------------------------------------------------------- phase 3

def make_frames(S, size, shift, device, seed=0):
    """S frames cropped from one seeded smooth texture; frame s is the
    crop at offset s * shift (x, y), so a point (x, y) of frame 0 lies at
    (x - s * shift_x, y - s * shift_y) in frame s. The texture sums random
    cells of 64 px and, at half weight, of 16 px: blobs that random-weight
    features can match (finer noise defeats the weights-free matching)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    big = size + S * max(shift) + 8
    tex = 0
    for cell_px, weight in ((64, 1.0), (16, 0.5)):
        cells = torch.rand(1, 3, big // cell_px + 3, big // cell_px + 3,
                           generator=g)
        tex = tex + weight * F.interpolate(
            cells.to(device), size=(big, big), mode="bicubic",
            align_corners=False)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    frames = [tex[0, :, s * shift[1]: s * shift[1] + size,
                  s * shift[0]: s * shift[0] + size] for s in range(S)]
    return torch.stack(frames).permute(0, 2, 3, 1)[None].contiguous()


def make_runner(precision, device, seed=0):
    import torch

    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner

    runner = VGGSfMRunner(RunnerConfig(precision=precision, seed=seed),
                          device=device)
    # a non-zero flow head, so the formers move the tracks (a fresh
    # tracker's is zero)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for pred in (runner.tracker.coarse_predictor,
                     runner.tracker.fine_predictor):
            w = pred.updateformer.flow_head.weight
            w.copy_(torch.randn(w.shape, generator=g) * 1e-3)
    return runner


def query_points(n, size, margin, seed=0):
    import torch

    g = torch.Generator().manual_seed(seed + 2)
    return torch.rand(n, 2, generator=g) * (size - 2 * margin) + margin


def slice_phase(report: dict, launches: dict) -> None:
    """The tracker slice; `launches` gets its kernel launch counts."""
    import torch

    from vggsfm_tpu_torch.ops import fused_mlp as fm

    S, size, N, shift = 8, 1024, 4096, (3, 2)
    images = make_frames(S, size, shift, "cuda")
    qp = query_points(N, size, 40 + S * max(shift))
    runner = make_runner("bf16", "cuda")

    def drive():
        fmaps = runner.fmaps(images)
        return runner.predict_tracks(images, fmaps, [0], [qp])

    t0 = time.perf_counter()
    drive()  # first run: cuDNN algorithm search, allocator warm-up
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    runner.timings.clear()
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    tracks, vis, score = drive()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update(fm.launch_counts)
    fm.reset_launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    assert tracks.shape == (1, S, N, 2), tracks.shape
    assert vis.shape == (1, S, N) and score.shape == (1, S, N)
    for name, t in (("tracks", tracks), ("vis", vis), ("score", score)):
        assert bool(torch.isfinite(t).all()), f"non-finite {name}"
    assert torch.equal(tracks[0, 0].cpu(), qp), "query frame not pinned"
    # one coarse call (4096 <= max_points_num // S) and one fine call
    # (4096 <= max_fine_points_num // S): per coarse call 6 iterations x
    # (6 time + 6 virtual blocks) and 6 x 12 cross-attention tails, per
    # fine call 6 iterations x 4 time blocks
    want = {"fused_transformer_block": 72 + 24, "fused_ln_mlp": 72,
            "fused_ln_attn": 0}
    assert launches == want, f"launch counts {launches}, expected {want}"

    s = torch.arange(S, dtype=torch.float32)[:, None, None]
    truth = qp[None] - s * torch.tensor(shift, dtype=torch.float32)
    err = (tracks[0].float().cpu() - truth).norm(dim=-1)[1:]
    print(f"slice: tracks {tuple(tracks.shape)} in {wall:.3f} s (first run "
          f"{first_s:.3f} s); stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in runner.timings.items())
          + f"; peak memory {peak_gb:.2f} GiB; launches {launches}; "
          f"median track error vs planted shift {err.median():.3f} px, "
          f"within 1 px {float((err < 1).float().mean()):.3f}", flush=True)
    report["slice"] = {"wall_s": wall, "first_run_s": first_s,
                       "stages_s": dict(runner.timings),
                       "peak_mem_gib": peak_gb,
                       "median_err_px": float(err.median())}
    report["slice"]["profile"] = profile_slice(drive, "slice_profile.txt")


def profile_slice(drive, table_name) -> dict:
    """One more run of a slice under torch.profiler: device time by
    kernel and the device's busy share of the run's wall time. The table
    goes to smoke_out/<table_name>. Informational: the run before it is
    the one checked and timed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return _report_profile(prof.key_averages(), wall, table_name)
    except Exception as e:  # the profiler may be unavailable on a host
        print(f"profile: not available ({e!r})")
        return {}


def _report_profile(events, wall, table_name) -> dict:
    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    # device-side events only (a host op's entry repeats its kernels' time)
    kernels = sorted((ev for ev in events
                      if str(ev.device_type).endswith("CUDA")
                      and dev_us(ev) > 0), key=dev_us, reverse=True)
    busy_s = sum(dev_us(ev) for ev in kernels) / 1e6
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, table_name), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    # (the sort key's older name; newer PyTorch reads it as device time)
    top = [(ev.key[:60], dev_us(ev) / 1e3, ev.count) for ev in kernels[:8]]
    print(f"profile: wall {wall:.3f} s, device busy {busy_s:.3f} s "
          f"({busy_s / wall:.1%}); top device time:")
    for key, ms, n in top:
        print(f"  {ms:9.2f} ms  x{n:<5d} {key}")
    return {"wall_s": wall, "device_busy_s": busy_s,
            "top": [{"name": k, "ms": ms, "count": n} for k, ms, n in top]}


# ------------------------------------------------------------- phase 4

def agree_phase(report: dict) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S, size, N, shift = 4, 256, 128, (2, 1)
    images = make_frames(S, size, shift, "cpu", seed=3)
    qp = query_points(N, size, 40, seed=3)
    out = {}
    for dev in ("cuda", "cpu"):
        runner = make_runner("f32", dev, seed=3)
        fmaps = runner.fmaps(images)
        tracks, vis, score = runner.predict_tracks(images, fmaps, [0], [qp])
        out[dev] = tracks.float().cpu()
    diff = (out["cuda"] - out["cpu"]).abs()  # (1, S, N, 2)
    per_track = diff.amax(dim=(1, 3))[0]
    frac = float((per_track <= 1e-2).float().mean())
    med, mx = float(diff.median()), float(diff.max())
    # f32 on both sides, summed in other orders. The tracks pass argmax
    # steps (matching init, NCC): where two cells of a smooth map nearly
    # tie, ~1e-6 differences may pick the other cell, and the flow
    # embedding's ~1000 rad/cell frequencies amplify what is left. So:
    # 95% of the tracks within 1e-2 px in every frame, median 1e-3 px.
    ok = frac >= 0.95 and med <= 1e-3
    print(f"agree: GPU vs CPU tracks ({S} frames, {size} px, {N} points, "
          f"f32): median {med:.2e} px, max {mx:.2e} px, tracks within "
          f"1e-2 px {frac:.4f} {'ok' if ok else 'FAIL'}", flush=True)
    report["agree"] = {"median_px": med, "max_px": mx, "frac_1e-2": frac}
    if not ok:
        raise AssertionError("GPU and CPU tracks disagree")


# ------------------------------------------------------------- phase 5

def camera_phase(report: dict, launches: dict) -> None:
    """The camera slice at full width; `launches` gets its kernel launch
    counts (one camera forward)."""
    import torch

    from vggsfm_tpu_torch.ops import fused_mlp as fm
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner

    S, size = 8, 1024
    images = make_frames(S, size, (3, 2), "cuda", seed=4)
    runner = VGGSfMRunner(RunnerConfig(precision="bf16", seed=4,
                                       query_frame_num=8), device="cuda")
    t0 = time.perf_counter()
    _ = runner.camera  # seeded init on the host, then to the card
    init_s = time.perf_counter() - t0

    def drive():
        qi = runner.select_query_frames(images)
        return qi, runner.camera_init(images, qi)

    t0 = time.perf_counter()
    drive()  # first run: cuBLAS/cuDNN set-up, allocator warm-up
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    runner.timings.clear()
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    qi, (extr, intr) = drive()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update(fm.launch_counts)
    fm.reset_launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    assert len(qi) == 8 and len(set(qi)) == 8 and qi[0] == 0, qi
    assert extr.shape == (S, 3, 4) and intr.shape == (S, 3, 3)
    assert extr.dtype == intr.dtype == torch.float32
    assert bool(torch.isfinite(extr).all() and torch.isfinite(intr).all())
    R = extr[:, :, :3].double()
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    orth = float((R @ R.transpose(1, 2) - eye).abs().max())
    assert orth <= 1e-4, f"rotations off orthonormal by {orth}"
    first = float((extr[0] - torch.eye(3, 4, device=extr.device)).abs().max())
    assert first <= 1e-4, f"frame 0 off [I | 0] by {first}"
    assert torch.equal(intr[:, 0, 2].cpu(), torch.full((S,), size / 2.0))
    assert torch.equal(intr[:, 1, 2].cpu(), torch.full((S,), size / 2.0))
    focal = intr[:, [0, 1], [0, 1]]
    assert bool(((focal >= 0.2 * size) & (focal <= 5.0 * size)).all()), \
        focal
    # per camera forward: 4 iterations x 4 trunk blocks' attention halves
    # (three kernels each), 8 cross-attention tails; the ranking launches
    # none
    want = {"fused_transformer_block": 0, "fused_ln_mlp": 8,
            "fused_ln_attn": 16 * fm.ATTN_KERNELS}
    assert launches == want, f"launch counts {launches}, expected {want}"

    print(f"camera: query frames {qi}; stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in runner.timings.items())
          + f" ({wall:.3f} s; first run {first_s:.3f} s, weights init "
          f"{init_s:.1f} s); peak memory {peak_gb:.2f} GiB; launches "
          f"{launches}; rotation orthonormality {orth:.1e}; focal "
          f"{float(focal.min()):.1f}-{float(focal.max()):.1f} px",
          flush=True)
    report["camera"] = {"wall_s": wall, "first_run_s": first_s,
                        "stages_s": dict(runner.timings),
                        "peak_mem_gib": peak_gb, "query_indices": qi}
    report["camera"]["profile"] = profile_slice(drive, "camera_profile.txt")


# ------------------------------------------------------------- phase 6

def camera_agree_phase(report: dict) -> None:
    import torch

    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner
    from vggsfm_tpu_torch.utils.camera_avg import average_camera_prediction

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S, size, qi = 3, 224, [0, 1, 2]
    images = make_frames(S, size, (2, 1), "cpu", seed=5)

    def run(camera, im, iters):
        got = {}

        def forward(batch):
            with torch.inference_mode():
                got.update(camera(batch, iters=iters))
            return got["pred_pose_enc"]

        extr, intr = average_camera_prediction(
            forward, im, (size, size), query_indices=qi,
            model_input_size=112)
        return [t.float().cpu() for t in (
            got["rgb_feat_init"], got["pred_pose_enc"], extr, intr)]

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    out = {}
    for dev in ("cuda", "cpu"):
        runner = VGGSfMRunner(RunnerConfig(precision="f32", seed=5),
                              device=dev)
        camera = runner.camera
        camera.down_size = 112  # 8 x 8 patches: the reduced size
        # one trunk iteration: see the tolerance below
        out[dev] = run(camera, images.to(runner.device), 1)
    # f32 on both sides, TF32 off, summed in other orders through the
    # 12-block backbone and 8 + 8 former blocks, the trunk's attention on
    # the fused_ln_attn kernel on the card: differences of order 1e-6
    # relative, so 1e-3 relative to the larger of 1 and each output's
    # magnitude. One trunk iteration: its pose embedding reads an all-zero
    # encoding; from the second on, the harmonic embedding's frequencies
    # (up to 2^47 at hidden width 768) turn any rounding difference in the
    # encoding into an unrelated embedding. The witness below shows it on
    # the CPU alone.
    errs = {name: rel(a, b) for name, a, b in zip(
        ("features", "pose_enc", "extrinsics", "intrinsics"), out["cuda"],
        out["cpu"])}
    ok = all(e <= 1e-3 for e in errs.values())
    print(f"camera agree: GPU vs CPU ({S} frames, {len(qi)} orderings, "
          f"112 px, 1 trunk iteration, f32): relative max error "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" {'ok' if ok else 'FAIL'}", flush=True)
    # witness, not a gate: the CPU camera on the frames and on the frames
    # moved up by one f32 ulp, after 1 and after 4 trunk iterations
    nudged = torch.nextafter(images, torch.full_like(images, 2.0))
    chaos = {}
    for iters in (1, 4):
        base = out["cpu"][1] if iters == 1 else run(camera, images, 4)[1]
        chaos[iters] = rel(run(camera, nudged, iters)[1], base)
    print(f"camera agree: CPU alone, frames moved by one f32 ulp: pose "
          f"encodings relative max change after 1 trunk iteration "
          f"{chaos[1]:.2e}, after 4 {chaos[4]:.2e}", flush=True)
    report["camera_agree"] = {**errs, "cpu_ulp_nudge_pose_enc_1_iter":
                              chaos[1], "cpu_ulp_nudge_pose_enc_4_iters":
                              chaos[4]}
    if not ok:
        raise AssertionError("GPU and CPU cameras disagree")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "vggsfm_tpu_torch")):
        print("chip_smoke: run from a checkout of the repo (no "
              "vggsfm_tpu_torch/ beside this file)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    card = card_line()
    print(f"card: {card}", flush=True)
    failed = []
    report = {
        "fused_transformer_block": {
            "name": "fused_transformer_block", "route": "cuda",
            "source": "vggsfm_tpu_torch/csrc/fused_former.cu",
            "replaces": "vggsfm_tpu/ops/fused_mlp.py:143"},
        "fused_ln_mlp": {
            "name": "fused_ln_mlp", "route": "cuda",
            "source": "vggsfm_tpu_torch/csrc/fused_former.cu",
            "replaces": "vggsfm_tpu/ops/fused_mlp.py:263"},
        "fused_ln_attn": {
            "name": "fused_ln_attn", "route": "cuda",
            "source": "vggsfm_tpu_torch/csrc/fused_former.cu",
            "replaces": "vggsfm_tpu/ops/fused_mlp.py:203"},
    }
    try:
        from vggsfm_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.load_library()
        info = _build.build_info["vf_former"]
        print(f"build: {time.perf_counter() - t0:.1f} s "
              f"(nvcc {info['seconds']:.1f} s)", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: kernel build FAILED", flush=True)
        return 1

    extra = {}
    launches = {"tracker": {}, "camera": {}}  # by main-path slice
    for phase, fn in (
            ("kernels", lambda: kernel_phase(report)),
            ("slice", lambda: slice_phase(extra, launches["tracker"])),
            ("agree", lambda: agree_phase(extra)),
            ("camera", lambda: camera_phase(extra, launches["camera"])),
            ("camera agree", lambda: camera_agree_phase(extra))):
        t0 = time.perf_counter()
        try:
            fn()
            print(f"phase {phase}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception:
            traceback.print_exc()
            print(f"phase {phase}: FAILED", flush=True)
            failed.append(phase)

    for name, entry in report.items():
        by_path = {path: n.get(name, 0) for path, n in launches.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            entry.setdefault(key, None)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": list(report.values()),
                   **extra, "failed": failed}, f, indent=1)
    if failed:
        print(f"chip_smoke: failed phases {failed}", flush=True)
        return 1
    print(json.dumps({"kernels": list(report.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

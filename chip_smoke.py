#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vggsfm_tpu_torch) on one GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, each of which must pass (the script exits non-zero otherwise and
prints no result line):

1. card: the GPU's name and power limit (nvidia-smi), then the build of
   the kernels from vggsfm_tpu_torch/csrc (nvcc, sm_90a), its time, each
   kernel's registers and spills (ptxas; a correlation kernel that spills
   fails the phase), and the shared memory per block of the ring path,
   the wide MLP path, the attention half and the correlation kernel;
2. kernels: each hand-written kernel on the card at the main path's
   shapes (the tracker's, the few-track path's 896 rows, the camera
   trunk's and cross-attention tails', and the attention probe's), in
   bf16 and in f32 (an f32 block as its two halves, `fused_ln_attn` then
   `fused_ln_mlp`, as AttnBlock runs it; f32 `ln_mlp` at C <= 384, the
   wider f32 tails being plain), against its plain PyTorch version on
   the same inputs (each element within the stated bound:
   `err_over_bound`), with both
   times and the bound, the achieved TFLOP/s, the share of the bound, the
   weight bytes the blocks read from L2 under each kernel's design, and
   `composed_ms`: the same function from the fewest stock calls
   (LayerNorm, Linear, SDPA, GELU; f32 with TF32 off), a yardstick the
   port never calls (`library_ms` stays null: no single call computes
   the function); then the correlation kernel, one launch per call over
   all pyramid levels: at the few-track and odd shapes (NHWC and flat
   channel-first, f32 and bf16 maps and output, tracks inside, on and
   across every border and far outside) against `corr_sample_plain`, and
   at the tracker's two main-path calls (coarse: 8 frames x 4096 tracks,
   5 levels, C = 128; fine: 4096 x 8 track-frames, 3 levels of 31^2
   patches, C = 32, flat; bf16), each with its device time, bound and
   share, the plain version's time and the previous route's (the full-map
   product + windows; the flat full map from an f32 copy); then VGGT's
   long-sequence attention kernel against its plain route at 48 frames x
   16 heads x 1374 tokens, 16 heads x 65,952 and ragged lengths at its
   128-row and 128-key tile edges (each element within 2 bf16 ulps of
   the plain route's terms, the whole within 1e-2 relative RMS), both
   main-path shapes timed beside PyTorch's SDPA (`library_ms`);
3. slice: the full-width tracker through VGGSfMRunner.predict_tracks:
   8 frames at 1024 px, 4096 query points, one query frame, 6 coarse
   iterations and fine tracking, bf16, seeded random weights with a
   non-zero flow_head. Frames are shifted crops of one seeded texture, so
   the median error against the planted shift is printed. Checks shapes,
   finite values, the pinned query frame, and that the fused kernels
   carried every transformer block and the correlation kernel every
   correlation call (launch counters);
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

7. few tracks: 8 frames at 1024 px, bf16, every frame a query frame, the
   runner extracting 48 ALIKED points per frame (seeded weights), coarse
   and fine tracking: 8 coarse calls of 48 tracks, each 6 iterations of
   one correlation launch over 5 pyramid levels (48 `corr_sample_pallas`
   launches beside the former kernels'), 8 fine calls of 6 flat ones;
   then the fine predictor called directly on NHWC 31x31 32-channel maps
   with 16 tracks (4 iterations of one `corr_sample_pallas_smallc` launch
   over 3 levels). Checks shapes, finite values and the launch counts;
   then `track_frames` on the same frames with its re-query of the short
   frames (3 rounds, 17 coarse calls); then both against the CPU at a
   reduced size in f32 on the same query points without the matching
   init, and with it on the kernel route against the kernel's plain
   version on the card (gated) and against the CPU and the previous
   matmul route (printed: this mode's argmax steps flip between devices);
8. query points: `get_query_points_batched` on the 8 frames at 4096 points
   for 'aliked', 'sift+harris' and 'sp+sift+aliked': the time of each, the
   valid points (all inside the 4-px border), and the ALIKED score map in
   f32 (TF32 off) on the card against the CPU;
9. reconstruct: (a) the preliminary two-view cameras
   (`estimate_preliminary_cameras`, stock PyTorch) on the oracle of
   `render_two_plane_scene(8, 1024)`'s planted cameras: 32,768 points on
   its two planes projected by the port's `project_points`, 0.5 px noise,
   10% outlier tracks, at the runner's settings (1024 minimal sets,
   lo_num 128, 4 px): per pair the rotation error under 1 deg, the
   translation direction |cos| > 0.99, >= 85% of the true tracks inliers;
   the stage's time, its device operations and the device's busy share
   (torch.profiler); then GPU vs CPU at 2048 tracks, 128 sets, lo_num 16
   on the same injected samples (extrinsics within 1e-3, masks equal on
   >= 99%); (c) the SfM solve (`run_sfm`, stock PyTorch) on those oracle
   tracks from (a)'s preliminary cameras: its time by parts, host syncs
   (CUDA sync debug mode), peak memory and a device-only profile; gates:
   AUC@30 against the planted cameras >= 0.85 and >= 100 valid tracks
   (bench.py's gate, on tracks of known quality); then GPU vs CPU at 2048
   tracks with the same PnP draws (relative rotations within 0.1 deg,
   translation directions within 1 deg, masks equal on >= 99%); (b)
   `VGGSfMRunner.sparse_reconstruct` on the rendered scene at the matched
   workload (8 query frames x 4096 ALIKED points, fine tracking,
   comple_nonvis, bf16, hybrid camera init, seeded weights, the solve
   with robust_refine 2 and ba_iters 2), warm then timed: every stage's
   time (the solve by parts), the tracks, the inliers per pair, the share
   of tracks on the planted epipolar lines, the init that won, AUC@30 of
   the two-view, the chosen and the solved cameras (printed, not gated);
   gates: shapes, finite values, >= 100 valid tracks, the initial
   cameras' frame 0 at [I | 0], orthonormal rotations, the five kernels'
   launch counts per tracker call and camera forward; then the solve
   alone on that run's tracks as in (c); then `center_order` at a reduced
   size returns the caller's frame order;
10. end to end: (d) `sparse_reconstruct` at the JAX package's CPU
   end-to-end test's config (6 frames at 512 px, one query frame, 1024
   sift+harris points, f32, robust_refine 2, ba_iters 2) with its gates:
   > 50 valid tracks, AUC@30 > 0.85, median relative rotation error
   < 1.5 deg;
11. export: (e) `sparse_reconstruct` at (b)'s matched workload on the
   same scene with the export to smoke_out/export: image names, square
   crop parameters, 4096 extra grid points per frame (one per 16 px)
   tracked over all 8 frames and triangulated, appended to the model, and
   scene.glb; warm, then timed. Gates: the extra points' 8 coarse calls
   launch exactly 8 x (72 block + 72 `ln_mlp` + 6 correlation), the rest
   of the call (b)'s counts; the model read back with the port's reader
   (the valid frames under their names, tvec the translation, qvec the
   rotation within 1e-6 beyond its f32 distance from orthonormal, every
   observation is the track's pixel exactly, the
   points are the valid tracks seen at least twice with the solve's xyz
   and colors, then one trackless point per valid extra point;
   additional_points.npz and scene.glb parse); the colors on the card
   against the CPU's within 1e-5; finite values; >= 1 valid extra point.
   Prints the extra points' valid share and stage time, the host export
   alone (`save_reconstruction` on the same predictions: building the
   Reconstruction, writing the files) and the call's wall time. Then
   `triangulate_extra_points` on the card and on the CPU at a reduced
   size (4 frames, 256 px, f32, TF32 off, the same fmaps and cameras):
   without the matching init the coarse tracks gated as in the agree
   phase; with it, the matching init's argmax steps recorded on both
   devices: every pick that differs must be a near-tie under the f32
   dot-product bound C * 2^-24 * sum |products|, every forward score
   within twice its bound, the tracks that part with every pick equal
   must start within 1e-4 cells, and the CPU alone, its starts nudged by
   1e-6 cells, must part from itself on at least as many tracks (the
   coarse iterations amplify rounding-level starts); points and valid
   masks printed. Then the scene
   written as PNGs with its planted cameras as the GT model and
   `python3 -m vggsfm_tpu_torch.demo DIR --load-gt
   --glb` in a child process: AUC@30 against the GT >= 0.85, and the
   model and scene.glb it writes parse.
12. dense and visuals: (f) `DepthAnything` (DINOv2 taps + DPT head,
   seeded) on one 1024-px frame at `depth_input_size` 518 through the
   runner's `_disparity`: ViT-B in bf16 and f32 (ms per frame by CUDA
   events, peak memory, shape, finite, >= 0), ViT-B f32 on the card
   against the CPU at 140 px with TF32 off (within 1e-3 of the largest
   disparity), and DepthAnythingV2-Large (`DepthAnything.vitl()`) once in
   bf16; (g) `sparse_reconstruct` at the export phase's settings on its
   runner, on the scene's first 4 frames, with `dense_depth`,
   `visual_tracks`, `make_reproj_frames`, `visual_query_points` and
   `profile_dir`: the dense_depth and visuals stage times, each frame's
   depth inlier fraction, the depth maps read back at the original
   resolution (finite, > 0), the visual files (the mp4 where OpenCV has a
   codec), a trace naming every stage, the five kernels' launch counts
   exactly those of the counted tracker and camera calls, AUC@30 >= 0.85;
   (h) the CLI with --dense-depth
   --visual-tracks --reproj-frames --visual-query-points --profile-dir
   --load-gt in a child process: its wall time, AUC@30 >= 0.85, the
   depth maps, visuals and trace it writes;
13. video: `VideoRunner.run` (the video pipeline) at the JAX video CLI's
   defaults (512 px, initial window 32, windows of 16, joint BA every 6,
   1024 'auto' query points, one SIMPLE_RADIAL camera, midpoint ranking,
   fine tracking, bf16, seeded full-width weights), without the camera
   fill (seeded camera weights give arbitrary poses), on 144 frames of
   `render_two_plane_scene` (baseline 0.02 a frame, foreground square 0.6
   x its depth) with the export:
   `video.init`, each window's time, tracker share, retries and kernel
   launches per window call, `video.joint_ba`, the registered frames,
   points and observations, AUC@30 against the planted cameras, peak
   memory. Gates: every frame registered, AUC@30 >= 0.85, finite outputs,
   the five kernels' launch counts exactly as the counted coarse, fine and
   camera calls predict, the exported model read back equal to the
   predictions. Then the CLI's default configuration, the camera fill
   on, on the first 48 frames (the initial window and one window whose
   unregistered frames take the camera predictor's poses aligned onto the
   map): every frame registered, finite outputs, the fill run, the launch
   counts exact with the fill's camera forwards; each kernel's inputs are
   recorded at every shape this run gives it (the time blocks at L = 17
   and 32, 2048-track windows, 128 x 128 maps, the camera at L = 17 and
   32) and held against its plain version there afterwards, with the
   kernel phases' bounds; `bundle_adjust_sparse` on the card against the
   CPU at
   a reduced size (f32, TF32 off); a device-only profile of the pipeline
   on the first 48 frames; `python3 -m vggsfm_tpu_torch.video_demo` on
   the first 32 frames as PNGs (--init-window 16 --window 8) in a child
   process (every frame registered); and two such processes as the hosts
   of one multi-host run (--num-hosts 2, a shared exchange folder): their
   initial maps equal, every frame registered. The last joint BA's inputs
   are kept for phase 15.
14. imc: a synthetic IMC tree in smoke_out/imc_tree (one location,
   set_100/{images,calibration,sub_set}: 25 frames of
   `render_two_plane_scene` at 1024 px, baseline 0.06 a frame, cropped to
   1024 x 768 with the principal point moved, JPEG quality 95; .npz
   calibrations of the planted cameras; bag lists 5bag_000, 10bag_000 and
   25bag_000 spread over the sequence); `python3 -m
   vggsfm_tpu_torch.imc_eval` at its defaults (1024 px, 3 query frames,
   4096 ALIKED points, fine tracking, seeded weights) with the submission
   and the packed scenes, in a child process: the wall, stage times and
   AUC@30 of each bag; gates: AUC@30 >= 0.85 and >= 100 valid tracks per
   bag, the files read back (`load_scene_submission`), each packed model
   equal to the poses and keypoints written. Then each bag in this process
   on a runner of the CLI's configuration with the kernels' inputs
   recorded: launch counts exact per bag (`expected_launches`), the packed
   model equal to the predictions; a device-only profile of the 25-frame
   bag (smoke_out/imc_profile.txt); every kernel against its plain version
   at each recorded shape (the time blocks and the camera at L = 5, 10
   and 25); `estimate_essential`, `estimate_homography` and
   `absolute_pose_ransac(refine="epnp")` on the card against the CPU on
   the same draws at the JAX package's defaults (4 pairs of 4096
   correspondences), each timed on the card with its host syncs.
15. multi-device: (a) `sharded_track_and_reconstruct` (the sharded
   pipeline step: Harris queries, the CNN on each rank's frames, the
   coarse predictor on each rank's tracks with the virtual tracks'
   attention combined over the ranks, the NHWC fine path with the
   channel-first correlation pyramid and the NCC polish, the preliminary
   cameras, triangulation and BA with the points sharded) at 8 frames x
   1024 px, 4096 Harris points, bf16, seeded weights: on a one-rank NCCL
   group in this process, then on two gloo ranks sharing cuda:0 in
   spawned processes; each side warm, then timed. Gates: finite outputs,
   >= 100 valid points, the final BA cost <= the initial, exact launch
   counts per rank (one coarse and one fine call: 96 block, 72 `ln_mlp`,
   6 + 6 correlation launches), the two ranks' tracks within 1e-2 px of
   the one rank's on >= 99% of the tracks and the BA cost within 1e-3
   relative, both ranks' outputs equal; every kernel against its plain
   version at each shape the one-rank run and rank 0's block gave it
   (the time blocks at R = (2048 + 64) x 8, the channel-first fine
   correlation); each side's time and AUC@30 against the planted cameras
   printed. (b) `distributed_bundle_adjust` on the two ranks on the card
   against `bundle_adjust_sparse` on the card at the video run's last
   joint BA: cost within 1e-3 relative, poses 1e-2, points 5e-2 (the
   sparse BA's card-vs-CPU bounds), both times. (c) `python3 -m
   vggsfm_tpu_torch.video_demo --distributed-ba 2 --dist-backend gloo` as
   two ranks (VGGSFM_COORDINATOR / VGGSFM_NUM_PROCESSES /
   VGGSFM_PROCESS_ID) on the 48-frame folder, each writing its own model:
   every frame registered, the two models byte-equal.
16. vggt: `VGGTRunner.reconstruct` (VGGT-1B feed-forward, published
   widths, seeded weights) on 48 frames at 518 px, warm, then timed:
   finite cameras and depth, the kept points min(100,000, pixels with
   confidence >= 5), launch counts exact (72 of the attention kernel, no
   other kernel of the port), stage times and peak memory.

Then one JSON line describing each kernel, the card line again, and as the
last line {"ok": true, "device": {...}}. Needs a CUDA GPU and the repo
checkout around this file; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
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


def ptxas_report(log: str):
    """(kernel, 'N registers, S bytes spill stores, L bytes spill loads')
    for each entry function in nvcc's -Xptxas -v output, names demangled
    by c++filt where the host has it."""
    import re

    out, name, props = [], None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, props = m.group(1), {}
            out.append((name, props))
        elif name and "spill" in line:
            props["spill"] = line.strip()
        elif name and "Used" in line:
            props["used"] = re.sub(r".*Used", "Used", line).strip()
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in out),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) != len(out):
        names = [n for n, _ in out]
    return [(re.sub(r"\(.*", "", pretty),
             f"{p.get('used', '?')}; {p.get('spill', '?')}")
            for pretty, (_, p) in zip(names, out)]


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


def _dev_us(ev):
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def device_time_ms(fn, iters: int, match: str):
    """Device time per launch of the kernels whose name contains `match`,
    from torch.profiler over `iters` calls of fn: what the kernel takes on
    the card, where `cuda_time_ms` of a microsecond kernel reads the host's
    launch rate. None where the profiler traces no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if match in ev.key and _dev_us(ev) > 0]
        n = sum(ev.count for ev in evs)
        return sum(_dev_us(ev) for ev in evs) / 1e3 / n if n else None
    except Exception as e:  # the profiler may be unavailable on a host
        print(f"profile: not available ({e!r})")
        return None


def device_ms_per_call(fn, iters: int):
    """Device time per call of fn, all its kernels summed (torch.profiler):
    what a call of several kernels takes on the card, apart from the
    host's launch rate. None where the profiler traces no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(_dev_us(ev) for ev in prof.key_averages())
        return us / 1e3 / iters if us > 0 else None
    except Exception as e:  # the profiler may be unavailable on a host
        print(f"profile: not available ({e!r})")
        return None


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


def weight_traffic(kind, R, L, C, M, dtype, lib, sms):
    """(what, bytes) of the weight matrices the blocks of one launch read
    from L2, biases left out: every whole-row block reads every weight
    once; on the wide MLP path each 128-row tile reads w1 and w2 once
    (fc1 and fc2 tiles together); in the CUDA-core GEMMs (the attention
    half's, and f32 ln_mlp's) each row tile (cc_tile: 64 or 16 rows)
    reads its product's weight once. An f32 block runs as the two
    halves: their sum."""
    import torch

    tsize = torch.tensor([], dtype=dtype).element_size()
    f32 = dtype == torch.float32

    def cc(N, K):  # row tiles of an (R x N) product, bytes of its weight
        return -(-R // (16 * (lib.vf_cc_tile(R, N, sms) // 10))), \
            tsize * N * K

    if kind == "block" and f32:
        wa, ba = weight_traffic("attn", R, L, C, M, dtype, lib, sms)
        wm, bm = weight_traffic("mlp", R, L, C, M, dtype, lib, sms)
        return f"attention half {wa} + MLP tail {wm}", ba + bm
    if kind == "block":
        n, w = -(-R // ((64 // L) * L)), tsize * (4 * C * C + 2 * C * M)
        return f"{n} blocks x {w} B", n * w
    if kind == "attn" or f32:
        (nq, wq), (no, wo) = ((cc(3 * C, C), cc(C, C)) if kind == "attn"
                              else (cc(M, C), cc(C, M)))
        first, second = (("q|k|v", "out-projection") if kind == "attn"
                         else ("fc1", "fc2"))
        return (f"{first} {nq} row tiles x {wq} B + {second} {no} x "
                f"{wo} B", nq * wq + no * wo)
    rows = 128 if C > 384 else 64
    n, w = -(-R // rows), tsize * 2 * C * M
    return f"{n} {rows}-row tiles x {w} B", n * w


def composed_mlp(x, w1, b1, w2, b2):
    """x + fc2(gelu(fc1(LN(x)))) from stock calls: a yardstick, printed
    only; the port never calls it."""
    import torch.nn.functional as F

    h = F.gelu(F.linear(F.layer_norm(x, (x.shape[1],), eps=1e-6), w1, b1))
    return x + F.linear(h, w2, b2)


def composed_attn(x, w_in, b_in, w_out, b_out, L, H):
    """LN(x) + out_proj(MHA(LN(x))) from stock calls (LayerNorm, Linear,
    SDPA over (R / L, H, L, D), Linear) with the normalized residual: a
    yardstick, printed only; the port never calls it."""
    import torch.nn.functional as F

    R, C = x.shape
    xn = F.layer_norm(x, (C,), eps=1e-6)
    q, k, v = F.linear(xn, w_in, b_in).view(R // L, L, 3, H, C // H).permute(
        2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v)
    return xn + F.linear(o.transpose(1, 2).reshape(R, C), w_out, b_out)


def composed_block(x, w_in, b_in, w_out, b_out, w1, b1, w2, b2, L, H):
    """The block from stock calls (`composed_attn`, then `composed_mlp`):
    a yardstick, printed only; the port never calls it."""
    return composed_mlp(composed_attn(x, w_in, b_in, w_out, b_out, L, H),
                        w1, b1, w2, b2)


def bound_ms(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def kernel_phase(report: dict, extra: dict) -> None:
    import torch

    from vggsfm_tpu_torch.ops import _build
    from vggsfm_tpu_torch.ops import fused_mlp as fm

    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
        ("few-track time block", "block", 896, 8, 384, 8),
        ("cross-attn tail, virtual2point", "mlp", 512, 0, 384, 0),
        ("cross-attn tail, point2virtual", "mlp", 32768, 0, 384, 0),
        ("few-track cross-attn tail", "mlp", 896, 0, 384, 0),
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
    rows = extra.setdefault("block_mlp_cases", [])
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        tsize = torch.tensor([], dtype=dtype).element_size()
        for label, kind, R, L, C, H in cases:
            if dtype == torch.float32 and kind == "mlp" and C > fm.MAX_C:
                continue  # f32 tails wider than 384 run plain
            M = 4 * C
            x = (rnd(R, C, scale=1.0) * 1.5).to("cuda", dtype)
            if kind == "block":
                ws = [rnd(3 * C, C), rnd(3 * C), rnd(C, C), rnd(C),
                      rnd(M, C), rnd(M), rnd(C, M), rnd(C)]
                ws = [w.to("cuda", dtype) for w in ws]

                def kern():
                    if dtype == torch.float32:  # the two halves
                        return fm.fused_ln_mlp(
                            fm.fused_ln_attn(x, *ws[:4], L, H), *ws[4:])
                    return fm.fused_transformer_block(x, *ws, L, H)

                def plain():
                    return fm.fused_transformer_block_ref(x, *ws, L, H)

                def composed():
                    return composed_block(x, *ws, L, H)

                flops, nbytes = block_work(R, L, C, M, tsize)
                name = "fused_transformer_block"
            elif kind == "attn":
                ws = [rnd(3 * C, C), rnd(3 * C), rnd(C, C), rnd(C)]
                ws = [w.to("cuda", dtype) for w in ws]

                def kern():
                    return fm.fused_ln_attn(x, *ws, L, H)

                def plain():
                    return fm.fused_ln_attn_ref(x, *ws, L, H)

                def composed():
                    return composed_attn(x, *ws, L, H)

                flops, nbytes = attn_work(R, L, C, tsize)
                name = "fused_ln_attn"
            else:
                ws = [rnd(M, C), rnd(M), rnd(C, M), rnd(C)]
                ws = [w.to("cuda", dtype) for w in ws]

                def kern():
                    return fm.fused_ln_mlp(x, *ws)

                def plain():
                    return fm.fused_ln_mlp_ref(x, *ws)

                def composed():
                    return composed_mlp(x, *ws)

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
            # the camera's multi-kernel calls: their device time too
            dev_ms = (device_ms_per_call(kern, iters) if kind == "attn"
                      or label == "camera cross-attn tail" else None)
            ok = finite and frac <= 1.0
            line = (f"kernel {name} [{label}] R={R} L={L} C={C} H={H} {dn}: "
                    f"max_abs_err={err:.3e} (small-output {err_small:.3e}; "
                    f"{frac:.3f} of the bound) "
                    f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} "
                    f"({by})")
            if dev_ms is not None:
                line += f" device_ms={dev_ms:.4f} (profiler, its kernels)"
            # achieved rate, share of the bound, the weights the blocks
            # read from L2, and the stock-call yardstick (f32: TF32 off)
            what, wbytes = weight_traffic(kind, R, L, C, M, dtype, lib, sms)
            line += (f" {flops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.1%} of "
                     f"the bound; L2 weight traffic {what} = "
                     f"{wbytes / 1e9:.3f} GB")
            torch.backends.cuda.matmul.allow_tf32 = False
            comp_ms = cuda_time_ms(composed, iters)
            comp_err = float((composed().float() - ref.float()).abs().max())
            line += (f"; composed_ms={comp_ms:.4f} (stock {dn} calls, "
                     f"max |composed - plain| {comp_err:.3e})")
            rows.append({"name": name, "case": label, "dtype": dn,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                         "tflops": flops / ms / 1e9,
                         "l2_weight_bytes": wbytes,
                         "composed_ms": comp_ms, "device_ms": dev_ms,
                         "max_abs_err": err, "err_over_bound": frac})
            print(f"{line} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{name} [{label}] {dn}: err {err}, "
                                     f"{frac} of the bound, finite {finite}")
            if main_case[name] == (label, dn):
                report[name].update(
                    max_abs_err=err, err_over_bound=frac, ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=None, composed_ms=comp_ms, device_ms=dev_ms)
            del x, ws, out, ref


# ------------------------------------------------- phase 2, correlation

# The correlation kernel sums exact products in f32 (bf16 maps and features
# are widened on load) and so does its plain version: they differ by the
# order of up to (2r+2)^2 x 600-term f32 sums of O(1-30) values, from f32
# and from bf16 inputs alike. f32 output: 1e-4 absolute on each element;
# bf16 output: one rounding of the plain f32 value (half a bf16 ulp of
# it) plus that 1e-4.
CORR_TOL = 1e-4


def corr_err(out, ref):
    """(max |out - ref|, max of |out - ref| / its bound); ref: the plain
    version's f32 result."""
    import torch

    err = (out.float() - ref).abs()
    if out.dtype == torch.float32:
        bound = torch.full_like(err, CORR_TOL)
    else:
        _, e = torch.frexp(ref.abs())
        bound = torch.ldexp(torch.ones_like(ref), e - 9) + CORR_TOL
    return float(err.max()), float((err / bound).max())


def corr_inputs(g, F, dims, C, N, dtype, flat=False, spread=None):
    """A pyramid of len(dims) levels (NHWC, or views of flat channel-first
    storage), positions and features on the card. Positions are uniform
    over `spread` (lo, hi) cells at level 0, or over the map and a 6-cell
    margin, the first ones on integer cells, on and across every border
    and far outside."""
    import torch

    levels = []
    for H, W in dims:
        if flat:
            x = torch.randn(F, C, H * W, generator=g).to("cuda", dtype)
            levels.append(x.view(F, C, H, W).permute(0, 2, 3, 1))
        else:
            levels.append(torch.randn(F, H, W, C, generator=g).to("cuda",
                                                                  dtype))
    H, W = dims[0]
    lo, hi = spread or (-6.0, W + 6.0)
    coords = torch.rand(F, N, 2, generator=g) * (hi - lo) + lo
    if spread is None:
        edge = torch.tensor([[3.0, 4.0], [-0.0, 0.0], [-1.0, H - 1.0],
                             [W - 0.5, -0.25], [W + 2.5, H + 3.0],
                             [-300.0, 5.0], [7.0, 1e6]])
        coords[:, :min(N, len(edge))] = edge[:N]
    feats = torch.randn(F, N, C, generator=g).to("cuda", dtype)
    return levels, coords.cuda(), feats


def corr_work(levels, coords, radius, out_dtype):
    """Operations and bytes this call's data needs: each map cell under a
    window read once (cells outside the map are not read; a cell under
    several windows counts once), the features and positions once, the
    taps written once; two operations per map value and window, eight per
    tap."""
    import torch

    from vggsfm_tpu_torch.ops.corr import window_index

    F, N = coords.shape[:2]
    C = levels[0].shape[-1]
    cells = inmap = 0
    for i, lvl in enumerate(levels):
        H, W = lvl.shape[1:3]
        idx, ok, _ = window_index(coords / 2.0 ** i, radius, H, W)
        frame = torch.arange(F, device=idx.device)[:, None, None] * (H * W)
        cells += int(torch.unique((idx + frame)[ok]).numel())
        inmap += int(ok.sum())
    taps = len(levels) * (2 * radius + 1) ** 2
    tsize = levels[0].element_size()
    osize = torch.tensor([], dtype=out_dtype).element_size()
    nbytes = cells * C * tsize + F * N * (C * tsize + 8 + taps * osize)
    flops = 2 * inmap * C + 8 * F * N * taps
    return flops, nbytes


def corr_kernel_phase(report: dict, extra: dict) -> None:
    import torch

    from vggsfm_tpu_torch.models import tracker as ttr
    from vggsfm_tpu_torch.ops import corr as tc
    from vggsfm_tpu_torch.tools.ablate_corr import (
        previous_corr_sample,
        previous_corr_sample_flat,
    )

    g = torch.Generator().manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    coarse = [(128 >> i, 128 >> i) for i in range(5)]
    fine = [(31, 31), (15, 15), (7, 7)]
    # (label, F, level sizes, C, r, N, maps, output, flat) at the few-track
    # path's and the odd shapes: every variant, tracks across the borders
    cases = [
        ("coarse few-track call", 8, coarse, 128, 4, 48, bf16, bf16, False),
        ("coarse few-track call, f32", 8, coarse, 128, 4, 63, f32, f32,
         False),
        ("coarse level 4 (8x8) alone", 8, coarse[4:], 128, 4, 63, f32, f32,
         False),
        ("fine NHWC call", 8, fine, 32, 3, 16, bf16, bf16, False),
        ("fine NHWC call, f32 out", 8, fine, 32, 3, 16, bf16, f32, False),
        ("fine NHWC call, 1 track", 8, fine, 32, 3, 1, f32, f32, False),
        ("fine flat, 64 track-frames", 64, fine, 32, 3, 1, bf16, bf16, True),
        ("fine flat, f32", 64, fine, 32, 3, 1, f32, f32, True),
        ("odd width C=33", 2, [(12, 14), (6, 7)], 33, 1, 7, f32, f32, False),
        ("wide C=600", 2, [(20, 24), (10, 12)], 600, 4, 70, f32, bf16,
         False),
    ]
    for label, F, dims, C, r, N, dt, odt, flat in cases:
        levels, coords, feats = corr_inputs(g, F, dims, C, N, dt, flat)
        out = tc.corr_sample_kernel(levels, coords, feats, r, odt)
        torch.cuda.synchronize()
        ref = tc.corr_sample_plain(levels, coords, feats, r)
        err, frac = corr_err(out, ref)
        # the window far outside the map: zeros, not a shifted window
        far_ok = N < 6 or not bool(out[:, 5].any())
        ms = cuda_time_ms(
            lambda: tc.corr_sample_kernel(levels, coords, feats, r, odt), 50)
        plain_ms = cuda_time_ms(
            lambda: tc.corr_sample_plain(levels, coords, feats, r, odt), 10)
        bms, by = bound_ms(*corr_work(levels, coords, r, odt), "float32")
        ok = (bool(torch.isfinite(out.float()).all()) and frac <= 1.0
              and far_ok and out.dtype == odt)
        print(f"kernel corr_sample [{label}] F={F} L={len(dims)} "
              f"{dims[0][0]}x{dims[0][1]} C={C} r={r} N={N} "
              f"{str(dt)[6:]} -> {str(odt)[6:]}: max_abs_err={err:.3e} "
              f"({frac:.3f} of the bound) ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} bound_ms={bms:.5f} ({by}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"corr_sample [{label}]: err {err}, "
                                 f"{frac} of the bound, far window zero "
                                 f"{far_ok}")
        del levels, coords, feats, out, ref

    # the tracker's two calls per iteration at the slice's shapes (bf16
    # maps and output): the kernel against its plain version, its device
    # time beside the bound, and the route each call took before
    rows = extra.setdefault("corr_main_path", {})
    for name, label, F, dims, C, r, N, flat, spread in (
            ("corr_sample_pallas", "coarse call, 8 frames x 4096 tracks",
             8, coarse, 128, 4, 4096, False, (0.0, 128.0)),
            ("corr_sample_pallas_smallc",
             "fine flat call, 4096 x 8 track-frames", 4096 * 8, fine, 32, 3,
             1, True, (11.0, 19.0))):
        levels, coords, feats = corr_inputs(g, F, dims, C, N, bf16, flat,
                                            spread)
        out = tc.corr_sample_kernel(levels, coords, feats, r, bf16)
        torch.cuda.synchronize()
        ref = tc.corr_sample_plain(levels, coords, feats, r)
        err, frac = corr_err(out, ref)
        del ref

        def kern():
            return tc.corr_sample_kernel(levels, coords, feats, r, bf16)

        def plain():
            return tc.corr_sample_plain(levels, coords, feats, r, bf16)

        # the same call as the tracker makes it, in its (B, S, ...) layout,
        # through the kernel route and through the previous one
        if flat:
            B, S = coords.shape[0] // 8, 8
            pyr = [lv.permute(0, 3, 1, 2).reshape(B, S, C, -1)
                   for lv in levels]
            args = (pyr, dims, coords.reshape(B, S, N, 2),
                    feats.reshape(B, S, N, C), r)

            def route():
                return ttr.corr_sample_flat(*args)

            def previous():
                return previous_corr_sample_flat(*args)
        else:
            pyr = [lv[None] for lv in levels]
            args = (pyr, coords[None], feats[None], r)

            def route():
                return ttr.corr_sample(*args)

            def previous():
                return previous_corr_sample(*args)

        prev_err = float((previous().float()
                          - route().float()).abs().max())
        ms = cuda_time_ms(kern, 20)
        dev_ms = device_time_ms(kern, 20, "vcorr")
        plain_ms = cuda_time_ms(plain, 3)
        route_ms = cuda_time_ms(route, 10)
        prev_ms = cuda_time_ms(previous, 5)
        prev_dev_ms = device_ms_per_call(previous, 5)
        flops, nbytes = corr_work(levels, coords, r, bf16)
        bms, by = bound_ms(flops, nbytes, "float32")
        ok = frac <= 1.0
        share = bms / dev_ms if dev_ms else None
        print(f"kernel {name} [{label}] L={len(dims)} C={C} r={r} bf16: "
              f"max_abs_err={err:.3e} ({frac:.3f} of the bound) "
              f"device_ms={dev_ms} ms={ms:.4f} "
              f"bound_ms={bms:.5f} ({by}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB) share={share} plain_ms="
              f"{plain_ms:.4f} tracker route ms={route_ms:.4f}; previous "
              f"route ms={prev_ms:.4f} (device {prev_dev_ms}; max difference "
              f"{prev_err:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} [{label}]: err {err}, {frac} of "
                                 f"the bound")
        report[name].update(max_abs_err=err, err_over_bound=frac, ms=ms,
                            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            library_ms=None, device_ms=dev_ms,
                            previous_route_ms=prev_ms)
        rows[name] = {"case": label, "device_ms": dev_ms, "ms": ms,
                      "bound_ms": bms, "bound_by": by, "share": share,
                      "plain_ms": plain_ms, "tracker_route_ms": route_ms,
                      "previous_route_ms": prev_ms,
                      "previous_route_device_ms": prev_dev_ms,
                      "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
        del levels, coords, feats, out, pyr, args


def attention_kernel_phase(report: dict) -> None:
    """The long-sequence attention kernel (csrc/flash_attn.cu, VGGT's
    frame and global blocks) against its plain route at the main path's
    shapes, 48 frames x 16 heads of 1374 tokens and 16 heads of 65,952,
    and ragged lengths at the kernel's 128-row and 128-key tile edges and
    past its 4-stage ring: each output within 2 bf16 ulps of the plain
    route's terms, and the whole within 1e-2 relative RMS of it (at L =
    65,952 an output's terms are as large as its RMS, so the first bound
    alone would let a kernel drop 1% of the keys; the second reads ~0.1
    then); both shapes of the main path timed, with PyTorch's SDPA on the
    same inputs as the yardstick (`library_ms`; the port never calls
    it)."""
    import torch
    import torch.nn.functional as F

    from vggsfm_tpu_torch.ops import _build
    from vggsfm_tpu_torch.ops.attention import attention_plain, \
        flash_attention

    _build.load_library()
    log = _build.build_info["vf_former"]["log"]
    for kname, props in ptxas_report(log):
        if "attn_kernel" in kname and "vfa" in kname:
            print(f"  ptxas: {kname}: {props}")
    for line in log.splitlines():
        if "flash_attn" in line or "wgmma" in line or "setmaxnreg" in line:
            print(f"  nvcc: {line.strip()}")
    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(BH, L):
        return [torch.randn(BH, L, 64, generator=g, device="cuda")
                .bfloat16() for _ in range(3)]

    for B, H, L in ((48, 16, 1374), (1, 16, 65952), (1, 2, 65), (3, 1, 1),
                    (1, 2, 127), (1, 2, 129), (2, 3, 257), (1, 2, 700)):
        q, k, v = inputs(B * H, L)
        out = flash_attention(q, k, v, B).float()
        want = attention_plain(q, k, v, B).float()
        mag = attention_plain(q, k, v.abs(), B).float()
        frac = float(((out - want).abs()
                      / (2.0 ** -7 * (want.abs() + mag) + 1e-6)).max())
        rms = float((out - want).double().square().mean().sqrt()
                    / want.double().square().mean().sqrt())
        ok = frac <= 1 and rms <= 1e-2
        print(f"kernel flash_attention [B={B} H={H} L={L}] err/bound="
              f"{frac:.3f} rel_rms={rms:.2e} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"flash_attention at B={B} H={H} L={L}: "
                                 f"err/bound {frac}, relative RMS {rms}")
        del q, k, v, out, want, mag
    entry = report["flash_attention"]
    for B, H, L in ((48, 16, 1374), (1, 16, 65952)):
        q, k, v = inputs(B * H, L)
        ms = cuda_time_ms(lambda: flash_attention(q, k, v, B), 5)
        qs, ks, vs = (t.view(B, H, L, 64) for t in (q, k, v))
        lib_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qs, ks, vs), 5)
        scores = B * H * L * L
        bms = 1e3 * max(4 * 64 * scores / 989e12, scores / 3.9e12,
                        8 * B * H * L * 64 / 3.35e12)
        print(f"kernel flash_attention [B={B} H={H} L={L}] ms={ms:.3f} "
              f"bound_ms={bms:.3f} share={100 * bms / ms:.1f}% "
              f"TFLOP/s={4 * 64 * scores / ms / 1e9:.1f} "
              f"library_ms={lib_ms:.3f} (SDPA)", flush=True)
        entry.update(ms=ms, bound_ms=bms, bound_by="operations",
                     library_ms=lib_ms)
        del q, k, v, qs, ks, vs


def vggt_phase(report: dict, launches: dict) -> None:
    """VGGT-1B's feed-forward reconstruction at its published widths:
    `VGGTRunner.reconstruct` on 48 frames at 518 px (a two-plane render),
    seeded weights, warm, then timed with the kernels' launch counts into
    `launches`: the attention kernel carries every attention of the
    aggregator (24 DINOv2 and 24 frame blocks over 48 frames x 16 heads
    of 1374 tokens, 24 global blocks over 16 heads of 65,952) and no other
    kernel of the port runs. Gates: finite cameras and depth, the kept
    points min(100,000, pixels with confidence >= 5)."""
    import torch

    from vggsfm_tpu_torch.ops import fused_mlp as fm
    from vggsfm_tpu_torch.utils.synth import render_two_plane_scene
    from vggsfm_tpu_torch.vggt import VGGTRunner

    S, size = 48, 518
    scene = render_two_plane_scene(S, size, 11, baseline=0.03,
                                   fg_half_extent_frac=0.5)
    images = torch.as_tensor(scene["images"]).cuda()
    t0 = time.perf_counter()
    runner = VGGTRunner(device="cuda")
    init_s = time.perf_counter() - t0
    runner.reconstruct(images)  # first run: cuBLAS/cuDNN set-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    out = runner.reconstruct(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update(fm.launch_counts)
    fm.reset_launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    for key in ("extrinsics", "intrinsics", "depth", "depth_conf",
                "points3d"):
        assert bool(torch.isfinite(out[key]).all()), f"{key} not finite"
    cand = int((out["depth_conf"] >= runner.cfg.conf_thres).sum())
    kept = out["points3d"].shape[0]
    assert kept == min(runner.cfg.max_points, cand) > 0, (kept, cand)
    want = {name: 0 for name in fm.launch_counts}
    want["flash_attention"] = 3 * 24
    assert launches == want, f"launch counts {launches}, expected {want}"
    print(f"vggt: {S} frames at {size} px in {wall:.3f} s "
          f"({S / wall:.2f} frames/s; weights {init_s:.1f} s); stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in out["timings"].items())
          + f"; peak {peak_gb:.2f} GiB; points {kept} of {cand}; "
          f"launches {launches}", flush=True)
    report["vggt"] = {"frames": S, "size": size, "wall_s": wall,
                      "timings": out["timings"], "peak_gib": peak_gb,
                      "points": kept, "candidates": cand}


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


def make_runner(precision, device, seed=0, **cfg):
    import torch

    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner

    runner = VGGSfMRunner(RunnerConfig(precision=precision, seed=seed,
                                       **cfg), device=device)
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
    # (6 time + 6 virtual blocks), 6 x 12 cross-attention tails and one
    # correlation launch per iteration (all 5 levels); per fine call 6
    # iterations x 4 time blocks and one flat correlation launch (3 levels)
    want = {"fused_transformer_block": 72 + 24, "fused_ln_mlp": 72,
            "fused_ln_attn": 0, "corr_sample_pallas": 6,
            "corr_sample_pallas_smallc": 6, "flash_attention": 0}
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


def profile_slice(drive, table_name, host=True) -> dict:
    """One more run of a slice under torch.profiler: device time by
    kernel, the device's busy share of the run's wall time and its number
    of device operations (kernel launches and copies). The table goes to
    smoke_out/<table_name>. `host=False` traces the device alone: reading
    the host's op events of a 100k-launch run takes most of a minute.
    Informational: the run before it is the one checked and timed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CPU] if host else []) + [
        ProfilerActivity.CUDA]
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            drive()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return _report_profile(prof.key_averages(), wall, table_name)
    except Exception as e:  # the profiler may be unavailable on a host
        print(f"profile: not available ({e!r})")
        return {}


def _report_profile(events, wall, table_name) -> dict:
    # device-side events only (a host op's entry repeats its kernels' time)
    kernels = sorted((ev for ev in events
                      if str(ev.device_type).endswith("CUDA")
                      and _dev_us(ev) > 0), key=_dev_us, reverse=True)
    busy_s = sum(_dev_us(ev) for ev in kernels) / 1e6
    ops = sum(ev.count for ev in kernels)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, table_name), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    # (the sort key's older name; newer PyTorch reads it as device time)
    # the eight largest, and the correlation kernel wherever it stands
    shown = kernels[:8] + [ev for ev in kernels[8:] if "vcorr" in ev.key]
    top = [(ev.key[:60], _dev_us(ev) / 1e3, ev.count) for ev in shown]
    print(f"profile: wall {wall:.3f} s, device busy {busy_s:.3f} s "
          f"({busy_s / wall:.1%}), {ops} device operations; top device "
          f"time:")
    for key, ms, n in top:
        print(f"  {ms:9.2f} ms  x{n:<5d} {key}")
    return {"wall_s": wall, "device_busy_s": busy_s, "device_ops": ops,
            "top": [{"name": k, "ms": ms, "count": n} for k, ms, n in top]}


# ------------------------------------------------------------- phase 4

def track_agreement(a, b):
    """(median, max, share of tracks within 1e-2 px in every frame) of
    |a - b| over (1, S, N, 2) tracks."""
    diff = (a - b).abs()
    per_track = diff.amax(dim=(1, 3))[0]
    return (float(diff.median()), float(diff.max()),
            float((per_track <= 1e-2).float().mean()))


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
    med, mx, frac = track_agreement(out["cuda"], out["cpu"])
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
    # (ATTN_KERNELS kernels each), 8 cross-attention tails (the wide MLP
    # path's WIDE_MLP_KERNELS each); the ranking launches none
    want = {"fused_transformer_block": 0,
            "fused_ln_mlp": 8 * fm.WIDE_MLP_KERNELS,
            "fused_ln_attn": 16 * fm.ATTN_KERNELS, "corr_sample_pallas": 0,
            "corr_sample_pallas_smallc": 0, "flash_attention": 0}
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


# ------------------------------------------------------------- phase 7

def few_tracks_phase(report: dict, launches: dict) -> None:
    """Few-track tracking with the runner's own query points; `launches`
    gets the kernel launch counts of the run and the fine call."""
    import torch

    from vggsfm_tpu_torch.ops import fused_mlp as fm

    S, size, K, shift = 8, 1024, 48, (3, 2)
    images = make_frames(S, size, shift, "cuda", seed=6)
    runner = make_runner("bf16", "cuda", seed=6, query_method="aliked",
                         max_query_pts=K)
    frames = list(range(S))
    g = torch.Generator().manual_seed(7)
    # the fine predictor's NHWC route: 31x31 32-channel maps, 16 tracks
    fine_maps = torch.randn(1, S, 31, 31, 32, generator=g).cuda()
    fine_qp = (torch.rand(1, 16, 2, generator=g) * 24 + 3).cuda()
    fine_iters = 4

    def drive():
        fmaps = runner.fmaps(images)
        out = runner.predict_tracks(images, fmaps, frames)
        preds, _ = runner.tracker.fine_predictor(fine_qp, fine_maps,
                                                 iters=fine_iters)
        return out, preds[-1]

    t0 = time.perf_counter()
    with torch.inference_mode():
        drive()  # first run: cuDNN algorithm search, the extractor's init
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0

        runner.timings.clear()
        torch.cuda.reset_peak_memory_stats()
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        (tracks, vis, score), fine_tracks = drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches.update(fm.launch_counts)
    fm.reset_launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    P = S * K
    assert tracks.shape == (1, S, P, 2), tracks.shape
    assert vis.shape == (1, S, P) and score.shape == (1, S, P)
    assert fine_tracks.shape == (1, S, 16, 2), fine_tracks.shape
    for name, t in (("tracks", tracks), ("vis", vis), ("score", score),
                    ("fine tracks", fine_tracks)):
        assert bool(torch.isfinite(t).all()), f"non-finite {name}"
    qps, valids = runner.query_points(images, frames)
    n_valid = int(torch.stack(valids).sum())
    for q in frames:  # each query frame keeps its own points
        assert torch.equal(tracks[0, q, q * K:(q + 1) * K], qps[q])
    # 8 coarse calls of 48 tracks: each 6 iterations of one correlation
    # launch (5 levels), 6 x (6 time + 6 virtual blocks) and 6 x 12
    # cross-attention tails; 8 fine calls of 6 iterations x (4 time blocks
    # and one flat correlation launch); then the direct fine call: 4
    # iterations x (one NHWC correlation launch, 3 levels, and 4 time
    # blocks)
    want = {"fused_transformer_block": S * (72 + 24) + fine_iters * 4,
            "fused_ln_mlp": S * 72, "fused_ln_attn": 0,
            "corr_sample_pallas": S * 6,
            "corr_sample_pallas_smallc": S * 6 + fine_iters,
            "flash_attention": 0}
    assert launches == want, f"launch counts {launches}, expected {want}"
    print(f"few tracks: tracks {tuple(tracks.shape)} from {S} query frames "
          f"x {K} ALIKED points ({n_valid} valid) in {wall:.3f} s (first "
          f"run {first_s:.3f} s); stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in runner.timings.items())
          + f"; peak memory {peak_gb:.2f} GiB; launches {launches}",
          flush=True)
    report["few_tracks"] = {"wall_s": wall, "first_run_s": first_s,
                            "stages_s": dict(runner.timings),
                            "peak_mem_gib": peak_gb, "valid_points": n_valid}

    # the tracking stage with its re-query of short frames, on the same
    # frames: 8 x 48 points leave every frame short of the default
    # min_vis_points (500), so `track_frames` re-queries frame 0 (48 more
    # points, still short) and then every frame with 'sp+sift+aliked' at
    # half the budget: 8 + 1 + 8 coarse calls
    assert runner.cfg.comple_nonvis and runner.cfg.min_vis_points == 500
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        t3, v3, s3 = runner.track_frames(images, runner.fmaps(images), frames)
    torch.cuda.synchronize()
    requery_s = time.perf_counter() - t0
    requery_launches = dict(fm.launch_counts)
    fm.reset_launch_counts()
    P3 = P + K + S * (K // 2)
    assert t3.shape == (1, S, P3, 2), t3.shape
    assert v3.shape == (1, S, P3) and s3.shape == (1, S, P3)
    for name, t in (("tracks", t3), ("vis", v3), ("score", s3)):
        assert bool(torch.isfinite(t).all()), f"non-finite re-query {name}"
    for q in frames:  # the first round's tracks lead, pinned as before
        assert torch.equal(t3[0, q, q * K:(q + 1) * K], qps[q])
    assert requery_launches["corr_sample_pallas"] == (2 * S + 1) * 6, \
        requery_launches
    print(f"few tracks, track_frames with the re-query of short frames: "
          f"{P} -> {P3} tracks in 3 rounds ({requery_s:.3f} s); launches "
          f"{requery_launches}", flush=True)
    report["few_tracks"]["track_frames_s"] = requery_s
    report["few_tracks"]["track_frames_tracks"] = P3

    report["few_tracks"]["profile"] = profile_slice(
        drive, "few_tracks_profile.txt")

    # the same path at a reduced size in f32 on the card and on the CPU,
    # on the query points the card's runner extracted. Without the matching
    # init (and so without its cycle visibility and the NCC polish): their
    # argmax steps flip on near-ties between devices, which the agree phase
    # above already meets with its gates; here every track starts on its
    # query point, so what is compared is the iterations' correlation
    # lookups (the kernel on the card, its plain version on the CPU) and
    # the formers.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S2, size2 = 4, 256
    images2 = make_frames(S2, size2, (2, 1), "cpu", seed=8)
    fine_maps2, fine_qp2 = fine_maps[:, :S2].cpu(), fine_qp.cpu()
    out = {}
    for dev in ("cuda", "cpu"):
        r2 = make_runner("f32", dev, seed=8, query_method="aliked",
                         max_query_pts=K, matching_init=False)
        if dev == "cuda":
            qps2, valids2 = r2.query_points(images2, [0, 2])
            qps2 = [q.cpu() for q in qps2]
            valids2 = [v.cpu() for v in valids2]
        fm.reset_launch_counts()
        t, _, _ = r2.predict_tracks(images2, r2.fmaps(images2), [0, 2],
                                    query_points=qps2, query_valid=valids2)
        with torch.inference_mode():
            preds, _ = r2.tracker.fine_predictor(
                fine_qp2.to(dev), fine_maps2.to(dev), iters=fine_iters)
        out[dev] = (t.float().cpu(), preds[-1].float().cpu(),
                    dict(fm.launch_counts))
    fm.reset_launch_counts()
    # 2 coarse and 2 fine calls of 6 iterations, the direct fine call
    assert out["cuda"][2]["corr_sample_pallas"] == 2 * 6
    assert out["cuda"][2]["corr_sample_pallas_smallc"] == 2 * 6 + fine_iters
    assert not any(out["cpu"][2].values())
    med, mx, frac = track_agreement(out["cuda"][0], out["cpu"][0])
    fmed, fmx, ffrac = track_agreement(out["cuda"][1], out["cpu"][1])
    # the gates of the agree phase, for the reasons given there
    ok = frac >= 0.95 and med <= 1e-3 and ffrac >= 0.95 and fmed <= 1e-3
    print(f"few tracks agree: GPU vs CPU ({S2} frames, {size2} px, 2 query "
          f"frames x {K} points, f32): tracks median {med:.2e} px, max "
          f"{mx:.2e} px, within 1e-2 px {frac:.4f}; fine predictor on NHWC "
          f"maps (16 tracks): median {fmed:.2e} px, max {fmx:.2e} px, "
          f"within 1e-2 px {ffrac:.4f} {'ok' if ok else 'FAIL'}", flush=True)
    report["few_tracks_agree"] = {
        "median_px": med, "max_px": mx, "frac_1e-2": frac,
        "fine_median_px": fmed, "fine_max_px": fmx, "fine_frac_1e-2": ffrac}
    if not ok:
        raise AssertionError("GPU and CPU few-track tracks disagree")
    report["few_tracks_agree"]["matching_init"] = matching_init_agreement(
        images2, K)


def matching_init_agreement(images, K) -> dict:
    """The few-track path with the matching init on (and with it the cycle
    visibility and the NCC polish), f32 at the reduced size. Gated: the
    kernel route on the card against the same run on the card with the
    kernel's plain version in its place. Printed: either against the CPU,
    and the previous routes (2K points per call: the full-map product, no
    correlation kernel) against the CPU: the argmax steps of this mode
    flip on near-ties between the devices whichever form computes the
    correlation."""
    import torch

    from vggsfm_tpu_torch.models import tracker as ttr
    from vggsfm_tpu_torch.ops import corr as tc
    from vggsfm_tpu_torch.ops import fused_mlp as fm
    from vggsfm_tpu_torch.tools.ablate_corr import previous_routes

    def run(dev, points, valid):
        r = make_runner("f32", dev, seed=8, query_method="aliked",
                        max_query_pts=K)
        assert r.cfg.matching_init
        fm.reset_launch_counts()
        t, v, _ = r.predict_tracks(images, r.fmaps(images), [0, 2],
                                   query_points=points, query_valid=valid)
        n = fm.launch_counts["corr_sample_pallas"]
        fm.reset_launch_counts()
        return t.float().cpu(), v.float().cpu(), n

    def outliers(a, b):
        return (a - b).abs().amax(dim=(1, 3))[0] > 1e-2

    picker = make_runner("f32", "cuda", seed=8, query_method="aliked")
    pts = {}
    for n in (K, 2 * K):
        qps, valids = picker.query_points(images, [0, 2], max_query_pts=n)
        pts[n] = ([q.cpu() for q in qps], [v.cpu() for v in valids])

    gk = run("cuda", *pts[K])
    kernel = ttr.corr_sample_kernel
    ttr.corr_sample_kernel = tc.corr_sample_plain
    try:
        gp = run("cuda", *pts[K])
    finally:
        ttr.corr_sample_kernel = kernel
    ck = run("cpu", *pts[K])
    with previous_routes():
        gm = run("cuda", *pts[2 * K])
        cm = run("cpu", *pts[2 * K])
    assert gk[2] == 2 * 6 and gp[2] == 0 and gm[2] == 0, (gk[2], gp[2],
                                                          gm[2])

    med, mx, frac = track_agreement(gk[0], gp[0])
    vis_diff = float((gk[1] - gp[1]).abs().max())
    out_k, out_p = outliers(gk[0], ck[0]), outliers(gp[0], ck[0])
    _, mx_k, frac_k = track_agreement(gk[0], ck[0])
    _, mx_p, frac_p = track_agreement(gp[0], ck[0])
    _, mx_m, frac_m = track_agreement(gm[0], cm[0])
    ok = frac >= 0.95 and med <= 1e-3 and vis_diff <= 1e-3
    print(f"few tracks agree, matching init on (2 query frames x {K} "
          f"points, f32): kernel route vs its plain version, both on the "
          f"card: median {med:.2e} px, max {mx:.2e} px, within 1e-2 px "
          f"{frac:.4f}, visibility max difference {vis_diff:.2e} "
          f"{'ok' if ok else 'FAIL'}; GPU vs CPU: kernel route within 1e-2 "
          f"px {frac_k:.4f} (max {mx_k:.2e} px, {int(out_k.sum())} tracks "
          f"out), plain version on the card {frac_p:.4f} (max {mx_p:.2e} px, "
          f"{int(out_p.sum())} out, {int((out_k & out_p).sum())} of them "
          f"the same tracks), previous matmul route at {2 * K} points "
          f"per call "
          f"{frac_m:.4f} (max {mx_m:.2e} px)", flush=True)
    if not ok:
        raise AssertionError("with the matching init on, the correlation "
                             "kernel and its plain version disagree on "
                             "the card")
    return {"kernel_vs_plain_on_card": {"median_px": med, "max_px": mx,
                                        "frac_1e-2": frac,
                                        "vis_max_diff": vis_diff},
            "gpu_vs_cpu_frac_1e-2": {"kernel_route": frac_k,
                                     "plain_on_card": frac_p,
                                     "matmul_route": frac_m},
            "gpu_vs_cpu_max_px": {"kernel_route": mx_k,
                                  "plain_on_card": mx_p,
                                  "matmul_route": mx_m},
            "outlier_tracks": {"kernel_route": int(out_k.sum()),
                               "plain_on_card": int(out_p.sum()),
                               "shared": int((out_k & out_p).sum())}}


# ------------------------------------------------------------- phase 8

def query_points_phase(report: dict) -> None:
    import torch

    from vggsfm_tpu_torch.extractors.cnn import load_aliked
    from vggsfm_tpu_torch.extractors.dispatch import get_query_points_batched

    S, size, K, border = 8, 1024, 4096, 4
    images = make_frames(S, size, (3, 2), "cuda", seed=9)[0]
    rows = {}
    for method in ("aliked", "sift+harris", "sp+sift+aliked"):
        def extract():
            gen = torch.Generator().manual_seed(0)
            out = get_query_points_batched(images, gen, method, K)
            torch.cuda.synchronize()
            return out

        extract()  # first run: cuDNN algorithm search, the models' init
        t0 = time.perf_counter()
        xy, valid = extract()
        secs = time.perf_counter() - t0
        assert xy.shape == (S, K, 2) and valid.shape == (S, K)
        assert bool(torch.isfinite(xy).all())
        inside = xy[valid]
        assert inside.numel() > 0, f"{method}: no valid point"
        assert bool(((inside >= border) & (inside < size - border)).all()), \
            f"{method}: a valid point lies in the border"
        # valid points come first in every frame
        n = valid.sum(dim=1)
        assert bool((valid == (torch.arange(K, device=valid.device)[None]
                               < n[:, None])).all())
        rows[method] = {"seconds": secs, "valid": int(valid.sum()),
                        "of": S * K}
        print(f"query points [{method}]: {S} frames x {K} points in "
              f"{secs:.3f} s, {int(valid.sum())} of {S * K} valid, all "
              f"inside the {border}-px border", flush=True)

    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        score_gpu = load_aliked("cuda", torch.float32)(images[:1]).cpu()
        score_cpu = load_aliked("cpu", torch.float32)(images[:1].cpu())
    err = float((score_gpu - score_cpu).abs().max())
    ok = err <= 1e-3
    print(f"query points: ALIKED score map GPU vs CPU (1 frame, {size} px, "
          f"f32, TF32 off): max error {err:.2e} (bound 1e-3) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    report["query_points"] = {**rows, "aliked_score_gpu_vs_cpu": err}
    if not ok:
        raise AssertionError("ALIKED score maps disagree between GPU and CPU")


# ------------------------------------------------------------- phase 9

def oracle_tracks(scene, n_points, noise_px, outlier_frac, seed=0):
    """Tracks of `n_points` points on the two planes of
    `render_two_plane_scene` that land inside the frame in every view,
    projected through the port's `project_points` on the card, with
    Gaussian pixel noise; the first `outlier_frac` of the tracks are
    uniform pixels in every frame but the query frame. Returns (tracks
    (1, S, N, 2), the number of outlier tracks)."""
    import torch

    from vggsfm_tpu_torch.geometry.cameras import project_points

    extr = torch.as_tensor(scene["extrinsics"], device="cuda")
    intr = torch.as_tensor(scene["intrinsics"], device="cuda")
    S, size = extr.shape[0], scene["images"].shape[1]
    g = torch.Generator().manual_seed(seed)
    # the planes of render_two_plane_scene's defaults: the background at
    # z 4 (its texture spans +-3.5; every view sees less than +-2.5), the
    # foreground square at z 2, 0.7 half-wide
    pts = []
    for z, half in ((4.0, 2.5), (2.0, 0.7)):
        xy = (torch.rand(2 * n_points, 2, generator=g) * 2 - 1) * half
        pts.append(torch.cat([xy, torch.full((2 * n_points, 1), z)], 1))
    pts = torch.cat(pts)[torch.randperm(4 * n_points, generator=g)]
    pix = project_points(pts.cuda(), extr, intr)  # (S, P, 2)
    inside = ((pix >= 0) & (pix <= size - 1)).all(-1).all(0)
    keep = torch.nonzero(inside)[:n_points, 0]
    assert keep.numel() == n_points, f"{keep.numel()} points inside"
    tracks = pix[:, keep] + noise_px * torch.randn(
        S, n_points, 2, generator=g).cuda()
    n_out = int(outlier_frac * n_points)
    tracks[1:, :n_out] = torch.rand(S - 1, n_out, 2,
                                    generator=g).cuda() * (size - 1)
    return tracks[None], n_out


def relative_pose_errors_to_frame0(extr, gt):
    """Per frame s >= 1: the rotation error (degrees) of extr[s] against
    the planted relative pose gt[s] ∘ gt[0]⁻¹, and |cos| of the angle
    between their translation directions."""
    import math

    import torch

    from vggsfm_tpu_torch.geometry.cameras import se3_compose, se3_inverse
    from vggsfm_tpu_torch.geometry.rotations import so3_geodesic_angle

    rel = se3_compose(gt[1:], se3_inverse(gt[:1]).expand(len(gt) - 1, 3, 4))
    rot = so3_geodesic_angle(extr[1:, :, :3], rel[:, :, :3]) * 180 / math.pi
    t, tg = extr[1:, :, 3], rel[:, :, 3]
    cos = (t * tg).sum(-1) / (t.norm(dim=-1) * tg.norm(dim=-1))
    return rot, cos.abs()


def planted_sampson(scene, track):
    """Squared Sampson distances (S-1, N) of (S, N, 2) tracks, frame 0
    against each frame, under the planted cameras' fundamental matrices."""
    import torch

    from vggsfm_tpu_torch.geometry.cameras import se3_compose, se3_inverse
    from vggsfm_tpu_torch.twoview.utils import sampson_epipolar_distance

    gt = torch.as_tensor(scene["extrinsics"], dtype=torch.float64)
    K = torch.as_tensor(scene["intrinsics"][0], dtype=torch.float64)
    rel = se3_compose(gt[1:], se3_inverse(gt[:1]).expand(len(gt) - 1, 3, 4))
    t = rel[:, :, 3]
    zero = torch.zeros_like(t[:, 0])
    tx = torch.stack([zero, -t[:, 2], t[:, 1], t[:, 2], zero, -t[:, 0],
                      -t[:, 1], t[:, 0], zero], -1).reshape(-1, 3, 3)
    Kinv = torch.linalg.inv(K)
    F = Kinv.T @ tx @ rel[:, :, :3] @ Kinv
    tr = track.double().cpu()
    S = tr.shape[0]
    return sampson_epipolar_distance(tr[:1].expand(S - 1, -1, -1), tr[1:],
                                     F[:, None])[:, 0].to(track.device)


def timed_stage(parts: dict):
    """A `run_sfm` stage hook: the wall time of each part, ending in a
    device synchronization, into `parts`."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def stage(name):
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0

    return stage


def count_host_syncs(fn):
    """Run fn() with PyTorch's CUDA sync debug mode on: the number of
    operations that made the host wait for the device (`.item()`, a
    tensor read as a bool, a boolean-mask gather, a device-to-host
    copy)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def sfm_report(label, fn, profile_name) -> dict:
    """One warm `run_sfm` call, then: a run timed by parts, a device-only
    profile (busy share, device operations; table to smoke_out/), a run
    counting the host syncs, with its peak memory. `fn(stage)` runs the
    solve with that stage hook (or none) and returns its dict. Returns
    (the timed run's dict, the report)."""
    import torch

    fn(None)
    torch.cuda.synchronize()
    parts = {}
    t0 = time.perf_counter()
    out = fn(timed_stage(parts))
    wall = time.perf_counter() - t0
    prof = profile_slice(lambda: fn(None), profile_name, host=False)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    syncs = count_host_syncs(lambda: fn(None))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"{label}: run_sfm {wall:.3f} s by parts "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; {syncs} host syncs; peak memory {peak:.2f} GiB above its "
          f"inputs", flush=True)
    return out, {"wall_s": wall, "parts_s": parts, "host_syncs": syncs,
                 "peak_mem_gib": peak, "profile": prof}


def sfm_oracle(report: dict, scene, tracks, pre) -> None:
    """(c): `run_sfm` on the oracle tracks from (a)'s preliminary
    cameras at the matched size, against the planted cameras; then on the
    card against the CPU at a reduced size."""
    import torch

    from vggsfm_tpu_torch.geometry.metrics import (
        pose_auc30,
        relative_pose_errors,
    )
    from vggsfm_tpu_torch.sfm import SfmConfig, run_sfm

    S, N = tracks.shape[1:3]
    size = scene["images"].shape[1]
    gt = torch.as_tensor(scene["extrinsics"], device="cuda")
    extr0 = pre["extrinsics"][0]
    intr0 = pre["default_intri"].expand(S, 3, 3)
    fmat = pre["fmat_inlier_mask"][0]
    vis = torch.ones(S, N, device="cuda")

    def solve(stage, sub=slice(None), dev="cuda"):
        return run_sfm(extr0.to(dev), intr0.to(dev),
                       tracks[0][:, sub].to(dev), vis[:, sub].to(dev),
                       (size, size),
                       fmat_inlier_mask=fmat[:, sub].to(dev),
                       score=vis[:, sub].to(dev), cfg=SfmConfig(),
                       stage=stage)

    out, rep = sfm_report(f"reconstruct (c): the SfM solve on the oracle "
                          f"({S} frames x {N} tracks)", solve,
                          "sfm_oracle_profile.txt")
    auc = float(pose_auc30(out["extrinsics"], gt))
    auc0 = float(pose_auc30(extr0, gt))
    valid = int(out["valid_tracks"].sum())
    r_err, t_err, m = relative_pose_errors(out["extrinsics"], gt)
    ok = auc >= 0.85 and valid >= 100 and all(
        bool(torch.isfinite(out[k]).all())
        for k in ("extrinsics", "intrinsics", "points3d"))
    print(f"reconstruct (c): valid tracks {valid} (>= 100), AUC@30 against "
          f"the planted cameras {auc:.4f} (>= 0.85; the preliminary cameras "
          f"{auc0:.4f}), relative rotation error median "
          f"{float(r_err[m].median()):.3f} deg, translation "
          f"{float(t_err[m].median()):.3f} deg, focal "
          f"{[round(float(f), 1) for f in out['intrinsics'][:, 0, 0]]} "
          f"(planted {float(scene['intrinsics'][0, 0, 0]):.0f}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    report["sfm_oracle"] = {**rep, "auc30": auc, "auc30_preliminary": auc0,
                            "valid_tracks": valid}
    if not ok:
        raise AssertionError("the SfM solve misses the planted cameras")

    # the card against the CPU at 2048 tracks: the same PnP draws (both
    # from CPU generators)
    sub = slice(None, None, N // 2048)
    g, c = (solve(None, sub, dev) for dev in ("cuda", "cpu"))
    r_err, t_err, m = relative_pose_errors(g["extrinsics"].cpu(),
                                           c["extrinsics"])
    same = {k: float((g[k].cpu() == c[k]).float().mean())
            for k in ("valid_tracks", "valid_2d_mask", "valid_frame_mask")}
    rot, tra = float(r_err[m].max()), float(t_err[m].max())
    ok = rot <= 0.1 and tra <= 1.0 and min(same.values()) >= 0.99
    print(f"reconstruct (c): run_sfm GPU vs CPU (2048 tracks, the same "
          f"draws): relative rotations within {rot:.2e} deg (<= 0.1), "
          f"translation directions within {tra:.2e} deg (<= 1), masks equal "
          f"on {same} (>= 0.99) {'ok' if ok else 'FAIL'}", flush=True)
    report["sfm_oracle"].update(gpu_vs_cpu_rot_deg=rot,
                                gpu_vs_cpu_trans_deg=tra,
                                gpu_vs_cpu_masks=same)
    if not ok:
        raise AssertionError("run_sfm disagrees GPU vs CPU")


def matched_config(**kw):
    """The runner's options at bench.py's matched workload: 8 query frames
    x 4096 ALIKED points, fine tracking, comple_nonvis, bf16, hybrid
    camera init (the solve at its defaults)."""
    from vggsfm_tpu_torch.runner import RunnerConfig

    return RunnerConfig(precision="bf16", query_frame_num=8,
                        max_query_pts=4096, query_method="aliked",
                        fine_tracking=True, comple_nonvis=True,
                        camera_init="hybrid", **kw)


def reconstruct_phase(report: dict, launches: dict) -> None:
    """(a) The preliminary two-view cameras on the oracle at the runner's
    size, and on the card against the CPU; (b) `sparse_reconstruct` on the
    oracle scene at the matched workload. `launches` gets the kernel
    launch counts of (b)'s timed run."""
    import dataclasses

    import torch

    from vggsfm_tpu_torch.geometry.metrics import (
        pose_auc30,
        relative_pose_errors,
    )
    from vggsfm_tpu_torch.ops import fused_mlp as fm
    from vggsfm_tpu_torch.runner import VGGSfMRunner
    from vggsfm_tpu_torch.sfm import run_sfm
    from vggsfm_tpu_torch.twoview.preliminary import (
        estimate_preliminary_cameras,
    )
    from vggsfm_tpu_torch.twoview.utils import generate_samples
    from vggsfm_tpu_torch.utils.synth import render_two_plane_scene

    S, size = 8, 1024
    t0 = time.perf_counter()
    scene = render_two_plane_scene(S, size)
    render_s = time.perf_counter() - t0
    gt = torch.as_tensor(scene["extrinsics"], device="cuda")

    # (a) the oracle: 32,768 tracks, 0.5 px noise, 10% outliers
    N = 32768
    tracks, n_out = oracle_tracks(scene, N, 0.5, 0.1)
    vis = torch.ones(tracks.shape[:3], device="cuda")

    def stage(tr, vi, iters, lo, **kw):
        return estimate_preliminary_cameras(
            tr, vi, size, size, tracks_score=vi, max_error=4.0, lo_num=lo,
            max_ransac_iters=iters, **kw)

    def run_full():
        return stage(tracks, vis, 1024, 128,
                     generator=torch.Generator().manual_seed(1))

    run_full()  # first run: cuBLAS set-up, allocator warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = run_full()
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    prof = profile_slice(run_full, "preliminary_profile.txt", host=False)
    rot, tcos = relative_pose_errors_to_frame0(pre["extrinsics"][0], gt)
    inl = pre["fmat_inlier_mask"][0, :, n_out:].float().mean(-1)
    ok = (bool((rot < 1.0).all()) and bool((tcos > 0.99).all())
          and bool((inl >= 0.85).all()))
    print(f"reconstruct (a): preliminary on the oracle, {S - 1} pairs x {N} "
          f"tracks (10% outliers, 0.5 px noise), 1024 minimal sets, lo_num "
          f"128: {pre_s:.3f} s on the card; rotation error "
          f"{[round(float(x), 4) for x in rot]} deg (< 1), translation "
          f"|cos| {[round(float(x), 5) for x in tcos]} (> 0.99), inliers of "
          f"the true tracks {[round(float(x), 4) for x in inl]} (>= 0.85) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    report["reconstruct_oracle"] = {
        "seconds": pre_s, "peak_mem_gib": peak_gb, "profile": prof,
        "rot_err_deg": rot.tolist(), "t_abs_cos": tcos.tolist(),
        "inlier_frac": inl.tolist()}
    if not ok:
        raise AssertionError("preliminary cameras miss the planted poses")

    # the same stage at a reduced size (every 16th track: 10% outliers
    # still) on the card and on the CPU, with the same minimal sets
    n2 = 2048
    sub = slice(None, None, N // n2)
    idx, _ = generate_samples(torch.Generator().manual_seed(2), n2, 128, 7)
    out = {dev: stage(tracks[:, :, sub].to(dev), vis[:, :, sub].to(dev),
                      128, 16, sample_idx=idx)
           for dev in ("cuda", "cpu")}
    e_err = float((out["cuda"]["extrinsics"].cpu()
                   - out["cpu"]["extrinsics"]).abs().max())
    same = float((out["cuda"]["fmat_inlier_mask"].cpu()
                  == out["cpu"]["fmat_inlier_mask"]).float().mean())
    ok = e_err <= 1e-3 and same >= 0.99
    print(f"reconstruct (a): preliminary GPU vs CPU ({n2} tracks, 128 "
          f"minimal sets, lo_num 16, the same samples): extrinsics max "
          f"error {e_err:.2e} (<= 1e-3), inlier masks equal on {same:.4f} "
          f"(>= 0.99) {'ok' if ok else 'FAIL'}", flush=True)
    report["reconstruct_oracle"].update(gpu_vs_cpu_extr=e_err,
                                        gpu_vs_cpu_masks=same)
    if not ok:
        raise AssertionError("preliminary cameras disagree GPU vs CPU")

    # (c) the SfM solve on the oracle tracks
    sfm_oracle(report, scene, tracks, pre)

    # (b) the slice at the matched workload
    cfg = matched_config()
    runner = VGGSfMRunner(cfg, device="cuda")
    calls = {"coarse": 0, "fine": 0}
    for name in calls:  # count the tracker calls of each run
        method = getattr(runner, f"_{name}_track")

        def counted(*a, _m=method, _n=name, **k):
            calls[_n] += 1
            return _m(*a, **k)

        setattr(runner, f"_{name}_track", counted)
    images = scene["images"]
    t0 = time.perf_counter()
    runner.sparse_reconstruct(images)  # first run: set-up, model inits
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fm.reset_launch_counts()
    calls.update(coarse=0, fine=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = runner.sparse_reconstruct(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update(fm.launch_counts)
    fm.reset_launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    nc, nf = calls["coarse"], calls["fine"]

    track, extr, intr = res["pred_track"], res["extrinsics"], res["intrinsics"]
    init_extr = res["init_extrinsics"]
    P = track.shape[2]
    assert track.shape == (1, S, P, 2) and P >= 8 * 4096, track.shape
    assert res["pred_vis"].shape == res["pred_score"].shape == (1, S, P)
    assert extr.shape == init_extr.shape == (S, 3, 4)
    assert intr.shape == res["init_intrinsics"].shape == (S, 3, 3)
    assert res["points3d"].shape == (P, 3)
    assert res["valid_2d_mask"].shape == (S, P)
    for k in ("pred_track", "pred_vis", "pred_score", "extrinsics",
              "intrinsics", "init_extrinsics", "init_intrinsics",
              "points3d"):
        assert bool(torch.isfinite(res[k]).all()), f"non-finite {k}"
    valid = int(res["valid_tracks"].sum())
    assert valid >= 100, f"{valid} valid tracks"
    # the solve's input: frame 0 at [I | 0]; after the normalization the
    # solve's cameras keep neither t = 0 nor, after pose refinement,
    # exactly R = I
    first = float((init_extr[0] - torch.eye(3, 4, device="cuda")
                   ).abs().max())
    assert first <= 1e-4, f"frame 0 off [I | 0] by {first}"
    R = torch.cat([extr, init_extr])[:, :, :3].double()
    orth = float((R @ R.transpose(1, 2)
                  - torch.eye(3, dtype=R.dtype, device="cuda")).abs().max())
    assert orth <= 1e-4, f"rotations off orthonormal by {orth}"
    # every former block and correlation call on the kernels: per coarse
    # call 72 blocks, 72 cross-attention tails, 6 correlation launches;
    # per fine call 24 blocks and 6 flat correlation launches; one camera
    # forward
    want = {"fused_transformer_block": 72 * nc + 24 * nf,
            "fused_ln_mlp": 72 * nc + 8 * fm.WIDE_MLP_KERNELS,
            "fused_ln_attn": 16 * fm.ATTN_KERNELS,
            "corr_sample_pallas": 6 * nc, "corr_sample_pallas_smallc": 6 * nf,
            "flash_attention": 0}
    assert nc >= 8 and nf >= nc, calls
    assert launches == want, f"launch counts {launches}, expected {want}"

    pre = res["preliminary"]
    tv = pre["extrinsics"][0]
    scores = res["init_scores"].tolist()
    # the tracks against the planted geometry: per pair, the share of the
    # usable tracks (vis >= 0.05, score >= 0.5) within the 4 px Sampson
    # threshold of the planted fundamental matrix
    usable = ((res["pred_vis"][0] >= 0.05)
              & (res["pred_score"][0] >= 0.5))[1:]
    d = planted_sampson(scene, track[0])
    true_share = [round(float(x), 4) for x in
                  ((d <= 16.0) & usable).sum(-1) / usable.sum(-1)]
    won = "neural" if scores[0] >= scores[1] else "two-view"
    auc_tv = float(pose_auc30(tv, gt))
    auc_chosen = float(pose_auc30(init_extr, gt))
    auc_sfm = float(pose_auc30(extr, gt))
    r0_err = float((extr[0, :, :3] - torch.eye(3, device="cuda")).abs().max())
    inliers = pre["fmat_inlier_mask"][0].sum(-1).tolist()
    print(f"reconstruct (b): sparse_reconstruct, {S} frames x {size} px, 8 "
          f"query frames x 4096 ALIKED points, fine tracking, comple_nonvis, "
          f"bf16, seeded weights: {wall:.3f} s (first run {first_s:.3f} s; "
          f"scene rendered in {render_s:.1f} s); stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in res["timings"].items())
          + f"; {P} tracks from {nc} coarse and {nf} fine calls; inliers "
          f"per pair {inliers}; init support [neural, two-view] {scores}: "
          f"{won} won; usable tracks within 4 px of the planted epipolar "
          f"lines per pair {true_share}; AUC@30 against the planted "
          f"cameras: two-view "
          f"{auc_tv:.4f}, chosen {auc_chosen:.4f}, the solve's {auc_sfm:.4f} "
          f"with {valid} valid tracks (>= 100); the solve's frame 0 off "
          f"R = I by {r0_err:.1e}; peak memory {peak_gb:.2f} GiB; launches "
          f"{launches}", flush=True)
    report["reconstruct"] = {
        "wall_s": wall, "first_run_s": first_s, "stages_s": res["timings"],
        "tracks": P, "coarse_calls": nc, "fine_calls": nf,
        "inliers_per_pair": inliers, "planted_inlier_share": true_share,
        "init_scores": scores, "won": won,
        "auc30_twoview": auc_tv, "auc30_chosen": auc_chosen,
        "auc30_sfm": auc_sfm, "valid_tracks": valid,
        "peak_mem_gib": peak_gb}
    report["reconstruct"]["profile"] = profile_slice(
        lambda: runner.sparse_reconstruct(images), "reconstruct_profile.txt",
        host=False)
    # the solve alone on this run's tracks and initial cameras
    with torch.inference_mode():
        _, report["reconstruct"]["sfm"] = sfm_report(
            "reconstruct (b): the solve alone", lambda stage: run_sfm(
                init_extr, res["init_intrinsics"], track[0],
                res["pred_vis"][0], (size, size),
                fmat_inlier_mask=pre["fmat_inlier_mask"][0],
                score=res["pred_score"][0], cfg=runner.sfm_config(),
                stage=stage), "sfm_profile.txt")

    # center_order at a reduced size: with frame 2 ranked first the run
    # swaps frames 2 and 0 for every stage and its per-frame outputs back,
    # so it equals the run on the swapped frames, swapped back
    perm = [2, 1, 0, 3]
    small = images[:4]
    runner.cfg = dataclasses.replace(cfg, query_frame_num=2,
                                     max_query_pts=512, comple_nonvis=False)
    runner.select_query_frames = lambda im: [0, 2]
    b = runner.sparse_reconstruct(small[perm])
    runner.cfg = dataclasses.replace(runner.cfg, center_order=True)
    runner.select_query_frames = lambda im: [2, 0]
    a = runner.sparse_reconstruct(small)
    del runner.select_query_frames
    runner.cfg = cfg
    p = torch.as_tensor(perm, device="cuda")
    t_err = float((a["pred_track"] - b["pred_track"][:, p]).abs().max())
    e_err = float((a["init_extrinsics"] - b["init_extrinsics"][p]
                   ).abs().max())
    anchor = float((a["init_extrinsics"][2]
                    - torch.eye(3, 4, device="cuda")).abs().max())
    sfm_rot = float(relative_pose_errors(a["extrinsics"],
                                         b["extrinsics"][p])[0].max())
    ok = (list(a["center_perm"]) == perm and t_err <= 1e-3
          and e_err <= 1e-3 and anchor <= 1e-4)
    print(f"reconstruct (b): center_order (4 frames, 2 query frames x 512 "
          f"points, frame 2 ranked first): the outputs in the caller's "
          f"frame order, tracks within {t_err:.1e} px and initial cameras "
          f"within {e_err:.1e} of the run on the swapped frames, the "
          f"caller's frame 2 at [I | 0] within {anchor:.1e} "
          f"{'ok' if ok else 'FAIL'}; the solves' relative rotations "
          f"within {sfm_rot:.2e} deg", flush=True)
    if not ok:
        raise AssertionError("center_order returns another frame order")


# ------------------------------------------------------------ phase 10

def end_to_end_phase(report: dict) -> None:
    """(d): `sparse_reconstruct` on the card at the JAX package's CPU
    end-to-end test's config and gates (tests/test_e2e_synth.py:71-108):
    6 frames of `render_two_plane_scene` at 512 px, one query frame, 1024
    sift+harris points, fine tracking, no re-query, f32, robust_refine 2,
    ba_iters 2; valid tracks > 50, AUC@30 against the planted cameras >
    0.85, median relative rotation error < 1.5 deg."""
    import torch

    from vggsfm_tpu_torch.geometry.metrics import (
        pose_auc30,
        relative_pose_errors,
    )
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner
    from vggsfm_tpu_torch.utils.synth import render_two_plane_scene

    scene = render_two_plane_scene(num_frames=6, image_size=512)
    cfg = RunnerConfig(query_frame_num=1, max_query_pts=1024,
                       query_method="sift+harris", fine_tracking=True,
                       comple_nonvis=False, robust_refine=2, ba_iters=2,
                       precision="f32")
    runner = VGGSfMRunner(cfg, device="cuda")
    t0 = time.perf_counter()
    out = runner.sparse_reconstruct(scene["images"])
    wall = time.perf_counter() - t0
    gt = torch.as_tensor(scene["extrinsics"], device="cuda")
    valid = int(out["valid_tracks"].sum())
    auc = float(pose_auc30(out["extrinsics"], gt))
    auc0 = float(pose_auc30(out["init_extrinsics"], gt))
    r_err, t_err, m = relative_pose_errors(out["extrinsics"], gt)
    r_med = float(r_err[m].median())
    ok = valid > 50 and auc > 0.85 and r_med < 1.5
    print(f"end to end (d): sparse_reconstruct, 6 frames x 512 px, 1024 "
          f"sift+harris points, f32: {wall:.3f} s (first run), stages "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["timings"].items()
                      if not k.startswith("sfm."))
          + f"; valid tracks {valid} (> 50), AUC@30 {auc:.4f} (> 0.85; the "
          f"initial cameras {auc0:.4f}), median relative rotation error "
          f"{r_med:.3f} deg (< 1.5), "
          f"translation {float(t_err[m].median()):.3f} deg "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    report["end_to_end"] = {"wall_s": wall, "stages_s": out["timings"],
                            "valid_tracks": valid, "auc30": auc,
                            "rot_err_median_deg": r_med}
    if not ok:
        raise AssertionError("sparse_reconstruct misses the end-to-end "
                             "gates")


# ------------------------------------------------------------ phase 11

def parse_glb(path) -> dict:
    """The JSON chunk of a GLB file, after checking its header, its length
    and that its binary chunk holds every buffer view."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    magic, version, total = struct.unpack("<III", data[:12])
    assert (magic, version, total) == (0x46546C67, 2, len(data)), "header"
    jlen, jtype = struct.unpack("<II", data[12:20])
    assert jtype == 0x4E4F534A, "JSON chunk"
    gltf = json.loads(data[20: 20 + jlen])
    blen, btype = struct.unpack("<II", data[20 + jlen: 28 + jlen])
    assert btype == 0x004E4942 and blen == gltf["buffers"][0]["byteLength"]
    assert 28 + jlen + blen == len(data), "chunk lengths"
    for view in gltf["bufferViews"]:
        assert view["byteOffset"] + view["byteLength"] <= blen
    return gltf


def check_export(out_dir, res, names) -> dict:
    """The model `sparse_reconstruct` wrote to `out_dir`, read back with
    the port's reader, against its predictions (frames in the caller's
    order; square crops at the model's size, so pixels are unchanged):
    the images are the valid frames under their names; each image's tvec
    is its translation, its qvec rebuilds its rotation within 1e-6 beyond
    the f32 rotation's own distance from orthonormal; each observation's xy is
    the track's at (frame, point) exactly; the tracked points are the
    valid tracks observed (in valid frames) at least twice, with xyz the
    solve's; their colors clip(colors x 255); then as many trackless
    points as valid extra points; additional_points.npz and scene.glb
    parse. Returns the counts."""
    import numpy as np

    from vggsfm_tpu_torch.io import read_model
    from vggsfm_tpu_torch.io.bridge import _quat_to_matrix
    from vggsfm_tpu_torch.runner import to_host

    h = to_host({k: res[k] for k in (
        "extrinsics", "points3d", "valid_tracks", "valid_2d_mask",
        "valid_frame_mask", "pred_track", "colors", "additional_points")})
    rec = read_model(os.path.join(out_dir, "sparse"))
    frames = np.nonzero(h["valid_frame_mask"])[0]
    assert sorted(rec.images) == [int(s) + 1 for s in frames], \
        f"images {sorted(rec.images)}, valid frames {frames}"
    pose_err, orth_err = 0.0, 0.0
    for s in frames:
        im = rec.images[int(s) + 1]
        assert im.name == names[s], (im.name, names[s])
        e = h["extrinsics"][s].astype(np.float64)
        R = e[:, :3]
        # the solve's f32 rotation is itself off orthonormal by ~1e-6 (its
        # BA updates), and a unit quaternion rebuilds an orthonormal one
        orth_err = max(orth_err, float(np.abs(R @ R.T - np.eye(3)).max()))
        pose_err = max(pose_err,
                       float(np.abs(_quat_to_matrix(im.qvec) - R).max()))
        assert np.array_equal(im.tvec, e[:, 3]), f"frame {s}: tvec"
        xy = h["pred_track"][0, s, im.point3D_ids].astype(np.float64)
        assert np.array_equal(im.xys, xy), f"frame {s}: observations"
    assert pose_err <= 1e-6 + orth_err, \
        f"qvec off the rotations by {pose_err} (orthonormal to {orth_err})"
    obs = (h["valid_2d_mask"] & h["valid_tracks"][None]
           & h["valid_frame_mask"][:, None])
    want = np.nonzero(obs.sum(0) >= 2)[0]
    tracked = [p for p in rec.points3D.values() if len(p.image_ids)]
    assert [p.id for p in tracked] == want.tolist(), "tracked point ids"
    rgb = np.clip(h["colors"] * 255, 0, 255).astype(np.uint8)
    for p in tracked:
        assert np.array_equal(p.xyz, h["points3d"][p.id].astype(np.float64))
        assert np.array_equal(p.rgb, rgb[p.id]), f"point {p.id}: color"
    extra = h["additional_points"]
    n_extra = int(extra["valid"].sum())
    trackless = [p for p in rec.points3D.values() if not len(p.image_ids)]
    assert len(trackless) == n_extra, (len(trackless), n_extra)
    assert [p.id for p in trackless] == list(range(
        want.max() + 1, want.max() + 1 + n_extra)), "trackless point ids"
    with np.load(os.path.join(out_dir, "additional_points.npz")) as z:
        assert z["points3d"].shape == (n_extra, 3)
        assert int(z["additional_points_num"]) == n_extra
        assert int(z["sfm_points_num"]) == int(h["valid_tracks"].sum())
    gltf = parse_glb(os.path.join(out_dir, "scene.glb"))
    n_glb = gltf["accessors"][0]["count"]
    assert n_glb == int(h["valid_tracks"].sum()), (n_glb,)
    return {"images": len(rec.images), "tracked_points": len(tracked),
            "trackless_points": n_extra, "qvec_err": pose_err,
            "rotation_orth_err": orth_err, "glb_points": n_glb}


def export_phase(report: dict, launches: dict, shared: dict) -> None:
    """(e) `sparse_reconstruct` at (b)'s matched workload with the export:
    image names, square crop parameters, 4096 extra grid points per frame
    tracked over all 8 frames (`extra_pt_pixel_interval` 16), appended to
    the model, and scene.glb; warm, then timed. `launches` gets the timed
    run's launch counts; `shared` the runner, the scene and the run's
    AUC@30 for the dense phase. Then `triangulate_extra_points` GPU vs CPU
    at a reduced size, and the CLI on the scene written as PNGs."""
    import numpy as np
    import torch

    from vggsfm_tpu_torch.datasets.demo_loader import crop_parameters
    from vggsfm_tpu_torch.geometry.metrics import pose_auc30
    from vggsfm_tpu_torch.ops import fused_mlp as fm
    from vggsfm_tpu_torch.runner import VGGSfMRunner, track_colors
    from vggsfm_tpu_torch.utils.synth import (
        render_two_plane_scene,
        write_scene_folder,
    )

    S, size, iv = 8, 1024, 16
    scene = render_two_plane_scene(S, size)
    images = scene["images"]
    names = [f"frame_{i:04d}.png" for i in range(S)]
    crop = np.stack([crop_parameters(size, size, [0, 0, size, size], size,
                                     size)] * S)
    runner = VGGSfMRunner(matched_config(
        img_size=size, extra_pt_pixel_interval=iv, extra_by_neighbor=-1,
        concat_extra_points=True, make_glb=True), device="cuda")
    calls = {"coarse": 0, "extra": 0, "fine": 0}
    coarse, fine = runner._coarse_track, runner._fine_track

    def counted_coarse(fmaps, qp, stage="coarse"):
        calls["extra" if stage == "extra_points.coarse" else "coarse"] += 1
        return coarse(fmaps, qp, stage=stage)

    def counted_fine(*a, **k):
        calls["fine"] += 1
        return fine(*a, **k)

    extra_launches = {}
    extra_fn = runner.triangulate_extra_points

    def counted_extra(*a, **k):
        before = dict(fm.launch_counts)
        out = extra_fn(*a, **k)
        extra_launches.update({n: c - before[n]
                               for n, c in fm.launch_counts.items()})
        return out

    runner._coarse_track, runner._fine_track = counted_coarse, counted_fine
    runner.triangulate_extra_points = counted_extra
    out_dir = os.path.join(OUT_DIR, "export")

    def run():
        return runner.sparse_reconstruct(images, image_names=names,
                                          output_dir=out_dir,
                                          crop_params=crop)

    t0 = time.perf_counter()
    run()  # first run: set-up, model inits
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    calls.update(coarse=0, extra=0, fine=0)
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update(fm.launch_counts)
    fm.reset_launch_counts()
    nc, nx, nf = calls["coarse"], calls["extra"], calls["fine"]

    # the extra points: 8 coarse calls of 4096 tracks over the 8 frames,
    # each 72 blocks, 72 cross-attention tails and 6 correlation launches
    want_x = {"fused_transformer_block": 72 * nx, "fused_ln_mlp": 72 * nx,
              "fused_ln_attn": 0, "corr_sample_pallas": 6 * nx,
              "corr_sample_pallas_smallc": 0, "flash_attention": 0}
    assert nx == S, calls
    assert extra_launches == want_x, \
        f"extra-point launches {extra_launches}, expected {want_x}"
    rest = {k: launches[k] - extra_launches[k] for k in launches}
    want = {"fused_transformer_block": 72 * nc + 24 * nf,
            "fused_ln_mlp": 72 * nc + 8 * fm.WIDE_MLP_KERNELS,
            "fused_ln_attn": 16 * fm.ATTN_KERNELS,
            "corr_sample_pallas": 6 * nc, "corr_sample_pallas_smallc": 6 * nf,
            "flash_attention": 0}
    assert nc >= runner.cfg.query_frame_num and nf >= nc, calls
    assert rest == want, f"launch counts {rest}, expected {want}"

    extra = res["additional_points"]
    N = (size // iv) ** 2
    assert extra["points3d"].shape == (S * N, 3), extra["points3d"].shape
    for k in ("extrinsics", "intrinsics", "points3d", "colors"):
        assert bool(torch.isfinite(res[k]).all()), f"non-finite {k}"
    for k in ("points3d", "colors"):
        assert bool(torch.isfinite(extra[k]).all()), f"non-finite extra {k}"
    n_valid_x = int(extra["valid"].sum())
    assert n_valid_x >= 1, "no valid extra point"
    counts = check_export(out_dir, res, names)
    # the colors against the same formula on the CPU
    w = res["valid_2d_mask"].cpu()
    cpu_colors = track_colors(torch.as_tensor(images),
                              res["pred_track"][0].cpu(), w)
    c_err = float((res["colors"].cpu() - cpu_colors).abs().max())
    assert c_err <= 1e-5, f"colors off the CPU's by {c_err}"
    auc = float(pose_auc30(res["extrinsics"], torch.as_tensor(
        scene["extrinsics"], device="cuda")))

    # the host export alone on the same predictions: building the
    # Reconstruction, then writing the files
    runner.timings = {}
    t0 = time.perf_counter()
    runner.save_reconstruction(res, (size, size), names,
                               os.path.join(OUT_DIR, "export_again"),
                               crop_params=crop)
    save_s = time.perf_counter() - t0
    build_s = runner.timings["export.build"]
    write_s = runner.timings["export.write"]
    tm = res["timings"]
    print(f"export (e): sparse_reconstruct at (b)'s workload with the "
          f"export, {S * N} extra grid points ({N} per frame, {nx} coarse "
          f"calls of {N} tracks over {S} frames): {wall:.3f} s (first run "
          f"{first_s:.3f} s); stages "
          + ", ".join(f"{k} {v:.3f} s" for k, v in tm.items()
                      if not k.startswith("sfm."))
          + f"; extra points valid {n_valid_x} of {S * N} "
          f"({n_valid_x / (S * N):.4f}), stage {tm['extra_points']:.3f} s "
          f"(its coarse calls {tm['extra_points.coarse']:.3f} s); the "
          f"export alone on these predictions {save_s:.3f} s (build "
          f"{build_s:.3f} s, write {write_s:.3f} s); model read back: "
          f"{counts}; colors vs CPU {c_err:.1e} (<= 1e-5); AUC@30 against "
          f"the planted cameras {auc:.4f} (printed); launches "
          f"extra points {extra_launches}, the rest {rest} ok", flush=True)
    report["export"] = {
        "wall_s": wall, "first_run_s": first_s, "stages_s": tm,
        "extra_points": S * N, "extra_valid": n_valid_x,
        "extra_valid_share": n_valid_x / (S * N),
        "extra_points_s": tm["extra_points"],
        "export_s": save_s, "export_build_s": build_s,
        "export_write_s": write_s, "model": counts,
        "colors_vs_cpu": c_err, "launches_extra": extra_launches,
        "auc30": auc}
    shared.update(runner=runner, scene=scene, names=names, crop=crop,
                  auc30=auc)
    del res
    torch.cuda.empty_cache()

    extra_points_agreement(report)
    cli_run(report, scene, write_scene_folder)


@contextlib.contextmanager
def record_matching(log: list):
    """Record the tracker's matching init while it runs: per
    `global_match_coords` call one entry of `log` with its inputs (the
    fmaps, the query features), the scores of every argmax it takes, in
    its order (frame s forward, then frame s backward with the cycle), and
    the coordinates it returns; all copied to the host."""
    from vggsfm_tpu_torch.models import tracker as ttr

    gmc, amp = ttr.global_match_coords, ttr._argmax_parabola

    def argmax_recorded(flat, H, W):
        log[-1]["scores"].append(flat.float().cpu())
        return amp(flat, H, W)

    def match_recorded(fmaps, query_feats, qp, cycle=False):
        log.append({"fmaps": fmaps.float().cpu(),
                    "qf": query_feats.float().cpu(), "scores": []})
        out = gmc(fmaps, query_feats, qp, cycle=cycle)
        log[-1]["coords"] = out[0].cpu()
        return out

    ttr.global_match_coords = match_recorded
    ttr._argmax_parabola = argmax_recorded
    try:
        yield log
    finally:
        ttr.global_match_coords, ttr._argmax_parabola = gmc, amp


def matching_flips(log_g: list, log_c: list, tg, tc) -> dict:
    """Where the matching init's argmax steps part between the devices.

    Each score is a dot product of C-channel unit vectors, so its f32
    rounding is bounded by b = C * 2^-24 * sum_c |f_c q_c| (the usual
    dot-product bound, computed in f64 on the host from the recorded
    inputs). For every argmax of every call (frames 1.., forward, then
    backward with the cycle; frame 0's are overwritten), the picks of the
    two devices are compared. A differing pick (cells i on the card, j on
    the CPU) is a near-tie when on each device the gap between its own
    pick and the other's, as that device scored them, is at most
    2 (b_i + b_j): the exact scores lie within b of each device's, so a
    flip needs |e_i - e_j| <= b_i + b_j, and each device's gap is then at
    most twice that. A track is flipped when its coarse positions
    (tg / tc, (1, S, calls * N, 2)) part by more than 1e-2 px in some
    frame; for each the first argmax step that picked a different cell is
    found, and where none did, the largest distance between the two
    devices' initial coordinates (cells). Also: the largest |s_gpu -
    s_cpu| / (2 b) over every score of every forward argmax."""
    import torch

    from vggsfm_tpu_torch.models import tracker as ttr

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-300)

    first_steps, near, not_near, no_flip_init = [], 0, [], []
    top2 = []
    score_ratio = 0.0
    n_flipped = 0
    offset = 0
    for eg, ec in zip(log_g, log_c):
        fm = ec["fmaps"][0].double()  # (S, H, W, C)
        S, H, W, C = fm.shape
        fmu = unit(fm)
        N = ec["qf"].shape[1]
        qu = unit(ec["qf"][0].double())  # (N, C)
        fin = (tg[0, :, offset: offset + N] - tc[0, :, offset: offset + N])
        flipped = fin.abs().amax(dim=(0, 2)) > 1e-2  # (N,)
        offset += N
        n_flipped += int(flipped.sum())
        first = [None] * N
        cycle = len(ec["scores"]) == 2 * S
        for s in range(1, S):
            steps = [("forward", 2 * s if cycle else s)]
            if cycle:
                steps.append(("backward", 2 * s + 1))
            for kind, k in steps:
                sg, sc = eg["scores"][k][0].double(), ec["scores"][k][0].double()
                if kind == "forward":
                    ref = fmu[s].reshape(H * W, C)
                    q = qu
                else:
                    # the CPU's forward match, resampled, against frame 0
                    xy, _ = ttr._argmax_parabola(
                        ec["scores"][k - 1], H, W)
                    q = unit(ttr.bilinear_sample(fmu[s][None],
                                                 xy.double())[0])
                    ref = fmu[0].reshape(H * W, C)
                bnd = C * 2.0 ** -24 * (q.abs() @ ref.abs().T)  # (N, HW)
                if kind == "forward":
                    score_ratio = max(score_ratio, float(
                        ((sg - sc).abs() / (2 * bnd)).max()))
                ig, ic = sg.argmax(-1), sc.argmax(-1)
                for n in torch.nonzero(ig != ic)[:, 0].tolist():
                    i, j = int(ig[n]), int(ic[n])
                    tol = 2 * float(bnd[n, i] + bnd[n, j])
                    gap_g = float(sg[n, i] - sg[n, j])
                    gap_c = float(sc[n, j] - sc[n, i])
                    t2g = torch.topk(sg[n], 2).values
                    t2c = torch.topk(sc[n], 2).values
                    top2.append((float(t2g[0] - t2g[1]),
                                 float(t2c[0] - t2c[1]), tol))
                    if gap_g <= tol and gap_c <= tol:
                        near += 1
                    else:
                        not_near.append({"frame": s, "step": kind,
                                         "gap_gpu": gap_g, "gap_cpu": gap_c,
                                         "bound": tol})
                    if first[n] is None:
                        first[n] = f"{kind} frame {s}"
        init = (eg["coords"][0] - ec["coords"][0]).abs().amax(dim=(0, 2))
        for n in torch.nonzero(flipped)[:, 0].tolist():
            if first[n] is None:
                no_flip_init.append(float(init[n]))
            else:
                first_steps.append(first[n])
    counts = {}
    for f in first_steps:
        counts[f] = counts.get(f, 0) + 1
    return {"flipped_tracks": n_flipped,
            "flipped_by_a_differing_pick": len(first_steps),
            "first_differing_step": counts,
            "differing_picks": near + len(not_near),
            "near_ties": near, "not_near_ties": not_near[:20],
            "n_not_near_ties": len(not_near),
            "top2_gap_max": {
                "gpu": max((a for a, _, _ in top2), default=0.0),
                "cpu": max((b for _, b, _ in top2), default=0.0),
                "bound_max": max((t for _, _, t in top2), default=0.0)},
            "flipped_without_a_differing_pick": len(no_flip_init),
            "their_initial_coords_max_cells": max(no_flip_init,
                                                  default=0.0),
            "forward_score_diff_over_2b_max": score_ratio}


def extra_points_agreement(report: dict) -> None:
    """`triangulate_extra_points` on the card and on the CPU at a reduced
    size (4 frames of `render_two_plane_scene` at 256 px, its planted
    cameras, f32, TF32 off, 256 grid points per frame), given the same
    fmaps (the CPU's). Without the matching init the coarse tracks are
    gated as the agree phase gates them (>= 95% within 1e-2 px in every
    frame, median <= 1e-3 px); with it, the runner's weights-free mode,
    the argmax steps of the matching init are recorded on both devices
    and `matching_flips` says, for each track whose positions part, which
    argmax first picked a different cell and how near a tie it was under
    the f32 dot-product bound. Gated: every differing pick is a near-tie,
    every forward score agrees within twice its bound, and the tracks
    that part with every pick equal start from initial coordinates within
    1e-4 cells; and the CPU alone, its initial coordinates nudged by
    uniform noise of 1e-6 cells (about one f32 ulp), parts from its own
    run on at least as many tracks as the card does: the coarse
    iterations amplify rounding-level differences of the start. The
    points and valid masks printed for both."""
    import torch

    from vggsfm_tpu_torch.utils.synth import render_two_plane_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S, size = 4, 256
    scene = render_two_plane_scene(S, size, seed=5)
    images = torch.as_tensor(scene["images"])[None]
    extr = torch.as_tensor(scene["extrinsics"], dtype=torch.float32)
    intr = torch.as_tensor(scene["intrinsics"], dtype=torch.float32)
    fmaps = make_runner("f32", "cpu", seed=5).fmaps(images)

    def run(dev, matching_init, nudge=0.0):
        from vggsfm_tpu_torch.models import tracker as ttr

        runner = make_runner("f32", dev, seed=5, matching_init=matching_init)
        seen, log = [], []
        coarse = runner._coarse_track

        def recorded(f, qp, stage="coarse"):
            t, v = coarse(f, qp, stage=stage)
            seen.append(t.cpu())
            return t, v

        runner._coarse_track = recorded
        with record_matching(log):
            match = ttr.global_match_coords

            def nudged(*a, **k):
                coords, conf, cyc = match(*a, **k)
                g = torch.Generator().manual_seed(len(seen))
                d = (torch.rand(coords.shape, generator=g) * 2 - 1) * nudge
                d[:, 0] = 0.0
                return coords + d.to(coords.device), conf, cyc

            if nudge:
                ttr.global_match_coords = nudged
            try:
                res = runner.triangulate_extra_points(
                    images.to(dev), fmaps.to(dev), extr.to(dev),
                    intr.to(dev), num_extra=256)
            finally:
                ttr.global_match_coords = match
        return (torch.cat(seen, 2), {k: v.cpu() for k, v in res.items()},
                log)

    lines, rows = [], {}
    for minit in (False, True):
        (tg, g, log_g), (tc, c, log_c) = run("cuda", minit), run("cpu", minit)
        med, mx, frac = track_agreement(tg, tc)
        same_valid = float((g["valid"] == c["valid"]).float().mean())
        both = g["valid"] & c["valid"]
        rel = ((g["points3d"] - c["points3d"]).norm(dim=-1)
               / c["points3d"].norm(dim=-1))[both]
        pts = float((rel <= 1e-3).float().mean()) if both.any() else 1.0
        rows[minit] = {"median_px": med, "max_px": mx, "frac_1e-2": frac,
                       "valid_equal": same_valid, "points_1e-3": pts}
        if minit:
            rows[minit]["flips"] = matching_flips(log_g, log_c, tg, tc)
            tn = run("cpu", True, nudge=1e-6)[0]
            rows[minit]["cpu_nudged_1e-6_cells_vs_cpu"] = dict(zip(
                ("median_px", "max_px", "frac_1e-2"),
                track_agreement(tn, tc)))
        lines.append(
            f"matching init {'on' if minit else 'off'}: coarse tracks "
            f"median {med:.2e} px, max {mx:.2e} px, within 1e-2 px "
            f"{frac:.4f}; valid masks equal on {same_valid:.4f} (valid "
            f"{int(g['valid'].sum())} / {int(c['valid'].sum())}), points "
            f"valid on both within 1e-3 relative {pts:.4f}, median "
            + (f"{float(rel.median()):.1e}" if both.any() else "-"))
    off = rows[False]
    ok = off["frac_1e-2"] >= 0.95 and off["median_px"] <= 1e-3
    flips = rows[True]["flips"]
    nudged = rows[True]["cpu_nudged_1e-6_cells_vs_cpu"]
    ties = (flips["n_not_near_ties"] == 0
            and flips["forward_score_diff_over_2b_max"] <= 1.0
            and flips["their_initial_coords_max_cells"] <= 1e-4
            and nudged["frac_1e-2"] <= rows[True]["frac_1e-2"])
    print(f"export (e): triangulate_extra_points GPU vs CPU ({S} frames, "
          f"{size} px, {S} x 256 grid points, f32, the same fmaps and "
          f"cameras): {lines[0]} {'ok' if ok else 'FAIL'}; {lines[1]}",
          flush=True)
    print(f"export (e): the matching init's argmax steps, card vs CPU "
          f"(score bound b = C * 2^-24 * sum_c |f_c q_c|, C = 128; a "
          f"differing pick i / j is a near-tie when each device's gap "
          f"between its pick and the other's is <= 2 (b_i + b_j)): "
          f"{json.dumps(flips)}; the CPU against itself with its initial "
          f"coordinates nudged by <= 1e-6 cells: within 1e-2 px "
          f"{nudged['frac_1e-2']:.4f}, median {nudged['median_px']:.2e} px "
          f"(every differing pick a near-tie, scores within 2b, the parting "
          f"tracks' starts within 1e-4 cells, the nudged CPU parting on at "
          f"least as many tracks: {'ok' if ties else 'FAIL'})", flush=True)
    report["export_agree"] = {"matching_init_off": rows[False],
                              "matching_init_on": rows[True]}
    if not ok:
        raise AssertionError("GPU and CPU extra-point tracks disagree")
    if not ties:
        raise AssertionError("the matching init parts between the devices "
                             "beyond rounding")


def cli_run(report: dict, scene, write_scene_folder) -> None:
    """The CLI as a user runs it: the scene written as PNGs with its
    planted cameras as the GT model (sparse/0), then `python3 -m
    vggsfm_tpu_torch.demo DIR --load-gt --glb` in a child process; gates
    AUC@30 against the GT >= 0.85 and the files it writes."""
    scene_dir = os.path.join(OUT_DIR, "export_scene")
    names = write_scene_folder(scene, scene_dir)
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vggsfm_tpu_torch.demo", scene_dir,
         "--load-gt", "--glb"], cwd=HERE, env=env, capture_output=True,
        text=True, timeout=400)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        raise AssertionError(f"the CLI exited {proc.returncode}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    from vggsfm_tpu_torch.io import read_model

    rec = read_model(os.path.join(scene_dir, "sparse"))
    assert {im.name for im in rec.images.values()} <= set(names)
    gltf = parse_glb(os.path.join(scene_dir, "scene.glb"))
    auc = summary.get("gt_auc30", -1.0)
    ok = auc >= 0.85 and len(rec.images) >= 2 and len(rec.points3D) >= 100
    print(f"export (e): python3 -m vggsfm_tpu_torch.demo on the scene as "
          f"{len(names)} PNGs, --load-gt --glb: {wall:.1f} s in a child "
          f"process (start-up, weights and its first run included); "
          f"{len(rec.images)} images, {len(rec.points3D)} points, GLB of "
          f"{gltf['accessors'][0]['count']} points; gt_auc30 {auc} (>= "
          f"0.85) {'ok' if ok else 'FAIL'}; summary {summary}", flush=True)
    report["export_cli"] = {"wall_s": wall, "summary": summary}
    if not ok:
        raise AssertionError("the CLI's reconstruction misses the gates")


# ------------------------------------------------------------ phase 12

def depth_model_readings(runner, frame, report: dict) -> None:
    """(f) The DPT depth model alone on one 1024-px frame at
    `depth_input_size` 518 (the runner's `_disparity`: resize, DPT,
    resize back): ViT-B (the runner's seeded model) in bf16 and in f32,
    the ms per frame (CUDA events) and the peak memory, shape, finite,
    >= 0; ViT-B in f32 on the card against the CPU at 140 px with TF32 off
    (within 1e-3 of the largest disparity: f32 sums in other orders
    through 12 blocks and the head's convs); then DepthAnythingV2-Large
    (`DepthAnything.vitl()`, seeded on the card) once in bf16."""
    import torch

    from vggsfm_tpu_torch.models.dpt import DepthAnything, init_depth_anything_

    vitb = runner._load_depth_model()
    vitb32 = DepthAnything(dtype=torch.float32)
    vitb32.load_state_dict(vitb.state_dict())
    vitb32 = vitb32.to("cuda").eval()
    vitl = DepthAnything.vitl(dtype=torch.bfloat16).to("cuda").eval()
    init_depth_anything_(vitl, torch.Generator("cuda").manual_seed(0))
    rows = {}
    for name, model, iters in (("vitb_bf16", vitb, 10),
                               ("vitb_f32", vitb32, 5),
                               ("vitl_bf16", vitl, 3)):
        runner._depth = model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        d = runner._disparity(frame)
        ms = cuda_time_ms(lambda: runner._disparity(frame), iters, warmup=1)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        ok = (tuple(d.shape) == (1, *frame.shape[2:4])
              and bool(torch.isfinite(d).all()) and float(d.min()) >= 0)
        rows[name] = {"ms_per_frame": ms, "peak_mib_above_weights": peak,
                      "ok": ok, "disparity_max": float(d.max())}
        assert ok, f"{name}: disparity {tuple(d.shape)}, not finite or < 0"
    runner._depth = vitb
    del vitl

    # GPU vs CPU, f32, TF32 off
    x = torch.nn.functional.interpolate(
        frame[0].permute(0, 3, 1, 2), size=(140, 140), mode="bilinear",
        align_corners=True).permute(0, 2, 3, 1).contiguous()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            g = vitb32(x).cpu()
            c = vitb32.to("cpu")(x.cpu())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    err = float((g - c).abs().max())
    scale = float(c.abs().max())
    agree = err <= 1e-3 * scale
    del vitb32
    torch.cuda.empty_cache()
    print("dense (f): DepthAnything at depth_input_size 518 on one 1024-px "
          "frame (resize, DPT, resize back), seeded weights: "
          + "; ".join(f"{k} {v['ms_per_frame']:.2f} ms per frame, peak "
                      f"{v['peak_mib_above_weights']:.0f} MiB above the "
                      f"weights, disparity max {v['disparity_max']:.3g}"
                      for k, v in rows.items())
          + f"; shapes, finite, >= 0 ok; ViT-B f32 card vs CPU at 140 px "
          f"(TF32 off): max |diff| {err:.2e} of max {scale:.3g} (<= 1e-3 "
          f"of it) {'ok' if agree else 'FAIL'}", flush=True)
    report["dense_models"] = {**rows, "vitb_f32_gpu_vs_cpu_max_abs": err,
                              "vitb_f32_cpu_max": scale}
    if not agree:
        raise AssertionError("the DPT on the card disagrees with the CPU")


# the dense phase's profiled call: the first frames of the export scene
DENSE_FRAMES = 4


def dense_phase(report: dict, launches: dict, shared: dict) -> None:
    """(f) The depth model's readings (`depth_model_readings`); then (g)
    `sparse_reconstruct` at the export phase's settings, on its runner, on
    the scene's first DENSE_FRAMES frames, with `dense_depth`,
    `visual_tracks`, `make_reproj_frames`, `visual_query_points` and a
    `profile_dir`: the dense_depth and visuals stage times; each frame's
    `depth_inlier_frac` (in (0, 1], the median printed); OUT/depths/*.bin
    read back at each image's original resolution, finite and > 0; the
    visual files; a trace that names the stages; the five kernels' launch
    counts exactly those of the counted tracker and camera calls (the
    dense stage and the visuals launch none); AUC@30 against the planted
    cameras >= 0.85. Then
    (h) the CLI with the new flags on the scene folder of the export
    phase's CLI run."""
    import dataclasses

    import numpy as np
    import torch

    from vggsfm_tpu_torch.geometry.metrics import pose_auc30
    from vggsfm_tpu_torch.ops import fused_mlp as fm
    from vggsfm_tpu_torch.utils.depth import read_colmap_array

    runner, scene = shared["runner"], shared["scene"]
    # the profiled call on the first DENSE_FRAMES frames: every output of
    # the flags at a fraction of the matched call's trace
    names, crop = shared["names"][:DENSE_FRAMES], shared["crop"][:DENSE_FRAMES]
    images = scene["images"][:DENSE_FRAMES]
    S, size = images.shape[:2]
    frame = torch.as_tensor(images[:1], device="cuda")[None]
    depth_model_readings(runner, frame, report)
    calls = {"coarse": 0, "fine": 0, "camera": 0}
    coarse, fine = runner._coarse_track, runner._fine_track

    def counted(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    runner._coarse_track = counted(coarse, "coarse")
    runner._fine_track = counted(fine, "fine")
    hook = runner.camera.register_forward_hook(
        lambda *a: calls.__setitem__("camera", calls["camera"] + 1))

    out_dir = os.path.join(OUT_DIR, "dense")
    prof_dir = os.path.join(OUT_DIR, "dense_trace")
    runner.cfg = dataclasses.replace(
        runner.cfg, dense_depth=True, visual_tracks=True,
        make_reproj_frames=True, visual_query_points=True,
        profile_dir=prof_dir)
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    res = runner.sparse_reconstruct(images, image_names=names,
                                    output_dir=out_dir, crop_params=crop)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update(fm.launch_counts)
    fm.reset_launch_counts()
    hook.remove()
    runner._coarse_track, runner._fine_track = coarse, fine
    runner.cfg = dataclasses.replace(
        runner.cfg, dense_depth=False, visual_tracks=False,
        make_reproj_frames=False, visual_query_points=False,
        profile_dir=None)
    # the dense stage and the visuals launch none of the kernels
    want = expected_launches(calls["coarse"], calls["fine"],
                             calls["camera"])
    assert launches == want, f"launches {launches}, expected {want}"

    tm = res["timings"]
    inl = res["depth_inlier_frac"].cpu().numpy()
    assert res["depth_maps"].shape == (S, size, size)
    assert ((inl > 0) & (inl <= 1)).all(), f"inlier fractions {inl}"
    shapes = set()
    for n in names:
        d = read_colmap_array(os.path.join(out_dir, "depths",
                                           os.path.splitext(n)[0] + ".bin"))
        assert np.isfinite(d).all() and d.min() > 0, f"depth map {n}"
        shapes.add(d.shape)
    assert shapes == {(int(crop[0][1]), int(crop[0][0]))}, shapes
    vis = set(os.listdir(os.path.join(out_dir, "visuals")))
    want = ({f"tracks_{s:04d}.png" for s in range(S)}
            | {f"reproj_{s:04d}.png" for s in range(S)} | {"tracks.gif"})
    assert want <= vis, f"missing visuals {sorted(want - vis)}"
    n_query = len([v for v in vis if v.startswith("query_points_")])
    assert n_query >= min(runner.cfg.query_frame_num, S), n_query
    mp4 = sorted(v for v in vis if v.endswith((".mp4", ".avi")))
    trace = runner.trace_path
    with open(trace, "rb") as f:
        data = f.read()
    stages = ("query_rank", "camera_init", "fmaps", "tracking",
              "preliminary", "sfm", "extra_points", "dense_depth",
              "export", "visuals")
    # the tracer's ranges (vggsfm_tpu_torch/utils/trace.py)
    missing = [n for n in stages if f'"vggsfm.{n}"'.encode() not in data]
    assert not missing, f"the trace names no {missing}"
    gt = torch.as_tensor(scene["extrinsics"][:DENSE_FRAMES], device="cuda")
    auc = float(pose_auc30(res["extrinsics"], gt))
    ok = auc >= 0.85
    print(f"dense (g): sparse_reconstruct at the export phase's settings on "
          f"its first {S} frames with dense_depth, the visuals and "
          f"profile_dir: {wall:.3f} s "
          f"(profiled); stages dense_depth {tm['dense_depth']:.3f} s, "
          f"export {tm['export']:.3f} s (export.depths "
          f"{tm['export.depths']:.3f} s), visuals {tm['visuals']:.3f} s; "
          f"depth_inlier_frac per frame {[round(float(x), 4) for x in inl]}"
          f" (median {float(np.median(inl)):.4f}); {len(names)} depth maps "
          f"at {sorted(shapes)}, finite and > 0; visuals {len(vis)} files "
          f"({n_query} query-point overlays), mp4 "
          f"{mp4 if mp4 else 'not written (no OpenCV codec)'}; trace "
          f"{os.path.basename(trace)} of {len(data) / 2 ** 20:.1f} MiB names "
          f"every stage; launches {launches} as the counted calls predict "
          f"({calls}); AUC@30 {auc:.4f} (>= 0.85; the export phase's 8 "
          f"frames {shared['auc30']:.4f}) {'ok' if ok else 'FAIL'}",
          flush=True)
    report["dense"] = {
        "wall_s_profiled": wall, "stages_s": tm,
        "depth_inlier_frac": inl.tolist(),
        "depth_inlier_frac_median": float(np.median(inl)),
        "visual_files": len(vis), "mp4": mp4,
        "trace_mib": len(data) / 2 ** 20, "auc30": auc}
    if not ok:
        raise AssertionError("the dense run's cameras miss the gates")
    del res
    shared.clear()
    del runner
    torch.cuda.empty_cache()
    dense_cli_run(report)


def dense_cli_run(report: dict) -> None:
    """(h) The CLI as a user runs it with every output: `python3 -m
    vggsfm_tpu_torch.demo DIR --load-gt --dense-depth --visual-tracks
    --reproj-frames --visual-query-points --profile-dir D --output O` in a
    child process, on the scene folder of `cli_run`; gates AUC@30 against
    the GT >= 0.85 and the depth maps, visuals and trace it writes."""
    from vggsfm_tpu_torch.utils.depth import read_colmap_array

    scene_dir = os.path.join(OUT_DIR, "export_scene")
    out_dir = os.path.join(OUT_DIR, "dense_cli")
    prof_dir = os.path.join(OUT_DIR, "dense_cli_trace")
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vggsfm_tpu_torch.demo", scene_dir,
         "--output", out_dir, "--load-gt", "--dense-depth",
         "--visual-tracks", "--reproj-frames", "--visual-query-points",
         "--profile-dir", prof_dir], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=400)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        raise AssertionError(f"the CLI exited {proc.returncode}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    depths = sorted(os.listdir(os.path.join(out_dir, "depths")))
    d = read_colmap_array(os.path.join(out_dir, "depths", depths[0]))
    n_vis = len(os.listdir(os.path.join(out_dir, "visuals")))
    traces = os.listdir(prof_dir)
    auc = summary.get("gt_auc30", -1.0)
    ok = (auc >= 0.85 and len(depths) == summary["frames"] and n_vis > 0
          and len(traces) == 1 and bool((d > 0).all()))
    print(f"dense (h): python3 -m vggsfm_tpu_torch.demo --load-gt "
          f"--dense-depth --visual-tracks --reproj-frames "
          f"--visual-query-points --profile-dir: {wall:.1f} s in a child "
          f"process (start-up, weights and its first run included); "
          f"{len(depths)} depth maps of {d.shape}, {n_vis} visual files, "
          f"trace {traces}; gt_auc30 {auc} (>= 0.85) "
          f"{'ok' if ok else 'FAIL'}; summary {summary}", flush=True)
    report["dense_cli"] = {"wall_s": wall, "summary": summary}
    if not ok:
        raise AssertionError("the CLI's dense run misses the gates")


# ------------------------------------------------------------ phase 13

# the video phase's sequence: render_two_plane_scene's camera moves along x
# by VIDEO_BASELINE a frame (2.6 px of background parallax at 512 px); the
# background, sized to the path, fills every view, and the foreground
# square (half extent VIDEO_FG_FRAC x its depth, 1.2 against the path's
# +-1.43) stays in most views: where only the background plane is seen,
# the 6-point DLT of PnP is degenerate (coplanar points)
VIDEO_FRAMES, VIDEO_SIZE, VIDEO_BASELINE, VIDEO_FG_FRAC = 144, 512, 0.02, 0.6


class KernelShapes:
    """Record the inputs of each kernel wrapper's first call at each shape
    while a path runs (the layers and the tracker call the wrappers under
    these module names), to hold the kernels against their plain versions
    at exactly those shapes afterwards. Recording launches nothing."""

    def __init__(self):
        from vggsfm_tpu_torch.models import layers, tracker

        self.seen = {}
        self._mods = {"fused_transformer_block": layers,
                      "fused_ln_attn": layers, "fused_ln_mlp": layers,
                      "corr_sample_kernel": tracker}
        self._orig = {}

    def _key(self, name, args):
        if name == "corr_sample_kernel":
            levels, coords = args[0], args[1]
            return (name, tuple(coords.shape), tuple(levels[0].shape),
                    len(levels), str(levels[0].dtype), args[3])
        seq = args[-2] if name != "fused_ln_mlp" else 0
        return (name, tuple(args[0].shape), seq, str(args[0].dtype))

    def __enter__(self):
        for name, mod in self._mods.items():
            fn = getattr(mod, name)
            self._orig[name] = fn

            def rec(*args, _fn=fn, _name=name, **kw):
                key = self._key(_name, args)
                if key not in self.seen:
                    self.seen[key] = (
                        [[t.clone() for t in a] if isinstance(a, list)
                         else (a.clone() if hasattr(a, "clone") else a)
                         for a in args], dict(kw))
                return _fn(*args, **kw)

            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for name, mod in self._mods.items():
            setattr(mod, name, self._orig[name])
        return False


def check_kernel_shapes(shapes: KernelShapes, report: dict,
                        path: str = "video") -> None:
    """Each recorded call once more through the kernel and through its
    plain version, with the kernel phases' bounds (f32 1e-4; bf16 2 ulp of
    |ref| + 2^-5; correlation 1e-4 plus half a bf16 ulp), and the time of
    both; `path` names the path that gave the shapes. These launches are
    made after the path's counts were read."""
    import torch

    from vggsfm_tpu_torch.ops import corr as cm
    from vggsfm_tpu_torch.ops import fused_mlp as fm

    rows = report.setdefault(f"{path}_kernel_shapes", [])
    plain = {"fused_transformer_block": fm.fused_transformer_block_ref,
             "fused_ln_attn": fm.fused_ln_attn_ref,
             "fused_ln_mlp": fm.fused_ln_mlp_ref}
    for key, (args, kw) in sorted(shapes.seen.items(), key=str):
        name = key[0]
        if name == "corr_sample_kernel":
            levels, coords, feats, radius = args[:4]
            out_dtype = kw.get("out_dtype", args[4] if len(args) > 4
                               else torch.float32)

            def kern():
                return cm.corr_sample_kernel(levels, coords, feats, radius,
                                             out_dtype)

            def ref():
                return cm.corr_sample_plain(levels, coords, feats, radius,
                                            torch.float32)

            C = feats.shape[-1]
            label = ("corr_sample_pallas_smallc" if C < cm.SMALL_C
                     else "corr_sample_pallas")
            out, want = kern(), ref()
            err, frac = corr_err(out, want)
            shape = (f"F={coords.shape[0]} N={coords.shape[1]} "
                     f"{len(levels)} levels of {tuple(levels[0].shape[1:])} "
                     f"r={radius} {str(levels[0].dtype)[6:]}")
        else:
            label = name

            def kern():
                return getattr(fm, name)(*args, **kw)

            def ref():
                return plain[name](*args, **kw)

            out, want = kern(), ref()
            frac, err, _ = err_over_bound(out, want)
            x = args[0]
            shape = (f"R={x.shape[0]} C={x.shape[1]}"
                     + (f" L={args[-2]}" if name != "fused_ln_mlp" else "")
                     + f" {str(x.dtype)[6:]}")
        ok = bool(torch.isfinite(out.float()).all()) and frac <= 1.0
        ms = cuda_time_ms(kern, 5)
        plain_ms = cuda_time_ms(ref, 3)
        print(f"{path}: kernel {label} at the {path} path's shape {shape}: "
              f"max_abs_err={err:.3e} ({frac:.3f} of the bound) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} {'ok' if ok else 'FAIL'}",
              flush=True)
        rows.append({"name": label, "shape": shape, "max_abs_err": err,
                     "err_over_bound": frac, "ms": ms, "plain_ms": plain_ms})
        if not ok:
            raise AssertionError(f"{label} at {shape}: {frac} of the bound")


def sparse_ba_agreement(report: dict) -> None:
    """`bundle_adjust_sparse` on the card against the same call on the CPU
    (f32, TF32 off) at a reduced size of the joint BA: 48 frames, 3000
    points, each seen by the frames of a 12-frame span, 0.3 px noise, the
    joint BA's options (shared focal and radial term, Cauchy 4 px, 12 LM
    iterations x 30 PCG rounds). The card sums its segments with atomics:
    final costs within 1e-3 relative, poses within 1e-2 and points within
    5e-2 (a shared focal's shallow valley, as against the JAX package on
    the CPU)."""
    import numpy as np
    import torch

    from vggsfm_tpu_torch.ba import SparseBAConfig, bundle_adjust_sparse

    rng = np.random.default_rng(5)
    S, P, f = 48, 3000, 512.0
    X = rng.uniform([-3, -2, 5], [3, 2, 9], size=(P, 3))
    extr = np.zeros((S, 3, 4))
    fr, pt, xy = [], [], []
    for s in range(S):
        a = 0.004 * (s - S / 2)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        t = np.array([0.04 * (s - S / 2), 0.0, 0.0])
        extr[s] = np.concatenate([R, t[:, None]], axis=1)
        Xc = X @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:]
        uv = uv * (1 - 0.03 * (uv ** 2).sum(1, keepdims=True))
        px = f * uv + 256.0
        sel = np.nonzero(np.abs(np.arange(P) * S / P - s) < 6)[0]
        fr.append(np.full(len(sel), s))
        pt.append(sel)
        xy.append(px[sel])
    fr, pt = np.concatenate(fr), np.concatenate(pt)
    xy = np.concatenate(xy) + rng.normal(scale=0.3, size=(len(fr), 2))
    intr = np.tile([[f * 1.03, 0, 256.0], [0, f * 1.03, 256.0], [0, 0, 1]],
                   (S, 1, 1))
    extr_n = extr.copy()
    extr_n[1:, :, 3] += rng.normal(scale=0.01, size=(S - 1, 3))
    X_n = X + rng.normal(scale=0.03, size=X.shape)
    cfg = SparseBAConfig(max_iterations=12, refine_focal=True,
                         refine_extra=True, shared_intrinsics=True,
                         cg_iters=30, robust_loss="cauchy", loss_scale=4.0)

    def run(dev):
        def t(a, dtype=torch.float32):
            return torch.as_tensor(a).to(dev, dtype)

        return bundle_adjust_sparse(
            t(extr_n), t(intr), t(X_n), t(fr, torch.long), t(pt, torch.long),
            t(xy), torch.ones(len(fr), device=dev),
            extra_params=t(np.full((S, 1), -0.02)), cfg=cfg)

    run("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = run("cuda")
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = run("cpu")
    cpu_s = time.perf_counter() - t0
    gf, cf = float(g[4]["final_cost"]), float(c[4]["final_cost"])
    d_pose = float((g[0].cpu() - c[0]).abs().max())
    d_pts = float((g[3].cpu() - c[3]).abs().max())
    ok = (abs(gf - cf) <= 1e-3 * cf and d_pose <= 1e-2 and d_pts <= 5e-2
          and gf < 0.1 * float(g[4]["initial_cost"]))
    print(f"video: bundle_adjust_sparse card vs CPU, {S} frames, {P} points, "
          f"{len(fr)} observations, shared focal + k, 12 x 30: card "
          f"{gpu_s:.3f} s, CPU {cpu_s:.3f} s; final cost {gf:.4f} vs "
          f"{cf:.4f} (initial {float(c[4]['initial_cost']):.1f}), poses "
          f"within {d_pose:.2e} (1e-2), points {d_pts:.2e} (5e-2), focal "
          f"{float(g[1][0, 0, 0]):.3f} vs {float(c[1][0, 0, 0]):.3f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    report["video_sparse_ba"] = {"card_s": gpu_s, "cpu_s": cpu_s,
                                 "final_cost": [gf, cf], "pose_diff": d_pose,
                                 "point_diff": d_pts}
    if not ok:
        raise AssertionError("bundle_adjust_sparse: card and CPU disagree")


def check_video_export(out_dir, preds, names) -> None:
    """The exported model read back with the port's reader against the
    predictions: every frame under its name, tvec the translation and qvec
    the rotation (1e-6 beyond its f32 distance from orthonormal), the one
    SIMPLE_RADIAL camera [f, cx, cy, k], every observed point with its xyz
    and the observation count."""
    import numpy as np

    from vggsfm_tpu_torch.io import read_model
    from vggsfm_tpu_torch.io.bridge import _quat_to_matrix

    rec = read_model(os.path.join(out_dir, "sparse"))
    T = len(preds["extrinsics"])
    assert sorted(rec.images) == list(range(1, T + 1))
    n_obs = 0
    for t in range(T):
        im = rec.images[t + 1]
        assert im.name == names[t], im.name
        e = preds["extrinsics"][t].astype(np.float64)
        assert np.array_equal(im.tvec, e[:, 3])
        R = e[:, :3]
        orth = np.abs(R @ R.T - np.eye(3)).max()
        assert np.abs(_quat_to_matrix(im.qvec) - R).max() <= orth + 1e-6
        n_obs += len(im.xys)
    assert n_obs == preds["num_observations"], (n_obs,
                                                preds["num_observations"])
    cam = rec.cameras[1]
    K, k = preds["intrinsics"][0], preds["extra_params"][0]
    assert len(rec.cameras) == 1 and cam.model == "SIMPLE_RADIAL"
    assert np.allclose(cam.params, [K[0, 0], K[0, 2], K[1, 2], k[0]],
                       rtol=0, atol=1e-4)
    for pid, p3 in rec.points3D.items():
        assert np.array_equal(p3.xyz, preds["points3d"][pid].astype(
            np.float64))
    return len(rec.points3D)


def expected_launches(n_coarse: int, n_fine: int, n_camera: int) -> dict:
    """The five kernels' launches that counted tracker and camera calls
    make: 72 block + 72 `ln_mlp` + 6 correlation launches per coarse
    call, 24 block + 6 flat correlation launches per fine call, 16
    `ln_attn` and 8 wide `ln_mlp` calls per camera forward."""
    from vggsfm_tpu_torch.ops import fused_mlp as fm

    return {"fused_transformer_block": 72 * n_coarse + 24 * n_fine,
            "fused_ln_mlp": 72 * n_coarse + 8 * fm.WIDE_MLP_KERNELS
            * n_camera,
            "fused_ln_attn": 16 * fm.ATTN_KERNELS * n_camera,
            "corr_sample_pallas": 6 * n_coarse,
            "corr_sample_pallas_smallc": 6 * n_fine, "flash_attention": 0}


def video_phase(report: dict, launches: dict, shared: dict) -> None:
    """The video pipeline: `VideoRunner.run` at the JAX CLI's defaults (512
    px, initial window 32, windows of 16, joint BA every 6 windows, 1024
    query points 'auto', one SIMPLE_RADIAL camera, midpoint ranking, fine
    tracking, bf16, seeded full-width weights) without the camera fill on
    `render_two_plane_scene` (VIDEO_FRAMES frames), with the export: the
    stage times, each window's time, tracker share, retries and kernel
    launches, the registered frames, points and observations, AUC@30
    against the planted cameras, peak memory. Gates: every frame
    registered, AUC@30 >= 0.85, finite outputs, launch counts equal to 72
    block + 72 `ln_mlp` + 6 correlation launches per coarse call, 24 block
    + 6 flat correlation launches per fine call and 16 x 4 `ln_attn` + 8 x
    3 `ln_mlp` per camera forward, the model read back. Then each kernel
    against its plain version at the shapes that a second run gives it:
    the CLI's default configuration, the camera fill on, on the first 48
    frames, its launch counts exact with the fill's camera forwards
    (recorded there so that the timed run's wall and peak carry no
    recording); `bundle_adjust_sparse` card vs CPU; a device-only
    profile of the pipeline on the first 48 frames; and, at once on the
    card, the CLI in a child process on a 32-frame folder (--init-window
    16 --window 8: the initial window and one window a host) and two host
    processes of the CLI's multi-host run on that folder with a shared
    exchange directory: every frame registered, the hosts' initial maps
    equal. `shared["joint_ba"]` keeps the timed run's last joint BA inputs
    for the multi-device phase."""
    import numpy as np
    import torch

    from vggsfm_tpu_torch.geometry.metrics import pose_auc30
    from vggsfm_tpu_torch.ops import fused_mlp as fm
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner
    from vggsfm_tpu_torch.utils.synth import (
        render_two_plane_scene,
        write_scene_folder,
    )
    from vggsfm_tpu_torch.video import VideoConfig, VideoRunner

    # the earlier phases' runner and scene are done with: their memory goes
    # back to the card for this phase's three CLI processes
    shared.clear()
    gc.collect()
    torch.cuda.empty_cache()
    T, size = VIDEO_FRAMES, VIDEO_SIZE
    t0 = time.perf_counter()
    scene = render_two_plane_scene(T, size, baseline=VIDEO_BASELINE,
                                   fg_half_extent_frac=VIDEO_FG_FRAC)
    render_s = time.perf_counter() - t0
    images = scene["images"]

    # the video CLI's configuration at its defaults, but for the camera
    # fill: a frame that PnP does not register takes the query frame's pose
    # (refined against the map) instead of the camera predictor's, which
    # with seeded, untrained weights is an arbitrary pose (the 48-frame
    # run and the CLI runs below keep the fill)
    scfg = RunnerConfig(img_size=size, query_frame_num=1, max_query_pts=1024,
                        query_method="auto", camera_type="SIMPLE_RADIAL",
                        query_by_midpoint=True)
    runner = VideoRunner(VGGSfMRunner(scfg, device="cuda"),
                         VideoConfig(camera_type="SIMPLE_RADIAL",
                                     align_with_camera_predictor=False))
    r = runner.r
    calls = {"coarse": 0, "fine": 0, "camera": 0}
    coarse, fine = r._coarse_track, r._fine_track

    def counted_coarse(*a, **k):
        calls["coarse"] += 1
        return coarse(*a, **k)

    def counted_fine(*a, **k):
        calls["fine"] += 1
        return fine(*a, **k)

    r._coarse_track, r._fine_track = counted_coarse, counted_fine
    r.camera.register_forward_hook(
        lambda *a: calls.__setitem__("camera", calls["camera"] + 1))
    per_window = []
    track = runner._track_window

    def counted_track(images_w, query_xy, frames_w=None):
        before = dict(fm.launch_counts)
        out = track(images_w, query_xy, frames_w=frames_w)
        per_window.append({"frames": len(images_w), "tracks": len(query_xy),
                           **{n: c - before[n]
                              for n, c in fm.launch_counts.items()}})
        return out

    runner._track_window = counted_track
    sparse_ba = runner._sparse_ba

    def recorded_ba(n_dev, *a, **k):
        # the last joint BA's inputs, replayed by the multi-device phase
        # (references only: no copy or sync inside the timed run)
        shared["joint_ba"] = {"args": a, "kw": k}
        return sparse_ba(n_dev, *a, **k)

    runner._sparse_ba = recorded_ba
    out_dir = os.path.join(OUT_DIR, "video")
    names = [f"frame_{t:05d}.png" for t in range(T)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    preds = runner.run(images, output_dir=out_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches.update(fm.launch_counts)
    fm.reset_launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    runner._sparse_ba = sparse_ba
    shared["joint_ba"] = {
        "args": [t.cpu() if torch.is_tensor(t) else t
                 for t in shared["joint_ba"]["args"]],
        "kw": {k: v.cpu() if torch.is_tensor(v) else v
               for k, v in shared["joint_ba"]["kw"].items()}}

    gt = torch.as_tensor(scene["extrinsics"])
    auc = float(pose_auc30(torch.as_tensor(preds["extrinsics"]), gt))
    finite = all(bool(np.isfinite(preds[k]).all()) for k in (
        "extrinsics", "intrinsics", "extra_params", "points3d"))
    nc, nf, ncam = calls["coarse"], calls["fine"], calls["camera"]
    want = expected_launches(nc, nf, ncam)
    t = runner.timings
    print(f"video: VideoRunner.run, {T} frames x {size} px (render "
          f"{render_s:.1f} s, host), windows 32 / 16 / joint BA every 6, "
          f"1024 'auto' points, SIMPLE_RADIAL shared, bf16: {wall:.2f} s "
          f"(first run in this process); video.init {t['video.init']:.3f} s "
          f"(" + ", ".join(f"{k} {v:.3f}" for k, v in r.timings.items()
                           if not k.startswith("sfm.")) + ")"
          f", windows {t['video.windows']:.3f} s (tracker "
          f"{t['video.track']:.3f} s), video.joint_ba "
          f"{t['video.joint_ba']:.3f} s; peak {peak_gb:.2f} GiB",
          flush=True)
    for i, w in enumerate(runner.windows):
        print(f"  window {i}: frames [{w['frames'][0]}, {w['frames'][1]}) "
              f"from query {w['query']}: {w['seconds']:.3f} s, tracker "
              f"{w['track_seconds']:.3f} s "
              f"({w['track_seconds'] / w['seconds']:.0%}), attempts "
              f"{w['attempts']}, PnP-registered {w['registered_by_pnp']}, "
              f"camera fill {w['camera_aligned']}")
    for i, c in enumerate(per_window):
        print(f"  window call {i}: {c}")
    n_pts = check_video_export(out_dir, preds, names)
    ok = (bool(preds["registered"].all()) and auc >= 0.85 and finite
          and launches == want)
    print(f"video: registered {int(preds['registered'].sum())} / {T}, "
          f"points {preds['num_points']} ({n_pts} in the model read back), "
          f"observations {preds['num_observations']}, AUC@30 {auc:.4f} "
          f"(>= 0.85), focal {float(preds['intrinsics'][0, 0, 0]):.2f} "
          f"(planted {size}), k {float(preds['extra_params'][0, 0]):.4f}; "
          f"calls: {nc} coarse, {nf} fine, {ncam} camera; launches "
          f"{launches} (expected {want}) {'ok' if ok else 'FAIL'}",
          flush=True)
    report["video"] = {
        "wall_s": wall, "render_s": render_s, "timings": dict(t),
        "sparse_timings": dict(r.timings), "windows": runner.windows,
        "window_calls": per_window, "registered": int(
            preds["registered"].sum()), "points": int(preds["num_points"]),
        "observations": int(preds["num_observations"]), "auc30": auc,
        "peak_mem_gib": peak_gb, "calls": dict(calls)}
    if not ok:
        raise AssertionError("the video run misses its gates")

    # the CLI's default configuration, the camera fill on, on the initial
    # window and one window: each kernel's inputs recorded at every shape
    # it gives (the camera at L = 17 in the fill), then held against the
    # plain versions
    fill = VideoRunner(r, VideoConfig(camera_type="SIMPLE_RADIAL"))
    shapes = KernelShapes()
    calls.update(coarse=0, fine=0, camera=0)
    torch.cuda.reset_peak_memory_stats()
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    with shapes:
        preds = fill.run(images[:48])
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    fill_gb = torch.cuda.max_memory_allocated() / 2**30
    got = dict(fm.launch_counts)
    fm.reset_launch_counts()
    nc, nf, ncam = calls["coarse"], calls["fine"], calls["camera"]
    want = expected_launches(nc, nf, ncam)
    n_fill = sum(w["camera_aligned"] for w in fill.windows)
    finite = all(bool(np.isfinite(preds[k]).all()) for k in (
        "extrinsics", "intrinsics", "extra_params", "points3d"))
    ok = (bool(preds["registered"].all()) and finite and n_fill >= 1
          and ncam == 1 + n_fill and got == want)
    auc = float(pose_auc30(torch.as_tensor(preds["extrinsics"]), gt[:48]))
    print(f"video: the camera fill on (the CLI's default), 48 frames, the "
          f"kernels' inputs recorded: {fill_s:.2f} s, peak {fill_gb:.2f} "
          f"GiB (the recorded copies included); windows filled by the "
          f"camera {n_fill} of {len(fill.windows)}, registered "
          f"{int(preds['registered'].sum())} / 48, AUC@30 {auc:.4f} (not "
          f"gated: seeded camera weights); calls: {nc} coarse, {nf} "
          f"fine, {ncam} camera; launches {got} (expected {want}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    report["video_fill"] = {"wall_s": fill_s, "peak_mem_gib": fill_gb,
                            "calls": dict(calls),
                            "launches": got, "windows": fill.windows}
    if not ok:
        raise AssertionError("the camera-fill run misses its gates")
    del fill
    check_kernel_shapes(shapes, report)
    del shapes
    sparse_ba_agreement(report)

    # the device's busy share over the pipeline's first 48 frames (the
    # initial window, one window, the final joint BA), device-only trace
    report["video_profile"] = profile_slice(
        lambda: runner.run(images[:48]), "video_profile.txt", host=False)
    del runner, r
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI on a 32-frame folder (the initial window and one window per
    # host), alone and as two hosts, the three processes at once on the
    # card; the 48-frame folder serves the multi-device phase's CLI ranks
    write_scene_folder({k: v[:48] for k, v in scene.items()},
                       os.path.join(OUT_DIR, "video_frames"))
    scene_dir = os.path.join(OUT_DIR, "video_frames32")
    write_scene_folder({k: v[:32] for k, v in scene.items()}, scene_dir)
    env = dict(os.environ, PYTHONPATH=HERE)
    base = [sys.executable, "-m", "vggsfm_tpu_torch.video_demo", scene_dir,
            "--init-window", "16", "--window", "8"]
    ex = os.path.join(OUT_DIR, "video_exchange")
    if os.path.isdir(ex):
        import shutil

        shutil.rmtree(ex)
    hosts = ["--output", os.path.join(OUT_DIR, "video_hosts"),
             "--num-hosts", "2", "--exchange-dir", ex, "--host-id"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for cmd in (
            base + ["--output", os.path.join(OUT_DIR, "video_cli")],
            base + hosts + ["1"], base + hosts + ["0"])]
    outs, walls = [], []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
            walls.append(time.perf_counter() - t0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        if p.returncode != 0:
            print(o[-3000:], e[-3000:])
            raise AssertionError(f"a video CLI process exited "
                                 f"{p.returncode}")
    summary = json.loads(outs[0][0].strip().splitlines()[-1])
    summary0 = json.loads(outs[2][0].strip().splitlines()[-1])
    cli_s, hosts_s = walls[0], max(walls)
    print(f"video: python3 -m vggsfm_tpu_torch.video_demo on 32 PNGs, "
          f"--init-window 16 --window 8, in a child process: {cli_s:.1f} s "
          f"(beside the two hosts below on the same card); {summary}",
          flush=True)
    assert summary["registered"] == 32, summary
    p0 = np.load(os.path.join(ex, "partial_000.npz"))
    p1 = np.load(os.path.join(ex, "partial_001.npz"))
    P0 = int(p0["shared_points"])
    same = (P0 == int(p1["shared_points"]) and all(
        np.array_equal(p0[k][m], p1[k][m]) for k, m in (
            ("xyz", slice(0, P0)), ("extrinsics", slice(0, 16)),
            ("intrinsics", slice(0, 16)), ("extra", slice(0, 16)))))
    ok = same and summary0["registered"] == 32
    print(f"video: two host processes (--num-hosts 2) on one card, shared "
          f"exchange folder: {hosts_s:.1f} s for the three processes; "
          f"blocks {p0['block'].tolist()} and {p1['block'].tolist()}, "
          f"shared initial map of {P0} points "
          f"equal on both hosts: {same}; host 0: {summary0} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    report["video_cli"] = {"wall_s": cli_s, "summary": summary,
                           "hosts_wall_s": hosts_s, "hosts_summary": summary0,
                           "initial_maps_equal": same}
    if not ok:
        raise AssertionError("the two hosts' initial maps differ or a frame "
                             "is missing")


# the IMC phase: a synthetic IMC tree of IMC_FRAMES frames of
# render_two_plane_scene, cropped to IMC_SIZE x IMC_HEIGHT (the principal
# point moved with the crop) and written as JPEGs at quality 95, as IMC's
# non-square photos are; three bag lists of 5, 10 and 25 frames spread
# over the sequence. IMC_BASELINE a frame (0.72 over the sequence) keeps
# the foreground square (1.4 x 1.4 at depth 2) whole in every view, up to
# ~370 px from where the first frame sees it, and the background fills
# each view; at 0.06 (1.44) the square leaves the end views in part and
# moves up to ~740 px
IMC_FRAMES, IMC_SIZE, IMC_HEIGHT, IMC_BASELINE = 25, 1024, 768, 0.03
IMC_LOCATION = "two_plane_synthetic"
IMC_BAGS = (5, 10, 25)


def write_imc_tree(root: str) -> dict:
    """The synthetic IMC tree under `root`: <location>/set_100/images/*.jpg,
    calibration/calibration_<stem>.npz (K, R, T of the planted cameras)
    and sub_set/<n>bag_000.txt. Returns the scene."""
    import numpy as np
    from PIL import Image

    from vggsfm_tpu_torch.utils.synth import render_two_plane_scene

    scene = render_two_plane_scene(IMC_FRAMES, IMC_SIZE,
                                   baseline=IMC_BASELINE)
    top = (IMC_SIZE - IMC_HEIGHT) // 2
    base = os.path.join(root, IMC_LOCATION, "set_100")
    for d in ("images", "calibration", "sub_set"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    for s in range(IMC_FRAMES):
        stem = f"img_{s:04d}"
        img = (scene["images"][s, top:top + IMC_HEIGHT] * 255).astype(
            np.uint8)
        Image.fromarray(img).save(os.path.join(base, "images", stem + ".jpg"),
                                  quality=95)
        K = scene["intrinsics"][s].astype(np.float64)
        K[1, 2] -= top
        E = scene["extrinsics"][s].astype(np.float64)
        np.savez(os.path.join(base, "calibration",
                              f"calibration_{stem}.npz"),
                 K=K, R=E[:, :3], T=E[:, 3])
    for n in IMC_BAGS:
        frames = np.linspace(0, IMC_FRAMES - 1, n).round().astype(int)
        with open(os.path.join(base, "sub_set", f"{n}bag_000.txt"), "w") as f:
            f.write("\n".join(f"images/img_{s:04d}.jpg" for s in frames))
    return scene


def check_packed_model(model, extrinsics, names, keypoints=None,
                       host=None) -> int:
    """A packed scene's COLMAP model against what the run gave: every frame
    under its name with tvec the predicted translation and qvec its
    rotation (1e-6 beyond its f32 distance from orthonormal); each
    observation the keypoint of its track (keypoint index == track index)
    and, with the run's arrays (`host`), its tracked pixel and the point
    its solved xyz. Returns the number of points."""
    import numpy as np

    from vggsfm_tpu_torch.io.bridge import _quat_to_matrix

    by_name = {im.name: im for im in model.images.values()}
    assert sorted(by_name) == sorted(names), sorted(by_name)
    for s, name in enumerate(names):
        im, e = by_name[name], extrinsics[s].astype(np.float64)
        assert np.array_equal(im.tvec, e[:, 3]), name
        R = e[:, :3]
        orth = np.abs(R @ R.T - np.eye(3)).max()
        assert np.abs(_quat_to_matrix(im.qvec) - R).max() <= orth + 1e-6
        stem = os.path.splitext(name)[0]
        if keypoints is not None:
            assert np.array_equal(
                im.xys, keypoints[stem][im.point3D_ids].astype(np.float64))
        if host is not None:
            assert np.array_equal(im.xys, host["pred_track"][0][s][
                im.point3D_ids].astype(np.float64))
    if host is not None:
        for pid, p3 in model.points3D.items():
            assert np.array_equal(p3.xyz,
                                  host["points3d"][pid].astype(np.float64))
    return len(model.points3D)


def imc_cli_run(report: dict, tree: str) -> dict:
    """`python3 -m vggsfm_tpu_torch.imc_eval` at its defaults on the tree
    in a child process, with the submission and the packed scenes; gates:
    AUC@30 >= 0.85 and >= 100 valid tracks per bag, the files read back
    with the model of each packed scene equal to the poses and keypoints
    the CLI wrote. Returns the JSON table."""
    from vggsfm_tpu_torch.datasets.imc import load_h5
    from vggsfm_tpu_torch.datasets.imc_submission import (
        load_scene_submission,
    )

    out = os.path.join(OUT_DIR, "imc")
    sub, pack = os.path.join(out, "submission"), os.path.join(out, "pack")
    cmd = [sys.executable, "-m", "vggsfm_tpu_torch.imc_eval", "--imc-dir",
           tree, "--calib-ext", ".npz", "--submission-dir", sub,
           "--pack-submission", pack, "--out",
           os.path.join(out, "results.json")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
                          capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        raise AssertionError(f"the IMC CLI exited {proc.returncode}")
    table = json.loads(proc.stdout[proc.stdout.index("{"):])
    print(f"imc: python3 -m vggsfm_tpu_torch.imc_eval at its defaults "
          f"(1024 px, 3 query frames, 4096 ALIKED points, fine tracking, "
          f"seeded weights) on {len(table['bags'])} bags in a child "
          f"process: {cli_s:.1f} s; mean AUC@30 "
          f"{table['mean_auc30']:.4f}", flush=True)
    for line in proc.stderr.strip().splitlines()[-len(table["bags"]):]:
        print(f"  {line}")
    ok = True
    for name, row in table["bags"].items():
        print(f"  {name}: wall {row['wall_s']} s, stages {row['stage_s']}, "
              f"rotation / translation error median "
              f"{row['rot_err_med_deg']:.3f} / "
              f"{row['trans_err_med_deg']:.3f} deg", flush=True)
        # .h5 where h5py is installed, else .npz
        poses = load_h5(next(p for p in (
            os.path.join(sub, f"{name}{ext}") for ext in (".h5", ".npz"))
            if os.path.exists(p)))
        back = load_scene_submission(pack, "imc", name, "vggsfm_tpu")
        names = sorted(f"{k[len('pose_'):]}.jpg" for k in poses)
        extr = [poses[f"pose_{os.path.splitext(n)[0]}"] for n in names]
        n_pts = check_packed_model(back["model"], extr, names,
                                   keypoints=back["keypoints"])
        assert sorted(back["keypoints"]) == [n[:-4] for n in names]
        assert back["matches"] and back["scores"]
        ok &= row["auc30"] >= 0.85 and row["valid_tracks"] >= 100
        print(f"  {name}: the packed scene read back ({n_pts} points, "
              f"{len(back['matches'])} matched pairs) equals the poses and "
              f"keypoints written", flush=True)
    report["imc_cli"] = {"wall_s": cli_s, "table": table}
    if not ok:
        raise AssertionError("an IMC bag misses AUC@30 >= 0.85 or 100 "
                             "valid tracks")
    return table


def imc_solvers_agreement(report: dict) -> None:
    """The two-view solvers no stage calls, on the card and on the CPU on
    the same draws (a CPU generator's), at the JAX package's defaults: on
    4 pairs of 4096 correspondences (0.5 px noise, 20-30% outliers, focal
    1024), `estimate_essential` (256 five-point sets, 4 px),
    `estimate_homography` (1024 four-point sets, lo_num 50, 4 px) and
    `absolute_pose_ransac(refine="epnp")` (256 six-point sets, lo_num 32,
    17 focal trials, 8 px). Gates: H within 1e-4 and the poses within
    5e-4 (0.5 px at focal 1024, against the 8 px threshold: EPnP sums over
    4096 points in another order on each device), their inlier counts
    equal up to the points whose masks differ; E (up to
    sign) within 2e-3 where the winners' inlier counts agree, else the
    counts within 0.1% of the points, and every E within 0.1 of the
    planted one: each device builds its own basis of the five-point
    nullspace (its four eigenvalues are rounding noise), so the
    candidates agree only within their f32 conditioning and a winner at
    the threshold may differ by a few inliers. No host sync on the card
    in the solvers' code (the draws lie there already), but the PnP focal
    factors' upload. Each timed on the card (CUDA events) and once on the
    CPU, with the source lines of its host syncs on the card."""
    import numpy as np
    import torch

    from vggsfm_tpu_torch.twoview import (
        absolute_pose_ransac,
        estimate_essential,
        estimate_homography,
    )
    from vggsfm_tpu_torch.twoview.utils import generate_samples

    rng = np.random.default_rng(11)
    B, N, f, W = 4, 4096, 1024.0, 1024.0
    K = np.array([[f, 0, W / 2], [0, f, W / 2], [0, 0, 1.0]])

    def rot_y(a):
        return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]])

    def project(X, R, t):
        uv = (K @ (X @ R.T + t).T).T
        return uv[:, :2] / uv[:, 2:]

    def noisy(x, frac):
        x = x + rng.normal(scale=0.5, size=x.shape)
        n_out = int(frac * len(x))
        x[:n_out] = rng.uniform(0, W, size=(n_out, 2))
        return x

    ess, hom, pnp, E_gt = ([], []), ([], []), ([], [], []), []
    for b in range(B):
        R, t = rot_y(0.1 + 0.05 * b), np.array([0.5, 0.05 * b, 0.02])
        X = rng.uniform([-2, -2, 4], [2, 2, 8], size=(N, 3))
        x1 = project(X, np.eye(3), np.zeros(3)) + rng.normal(
            scale=0.5, size=(N, 2))
        x2 = noisy(project(X, R, t), 0.2)
        ess[0].append((x1 - K[:2, 2]) / f)
        ess[1].append((x2 - K[:2, 2]) / f)
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E_gt.append(tx @ R / np.linalg.norm(tx @ R))
        P = X.copy()
        P[:, 2] = 6.0  # a plane
        hom[0].append(project(P, np.eye(3), np.zeros(3)))
        hom[1].append(noisy(project(P, R, t), 0.3))
        pnp[0].append(X)
        pnp[1].append(noisy(project(X, R, t), 0.25))
        pnp[2].append(K)
    g = torch.Generator().manual_seed(5)
    draws = {k: generate_samples(g, N, n, k)[0]
             for k, n in ((5, 256), (4, 1024), (6, 256))}

    def run(dev):
        # the inputs and the draws on the device once, before any call
        e1, e2, h1, h2, X, x, Ks = (
            torch.as_tensor(np.stack(a), dtype=torch.float32, device=dev)
            for a in (*ess, *hom, *pnp))
        d = {k: v.to(dev) for k, v in draws.items()}
        return {
            "essential": lambda: estimate_essential(
                e1, e2, sample_idx=d[5], max_ransac_iters=256,
                focal_length=f),
            "homography": lambda: estimate_homography(h1, h2,
                                                      sample_idx=d[4]),
            "pnp_epnp": lambda: absolute_pose_ransac(
                X, x, Ks, sample_idx=d[6], refine="epnp")}

    def sync_sites(fn) -> dict:
        """The source lines (file:line) of the host syncs of fn() on the
        card, with their counts (CUDA sync debug mode)."""
        import warnings

        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        sites = {}
        for w in caught:
            if "synchroniz" in str(w.message):
                k = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
                sites[k] = sites.get(k, 0) + 1
        return sites

    rows = {}
    card, cpu = run("cuda"), run("cpu")
    for name, card_fn in card.items():
        t0 = time.perf_counter()
        c = cpu[name]()
        cpu_s = time.perf_counter() - t0
        g_out = card_fn()
        torch.cuda.synchronize()
        ms = cuda_time_ms(card_fn, 3, warmup=1)
        syncs = sync_sites(card_fn)
        gn, cn = g_out["inlier_num"].cpu(), c["inlier_num"]
        flips = int((g_out["inlier_mask"].cpu() != c["inlier_mask"]).sum())
        if name == "essential":
            def off(a, b):  # up to sign
                return torch.minimum((a - b).abs().amax((-2, -1)),
                                     (a + b).abs().amax((-2, -1)))

            gE = g_out["emat"].cpu()
            gt = torch.as_tensor(np.stack(E_gt), dtype=torch.float32)
            d, same = off(gE, c["emat"]), gn == cn
            ok = (bool((d[same] <= 2e-3).all())
                  and bool(((gn - cn).abs() <= N // 1000).all())
                  and bool((off(gE, gt) <= 0.1).all())
                  and bool((off(c["emat"], gt) <= 0.1).all()))
            diff = float(d.max())
        elif name == "homography":
            diff = float((g_out["hmat"].cpu() - c["hmat"]).abs().max())
            ok = diff <= 1e-4
        else:
            diff = float((g_out["extrinsics"].cpu()
                          - c["extrinsics"]).abs().max())
            ok = diff <= 5e-4 and torch.equal(g_out["intrinsics"].cpu(),
                                              c["intrinsics"])
        ok &= int((gn - cn).abs().sum()) <= flips
        # no sync in the solvers' code (a sync there names its line, the
        # five-point bisection's determinants included); PnP uploads its
        # focal factors in each call
        ok &= not any(site.startswith(f"vggsfm_tpu_torch/twoview/{m}.py")
                      for site in syncs for m in (
                          "five_point", "homography", "epnp", "utils"))
        ok &= sum(v for k, v in syncs.items() if k.startswith(
            "vggsfm_tpu_torch/twoview/pnp.py")) <= 1
        print(f"imc: {name} on the card vs the CPU, {B} x {N} "
              f"correspondences, the same draws: max diff {diff:.2e}, "
              f"inliers {gn.tolist()} vs {cn.tolist()} ({flips} differing "
              f"mask entries); card {ms:.2f} ms a call, host syncs {syncs}; "
              f"CPU {cpu_s:.3f} s {'ok' if ok else 'FAIL'}", flush=True)
        rows[name] = {"card_ms": ms, "cpu_s": cpu_s, "host_syncs": syncs,
                      "max_diff": diff, "inliers_card": gn.tolist(),
                      "inliers_cpu": cn.tolist()}
        if not ok:
            raise AssertionError(f"{name}: the card and the CPU disagree")
    report["imc_solvers"] = rows


def imc_phase(report: dict, launches: dict) -> None:
    """The IMC evaluation path: a synthetic IMC tree (`write_imc_tree`),
    the CLI at its defaults in a child process (`imc_cli_run`); then in
    this process, on a runner of the CLI's configuration, each bag once
    more with the kernels' inputs recorded (`KernelShapes`; not timed),
    its launch counts exact (`expected_launches` of the counted coarse,
    fine and camera calls) and its packed scene equal to its predictions;
    a device-only profile of the 25-frame bag; every kernel against its
    plain version at each recorded shape (the time blocks and the camera
    at L = 5, 10 and 25); and the two-view solvers card vs CPU
    (`imc_solvers_agreement`). `launches` gets the bags' launch counts."""
    import numpy as np
    import torch

    from vggsfm_tpu_torch import imc_eval
    from vggsfm_tpu_torch.datasets.imc import IMCDataset, evaluate_bag
    from vggsfm_tpu_torch.datasets.imc_submission import (
        load_scene_submission,
        pack_scene_submission,
    )
    from vggsfm_tpu_torch.ops import fused_mlp as fm
    from vggsfm_tpu_torch.runner import VGGSfMRunner, to_host

    gc.collect()
    torch.cuda.empty_cache()
    tree = os.path.join(OUT_DIR, "imc_tree")
    t0 = time.perf_counter()
    write_imc_tree(tree)
    print(f"imc: the synthetic IMC tree, {IMC_FRAMES} frames of "
          f"render_two_plane_scene at {IMC_SIZE} px (baseline "
          f"{IMC_BASELINE} a frame) cropped to {IMC_SIZE} x {IMC_HEIGHT}, "
          f"JPEG quality 95, bags of {IMC_BAGS} frames: "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    imc_cli_run(report, tree)

    args = imc_eval.parse_args(["--imc-dir", tree, "--calib-ext", ".npz"])
    runner = VGGSfMRunner(imc_eval.runner_config(args), device="cuda")
    calls = {"coarse": 0, "fine": 0, "camera": 0}
    coarse, fine = runner._coarse_track, runner._fine_track

    def counted(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    runner._coarse_track = counted(coarse, "coarse")
    runner._fine_track = counted(fine, "fine")
    runner.camera.register_forward_hook(
        lambda *a: calls.__setitem__("camera", calls["camera"] + 1))
    ds = IMCDataset(tree, img_size=args.img_size, calib_ext=".npz")
    shapes = KernelShapes()
    rows = {}
    for name in ds.sequence_names():
        data = ds.load_bag(name)
        calls.update(coarse=0, fine=0, camera=0)
        fm.reset_launch_counts()
        with shapes:
            out = runner.sparse_reconstruct(data["images"],
                                            image_names=data["image_names"])
        torch.cuda.synchronize()
        got = dict(fm.launch_counts)
        fm.reset_launch_counts()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        want = expected_launches(calls["coarse"], calls["fine"],
                                 calls["camera"])
        host = to_host({k: out[k] for k in (
            "extrinsics", "intrinsics", "extra_params", "points3d",
            "valid_tracks", "valid_2d_mask", "pred_track", "pred_score",
            "colors")})
        auc = evaluate_bag(host["extrinsics"], data["gt_extrinsics"])["auc30"]
        finite = all(bool(np.isfinite(host[k]).all()) for k in (
            "extrinsics", "intrinsics", "points3d"))
        pack = os.path.join(OUT_DIR, "imc", "pack_in_process")
        pack_scene_submission(pack, "imc", name, "vggsfm_tpu",
                              data["image_names"], host,
                              image_size=(args.img_size, args.img_size))
        n_pts = check_packed_model(
            load_scene_submission(pack, "imc", name, "vggsfm_tpu")["model"],
            host["extrinsics"], data["image_names"], host=host)
        ok = got == want and finite
        print(f"imc: {name} in this process, the kernels' inputs recorded: "
              f"AUC@30 {auc:.4f}, valid tracks "
              f"{int(host['valid_tracks'].sum())}, packed model equal to the "
              f"predictions ({n_pts} points); calls: {calls['coarse']} "
              f"coarse, {calls['fine']} fine, {calls['camera']} camera; "
              f"launches {got} (expected {want}) {'ok' if ok else 'FAIL'}",
              flush=True)
        rows[name] = {"auc30": auc, "launches": got, "calls": dict(calls),
                      "timings": dict(out["timings"])}
        if not ok:
            raise AssertionError(f"{name}: launch counts or values")
    report["imc_in_process"] = rows

    # where the device's time goes on the largest bag
    big = ds.sequence_names()[[len(ds.sequences[n]) for n in
                               ds.sequence_names()].index(max(IMC_BAGS))]
    data = ds.load_bag(big)
    report["imc_profile"] = profile_slice(
        lambda: runner.sparse_reconstruct(data["images"]),
        "imc_profile.txt", host=False)
    del runner, out
    gc.collect()
    torch.cuda.empty_cache()
    check_kernel_shapes(shapes, report, "imc")
    del shapes
    imc_solvers_agreement(report)


# ------------------------------------------------------------ phase 15

# the sharded step's full-width cell: render_two_plane_scene at the matched
# workload's frames and size, MULTI_POINTS Harris query points, bf16
MULTI_FRAMES, MULTI_SIZE, MULTI_POINTS = 8, 1024, 4096
# tracks of the two-rank step within 1e-2 px of the one-rank step's in
# every frame: seeded weights leave the coarse tracks at the matching init
# (zero flow heads), whose argmax steps may flip on a near-tie where the
# block of half the tracks rounds its products otherwise
MULTI_TRACK_SHARE = 0.99


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _seeded_tracker():
    import torch

    from vggsfm_tpu_torch.models.tracker import (
        TrackerPredictor,
        init_tracker_,
    )

    tracker = TrackerPredictor(dtype=torch.bfloat16)
    init_tracker_(tracker, torch.Generator().manual_seed(0))
    return tracker.to("cuda").eval()


def _step_run(mesh, images, record: bool) -> dict:
    """The sharded step on `mesh`: a first call (with the kernels' inputs
    recorded when `record`), then a timed call with the launch counts read
    around it. Host copies of its outputs, the valid points, the BA costs,
    the wall and the launches."""
    import torch

    from vggsfm_tpu_torch.ops import fused_mlp as fm
    from vggsfm_tpu_torch.parallel.sharded import (
        sharded_track_and_reconstruct,
    )

    step = sharded_track_and_reconstruct(_seeded_tracker(), mesh)
    shapes = KernelShapes() if record else contextlib.nullcontext()
    with shapes:
        step(images, max_query_pts=MULTI_POINTS)
    torch.cuda.synchronize()
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(images, max_query_pts=MULTI_POINTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fm.launch_counts)
    fm.reset_launch_counts()
    return {"out": [t.detach().cpu() for t in out],
            "valid": step.valid_points.cpu(),
            "initial_cost": float(step.ba_info["initial_cost"]),
            "wall_s": wall, "launches": launches,
            "shapes": shapes if record else None}


def _multi_rank(rank: int, world: int, init: str, folder: str) -> None:
    """One of the two gloo ranks sharing cuda:0: (a) the sharded step,
    its kernels held against their plain versions at the shapes rank 0's
    block gave them; (b) `distributed_bundle_adjust` on the recorded joint
    BA. Results to folder/rank{r}.pt."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=world, rank=rank)
    try:
        from vggsfm_tpu_torch.ops import _build
        from vggsfm_tpu_torch.parallel.mesh import make_mesh
        from vggsfm_tpu_torch.parallel.multihost import (
            distributed_bundle_adjust,
        )

        _build.load_library()
        mesh = make_mesh()
        images = torch.from_numpy(np.load(os.path.join(folder,
                                                       "images.npy")))
        res = _step_run(mesh, images[None], record=rank == 0)
        rows = {}
        if rank == 0:
            check_kernel_shapes(res.pop("shapes"), rows, path="multi")
        res.pop("shapes", None)
        res["kernel_rows"] = rows.get("multi_kernel_shapes", [])
        ba = torch.load(os.path.join(folder, "joint_ba.pt"),
                        weights_only=False)
        dist.barrier()
        t0 = time.perf_counter()
        e, i, x, X, cost = distributed_bundle_adjust(
            mesh, *ba["args"], **ba["kw"])
        torch.cuda.synchronize()
        res["dist_ba"] = {"out": [None if t is None else t.cpu()
                                  for t in (e, i, x, X, cost)],
                          "wall_s": time.perf_counter() - t0}
        torch.save(res, os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def multi_device_phase(report: dict, launches: dict, shared: dict) -> None:
    """(a) The sharded step (`sharded_track_and_reconstruct`) at full width
    on a one-rank NCCL group, then on two gloo ranks sharing cuda:0, with
    the gates; (b) `distributed_bundle_adjust` on the two ranks against
    the plain solver on the card at the video run's joint-BA size; (c) the
    video CLI as two ranks with --distributed-ba 2."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from vggsfm_tpu_torch.ba import bundle_adjust_sparse
    from vggsfm_tpu_torch.geometry.metrics import pose_auc30
    from vggsfm_tpu_torch.parallel.mesh import make_mesh
    from vggsfm_tpu_torch.utils.synth import render_two_plane_scene

    folder = os.path.join(OUT_DIR, "multi")
    os.makedirs(folder, exist_ok=True)
    scene = render_two_plane_scene(MULTI_FRAMES, MULTI_SIZE)
    images = torch.from_numpy(scene["images"])
    np.save(os.path.join(folder, "images.npy"), scene["images"])
    gt = torch.as_tensor(scene["extrinsics"])
    ba = shared.pop("joint_ba")
    torch.save(ba, os.path.join(folder, "joint_ba.pt"))

    # (a) world size 1 on NCCL
    init = os.path.join(folder, "nccl_pg")
    if os.path.exists(init):
        os.remove(init)
    dist.init_process_group("nccl", init_method=f"file://{init}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        one = _step_run(mesh, images[None].cuda(), record=True)
    finally:
        dist.destroy_process_group()
    check_kernel_shapes(one.pop("shapes"), report, path="multi1")

    # (a) and (b) on two gloo ranks on the card
    init = os.path.join(folder, "gloo_pg")
    for f in [init] + [os.path.join(folder, f"rank{r}.pt") for r in (0, 1)]:
        if os.path.exists(f):
            os.remove(f)
    t0 = time.perf_counter()
    ctx = mp.start_processes(_multi_rank, args=(2, init, folder), nprocs=2,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(1.0, 300 - (time.perf_counter()
                                                   - t0))):
            if time.perf_counter() - t0 > 300:
                raise TimeoutError("the two ranks did not end in 300 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks_s = time.perf_counter() - t0
    two = [torch.load(os.path.join(folder, f"rank{r}.pt"),
                      weights_only=False) for r in (0, 1)]
    report.setdefault("multi_kernel_shapes", []).extend(
        two[0].pop("kernel_rows"))
    two[1].pop("kernel_rows")

    tracks1, vis1, pts1, extr1, cost1 = one["out"]
    v1 = one["valid"]
    want = expected_launches(1, 1, 0)
    rows = []
    ok = True
    for label, r in [("1 rank (NCCL)", one)] + [
            (f"2 ranks (gloo), rank {k}", two[k]) for k in (0, 1)]:
        tracks, vis, pts, extr, cost = r["out"]
        valid = r["valid"]
        finite = all(bool(torch.isfinite(t).all()) for t in (
            tracks, vis, extr, cost)) and bool(torch.isfinite(pts[valid])
                                               .all())
        med, mx, share = track_agreement(tracks.float(), tracks1.float())
        cost_rel = abs(float(cost) - float(cost1)) / float(cost1)
        auc = float(pose_auc30(extr, gt))
        good = (finite and int(valid.sum()) >= 100
                and float(cost) <= r["initial_cost"]
                and r["launches"] == want and share >= MULTI_TRACK_SHARE
                and cost_rel <= 1e-3)
        ok &= good
        print(f"multi-device (a): the sharded step, {MULTI_FRAMES} x "
              f"{MULTI_SIZE} px, {MULTI_POINTS} Harris points, fine, bf16, "
              f"{label}: {r['wall_s']:.3f} s; valid points "
              f"{int(valid.sum())} (>= 100); BA cost {r['initial_cost']:.2f}"
              f" -> {float(cost):.4f} (<= initial; {cost_rel:.2e} from one "
              f"rank, <= 1e-3); tracks against one rank: median {med:.2e} "
              f"px, max {mx:.2e} px, share within 1e-2 px {share:.4f} (>= "
              f"{MULTI_TRACK_SHARE}); AUC@30 against the planted cameras "
              f"{auc:.4f} (not gated); launches {r['launches']} (expected "
              f"{want}) {'ok' if good else 'FAIL'}", flush=True)
        rows.append({"side": label, "wall_s": r["wall_s"],
                     "valid": int(valid.sum()),
                     "initial_cost": r["initial_cost"],
                     "final_cost": float(cost), "cost_rel": cost_rel,
                     "track_share": share, "track_max_px": mx, "auc30": auc,
                     "launches": r["launches"]})
    same = all(torch.equal(a, b) for a, b in zip(two[0]["out"],
                                                 two[1]["out"]))
    ok &= same
    print(f"multi-device (a): the two ranks' outputs equal: {same}; both "
          f"ranks' process start, build load, two steps and (b) "
          f"{ranks_s:.1f} s", flush=True)
    for k, v in one["launches"].items():
        launches[k] = launches.get(k, 0) + v
    report["multi_step"] = {"rows": rows, "ranks_equal": same,
                            "ranks_wall_s": ranks_s}

    # (b) the joint BA on two ranks against the plain solver on the card
    args = [a.cuda() if torch.is_tensor(a) else a for a in ba["args"]]
    kw = {k: (v.cuda() if torch.is_tensor(v) else v)
          for k, v in ba["kw"].items()}
    bundle_adjust_sparse(*args, **kw)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e, i, x, X, info = bundle_adjust_sparse(*args, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    cost = float(info["final_cost"])
    S, P, O = args[0].shape[0], args[2].shape[0], args[3].shape[0]
    for k, r in enumerate(two):
        de, di, dx, dX, dcost = r["dist_ba"]["out"]
        rel = abs(float(dcost) - cost) / cost
        e_err = float((de - e.cpu()).abs().max())
        X_err = float((dX - X.cpu()).abs().max())
        good = rel <= 1e-3 and e_err <= 1e-2 and X_err <= 5e-2
        ok &= good
        print(f"multi-device (b): distributed_bundle_adjust on 2 gloo "
              f"ranks on the card (rank {k}), the video run's last joint "
              f"BA ({S} frames, {P} points, {O} observations): "
              f"{r['dist_ba']['wall_s']:.3f} s, plain solver on the card "
              f"{plain_s:.3f} s; cost {float(info['initial_cost']):.4f} -> "
              f"{float(dcost):.4f} against {cost:.4f} ({rel:.2e}, <= "
              f"1e-3), poses {e_err:.2e} (<= "
              f"1e-2), points {X_err:.2e} (<= 5e-2) "
              f"{'ok' if good else 'FAIL'}", flush=True)
    report["multi_dist_ba"] = {
        "frames": S, "points": P, "observations": O, "plain_s": plain_s,
        "dist_s": [r["dist_ba"]["wall_s"] for r in two], "cost": cost}
    if not ok:
        raise AssertionError("the sharded step or the distributed BA "
                             "misses its gates")
    del two, one
    gc.collect()
    torch.cuda.empty_cache()
    video_distributed_cli(report)


def video_distributed_cli(report: dict) -> None:
    """(c) `python3 -m vggsfm_tpu_torch.video_demo --distributed-ba 2` as
    two ranks of one gloo group on cuda:0 (VGGSFM_COORDINATOR,
    VGGSFM_NUM_PROCESSES, VGGSFM_PROCESS_ID), each writing its own model,
    over the video phase's 48-frame folder: every frame registered, the
    two models equal."""
    from vggsfm_tpu_torch.io.colmap import read_model

    scene_dir = os.path.join(OUT_DIR, "video_frames")
    port = _free_port()
    outs = [os.path.join(OUT_DIR, f"video_dist_{r}") for r in (0, 1)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vggsfm_tpu_torch.video_demo", scene_dir,
         "--output", outs[r], "--distributed-ba", "2", "--dist-backend",
         "gloo"], cwd=HERE, env=dict(
             os.environ, PYTHONPATH=HERE,
             VGGSFM_COORDINATOR=f"localhost:{port}",
             VGGSFM_NUM_PROCESSES="2", VGGSFM_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    res = []
    try:
        for p in procs:
            res.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    for p, (o, e) in zip(procs, res):
        if p.returncode != 0:
            print(o[-3000:], e[-3000:])
            raise AssertionError(f"a --distributed-ba rank exited "
                                 f"{p.returncode}")
    sums = [json.loads(o.strip().splitlines()[-1]) for o, _ in res]
    files = ("cameras.bin", "images.bin", "points3D.bin")
    same = all(open(os.path.join(outs[0], "sparse", f), "rb").read()
               == open(os.path.join(outs[1], "sparse", f), "rb").read()
               for f in files)
    rec = read_model(os.path.join(outs[0], "sparse"))
    ok = same and all(s["registered"] == s["frames"] == 48 for s in sums)
    print(f"multi-device (c): python3 -m vggsfm_tpu_torch.video_demo "
          f"--distributed-ba 2 as two gloo ranks on one card, 48 frames: "
          f"{wall:.1f} s for both; the two models byte-equal: {same} "
          f"({len(rec.images)} images, {len(rec.points3D)} points); "
          f"summaries {sums} {'ok' if ok else 'FAIL'}", flush=True)
    report["multi_video_cli"] = {"wall_s": wall, "summaries": sums,
                                 "models_equal": same}
    if not ok:
        raise AssertionError("the --distributed-ba ranks' models differ or "
                             "a frame is missing")


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
        "corr_sample_pallas": {
            "name": "corr_sample_pallas", "route": "cuda",
            "source": "vggsfm_tpu_torch/csrc/corr_sample.cu",
            "replaces": "vggsfm_tpu/ops/corr_pallas.py:85"},
        "corr_sample_pallas_smallc": {
            "name": "corr_sample_pallas_smallc", "route": "cuda",
            "source": "vggsfm_tpu_torch/csrc/corr_sample.cu",
            "replaces": "vggsfm_tpu/ops/corr_pallas.py:255"},
        "flash_attention": {
            "name": "flash_attention", "route": "cuda",
            "source": "vggsfm_tpu_torch/csrc/flash_attn.cu",
            "replaces": None},
    }
    try:
        from vggsfm_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.load_library()
        info = _build.build_info["vf_former"]
        print(f"build: {time.perf_counter() - t0:.1f} s "
              f"(nvcc {info['seconds']:.1f} s)", flush=True)
        spills = []
        for kname, props in ptxas_report(info["log"]):
            print(f"  ptxas: {kname}: {props}")
            if "vcorr" in kname and (
                    ", 0 bytes spill stores, 0 bytes spill loads"
                    not in props):
                spills.append(kname)
        if info["log"] != "cached" and spills:
            raise AssertionError(f"correlation kernels spill: {spills}")
        lib = _build.load_library()
        print(f"  dynamic shared memory per block: block kernel bf16 C=384 "
              f"H=8 L=8 {lib.vf_block_smem_bytes(384, 8, 8)} B, "
              f"L=64 {lib.vf_block_smem_bytes(384, 8, 64)} B; "
              f"ln_mlp bf16 C=384 {lib.vf_ln_mlp_smem_bytes(384)} "
              f"B; wide ln_mlp GEMM bf16 C=768 "
              f"{lib.vf_ln_mlp_smem_bytes(768)} B; ln_attn C=768 "
              f"H=8 L=8 f32 {lib.vf_attn_smem_bytes(768, 8, 8, 4)} B; "
              f"correlation C=128 r=4 {lib.vf_corr_smem_bytes(128, 4, 0)} "
              f"B, flat C=32 r=3 {lib.vf_corr_smem_bytes(32, 3, 1)} B (of "
              f"232448)", flush=True)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: kernel build FAILED", flush=True)
        return 1

    extra = {}
    # by main-path slice
    launches = {"tracker": {}, "camera": {}, "few_tracks": {},
                "reconstruct": {}, "export": {}, "dense": {}, "video": {},
                "imc": {}, "multi": {}, "vggt": {}}
    shared = {}
    for phase, fn in (
            ("kernels", lambda: kernel_phase(report, extra)),
            ("correlation kernels",
             lambda: corr_kernel_phase(report, extra)),
            ("attention kernel", lambda: attention_kernel_phase(report)),
            ("slice", lambda: slice_phase(extra, launches["tracker"])),
            ("agree", lambda: agree_phase(extra)),
            ("camera", lambda: camera_phase(extra, launches["camera"])),
            ("camera agree", lambda: camera_agree_phase(extra)),
            ("few tracks",
             lambda: few_tracks_phase(extra, launches["few_tracks"])),
            ("query points", lambda: query_points_phase(extra)),
            ("reconstruct",
             lambda: reconstruct_phase(extra, launches["reconstruct"])),
            ("end to end", lambda: end_to_end_phase(extra)),
            ("export",
             lambda: export_phase(extra, launches["export"], shared)),
            ("dense and visuals",
             lambda: dense_phase(extra, launches["dense"], shared)),
            ("video", lambda: video_phase(extra, launches["video"],
                                          shared)),
            ("imc", lambda: imc_phase(extra, launches["imc"])),
            ("multi-device",
             lambda: multi_device_phase(extra, launches["multi"], shared)),
            ("vggt", lambda: vggt_phase(extra, launches["vggt"]))):
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
                    "library_ms", "composed_ms", "device_ms",
                    "previous_route_ms"):
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

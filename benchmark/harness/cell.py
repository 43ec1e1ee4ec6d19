"""One run of one cell: set-up, the measured window, the traced scene
(with --trace 1), and the check against the reference.

The window is a closed loop of one client: the next scene starts as soon
as the last one returned. It takes the pool's scenes 1.. (scene 0 serves
the warm-up and the traced run) in an order drawn from the run's seed,
and starts none once `seconds` have passed. A cell's pool is sized so
that the last scene starts inside the window on a card half again as
slow as the one it was measured on: every run does the same work, and
its pose accuracy and rate do not hang on how many scenes fit. Its
frames_per_s is all the frames completed over all the time they took.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import numpy as np
import torch

from benchmark.harness import checks, family, trace
from benchmark.harness.auc import pose_auc
from benchmark.harness.flops import count_calls

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# files a run writes (a checkpoint a pipeline hands the program),
# inside the checkout and listed in .gitignore
WORK_DIR = os.path.join(HERE, "_work")


def load_cell(workload: str) -> tuple:
    def load(*parts):
        with open(os.path.join(HERE, *parts)) as f:
            return json.load(f)

    wl = load("workloads", f"{workload}.json")
    return load("configs", f"{wl['config']}.json"), wl


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64,
                                                        salt]))


def _stamp(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, t_start: float) -> dict:
    """The record the metric readers read, for the cell named
    `workload`."""
    cfg, wl = load_cell(workload)
    return run_loaded(cfg, wl, seed, seconds, traced, device, t_start)


def run_loaded(cfg: dict, wl: dict, seed: int, seconds: float,
               traced: bool, device, t_start: float) -> dict:
    """`run_cell` on a configuration and a workload as loaded. The record
    keeps the checked scene's frames and what the program produced for it
    (``frames``, ``sample``), for readings in other precisions."""
    fam = family.of(cfg)
    pipe = family.pipeline_module(cfg).Pipeline(cfg, wl, device, WORK_DIR)
    warm_frames = pipe.warm_up()
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    _stamp(f"set-up {setup_s:.3f} s")

    # the window's order of the scenes; the check samples the first (which
    # every window completes) and which of its calls the recorder keeps
    order = [int(j) for j in
             1 + _rng(seed, 1).permutation(len(pipe.scenes) - 1)]
    sample_at = order[0]
    sample_call = int(_rng(seed, 2).integers(pipe.sample_calls()))
    rec = pipe.recorder
    rec.counting = traced
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    results = []
    t0 = time.perf_counter()
    for i in order:
        if i == sample_at:
            rec.sample_scene(sample_call)
        ts = time.perf_counter()
        res = pipe.run(i)
        sync()
        res["seconds"] = time.perf_counter() - ts
        res["index"] = i
        if i == sample_at:
            res["sample"] = rec.stop_sampling()
        results.append(res)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    for res in results:
        _stamp(f"scene {res['index']}: {res['seconds']:.3f} s")
    rec.counting = False
    census = list(rec.census)

    scenes_rec = []
    for res in results:
        s = pipe.scenes[res["index"]]
        scenes_rec.append({
            "index": res["index"],
            "frames": pipe.frames(res["index"]), "seconds": res["seconds"],
            "timings": {k: float(v) for k, v in res["timings"].items()},
            "auc5": pose_auc(res["extrinsics"].float(),
                             torch.as_tensor(s["extrinsics"])),
            "solve": pipe.solve_checks(res, s)})
    failed = sum(1 for s in scenes_rec if fam.scene_failed(s["solve"]))
    record = {"setup_s": setup_s, "window_s": window_s, "peak_bytes": peak,
              "scenes": scenes_rec, "config": cfg, "workload": wl}
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    record["device"] = {"platform": "gpu" if device.type == "cuda"
                        else "cpu", "kind": kind, "count": 1,
                        "memory_peak_bytes": int(peak)}

    if traced:
        record["trace"] = _profile(pipe, warm_frames, sync, fam)
        record["device"].update(busy_s=record["trace"]["busy_s"],
                                window_s=record["trace"]["window_s"])
        record["breakdown"] = {"device_ops": record["trace"]["top_ops"],
                               "idle_gaps": record["trace"]["idle_gaps"]}

    max_pts = fam.max_query_pts(pipe)
    sampled = next(r for r in results if "sample" in r)
    frames = pipe.scenes[sampled["index"]]["images"]
    sample = sampled["sample"]
    fam.check_sample(pipe, sample)
    # the program's state goes before the reference runs
    rec.close()
    del results, sampled, pipe, rec
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = neural_readings(cfg, max_pts, device, frames, sample)
    solve = {name: fam.over_window(
                 name, [s["solve"][name] for s in scenes_rec], side)
             for name, (side, _) in cfg["checks"].items()
             if name not in fam.NEURAL}
    record["readings"] = {**{k: {"f32": v} for k, v in solve.items()},
                          **readings}
    record["checks"] = _check(cfg, {**solve, **{
        k: v["f32"] for k, v in readings.items()}})
    record["correct"] = all(c["ok"] for c in record["checks"])
    record.update(frames=frames, sample=sample, max_pts=max_pts)
    if traced:
        record["model_flops"] = count_calls(device, census,
                                            fam.census_modules)
    record["attempted"] = len(scenes_rec)
    record["failed"] = failed
    return record


def _profile(pipe, frames: int, sync, fam) -> dict:
    """The warm-up again, under torch.profiler, with the kernel ranges
    on."""
    rec = pipe.recorder
    rec.kernel_ranges(True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        ts = time.perf_counter()
        pipe.warm_up()
        sync()
        wall = time.perf_counter() - ts
    rec.kernel_ranges(False)
    out = trace.reduce(prof, wall, frames, rec.kernel_calls, fam.KERNELS)
    rec.kernel_calls = []
    return out


def neural_readings(cfg: dict, max_pts: int, device, frames, sample: dict,
                    modes=("f32",)) -> dict:
    """name -> mode -> reading, for every neural number the configuration
    compares (`checks.readings` of the family's `NEURAL`); `max_pts` is
    the family's `max_query_pts` of the run."""
    fam = family.of(cfg)
    want = [n for n in cfg["checks"] if n in fam.NEURAL]
    ref = fam.reference_models(
        cfg, device, sorted({fam.NEURAL[n][3] for n in want} - {None}))
    x = torch.as_tensor(frames).to(device)
    out = {}
    for name in want:
        out[name] = checks.readings(fam.NEURAL[name], ref, x, sample, modes,
                                    **fam.want_kwargs(name, max_pts))
    return out


def _check(cfg: dict, values: dict) -> list:
    """Every number the configuration compares, beside its limit and
    what it reads (a neural check's from the family's `NEURAL`, a solve
    number's from its `SCENE_READS`)."""
    fam = family.of(cfg)
    out = []
    for name, (side, limit) in cfg["checks"].items():
        v = values[name]
        reads = (fam.NEURAL[name][4] if name in fam.NEURAL
                 else fam.entry("SCENE_READS", name))
        out.append({"name": name, "value": v, "side": side, "limit": limit,
                    "reads": reads,
                    "ok": limit is not None and checks.passes(v, side,
                                                              limit)})
    return out

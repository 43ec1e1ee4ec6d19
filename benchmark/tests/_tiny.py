"""A cell at a size a CPU test run holds: the sparse configuration's
published widths on 3 frames of 128 px, 2 query frames x 64 points."""

import copy
import time

import torch

from benchmark.harness.cell import load_cell, run_loaded


def tiny_sparse():
    cfg, wl = load_cell("sparse-8q-4096")
    cfg, wl = copy.deepcopy(cfg), copy.deepcopy(wl)
    cfg["runner"].update(img_size=128, max_query_pts=64, min_vis_points=8)
    wl["runner"] = {"query_frame_num": 2}
    wl["scene"]["frames"] = 3
    wl["pool"] = 2
    return cfg, wl


def run_tiny(seed: int) -> dict:
    torch.set_num_threads(4)
    cfg, wl = tiny_sparse()
    return run_loaded(cfg, wl, seed, 0.0, False, torch.device("cpu"),
                      time.perf_counter())

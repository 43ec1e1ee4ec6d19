"""The metric readers on a recorded run record."""

import importlib

import pytest

RECORD = {
    "setup_s": 31.5, "window_s": 20.0, "peak_bytes": 13 * 2 ** 30,
    "config": {"timings": {"camera": ["camera_init"],
                           "tracker": ["coarse", "fine"],
                           "solve": ["preliminary", "sfm", "video.windows",
                                     "-video.track"]}},
    "scenes": [
        {"frames": 8, "seconds": 4.0, "auc5": 0.75,
         "timings": {"camera_init": 0.25, "coarse": 1.5, "fine": 0.5,
                     "preliminary": 0.5, "sfm": 1.0, "video.windows": 0.4,
                     "video.track": 0.1}},
        {"frames": 8, "seconds": 6.0, "auc5": 0.85,
         "timings": {"camera_init": 0.35, "coarse": 1.7, "fine": 0.7,
                     "preliminary": 0.7, "sfm": 1.4}},
    ],
    "trace": {"busy_s": 3.0, "window_s": 5.0, "device_ops": 160000,
              "frames": 8,
              "kernels": {"former": {"bound_s": 0.08, "device_s": 1.0,
                                     "calls": 10},
                          "corr": {"bound_s": 0.01, "device_s": 0.1,
                                   "calls": 2}}},
    "model_flops": 2.0e14,
}


@pytest.mark.parametrize("name,want", [
    ("setup_s", 31.5),
    ("frames_per_s", 16 / 10.0),
    ("pose_auc5", 0.8),
    ("peak_mem_gib", 13.0),
    ("camera_ms_per_frame", 1e3 * 0.6 / 16),
    ("tracker_ms_per_frame", 1e3 * 4.4 / 16),
    ("solve_ms_per_frame", 1e3 * (0.5 + 1.0 + 0.4 - 0.1 + 0.7 + 1.4) / 16),
    ("former_roofline", 8.0),
    ("corr_roofline", 10.0),
    ("step_mfu", 100 * 2.0e14 / (20.0 * 989e12)),
    ("device_idle_share", 40.0),
    ("device_launches_per_frame", 20000.0),
])
def test_reader(name, want):
    got = importlib.import_module(f"benchmark.metrics.{name}").read(RECORD)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["former_roofline", "corr_roofline",
                                  "step_mfu", "device_idle_share",
                                  "device_launches_per_frame"])
def test_untraced_record_reads_nothing(name):
    rec = {k: v for k, v in RECORD.items()
           if k not in ("trace", "model_flops")}
    assert importlib.import_module(
        f"benchmark.metrics.{name}").read(rec) is None

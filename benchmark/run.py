"""The benchmark of vggsfm_tpu_torch on one GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One process runs one cell (an entry of `workloads` in BENCHMARK.json):
set-up (the port's kernels built or found in vggsfm_tpu_torch/_build/,
the configuration's weights made on the card, the cell's pool of scenes
rendered, a warm-up on the cell's shapes), then a closed loop of one
client for `--seconds`: each scene or sequence of the pool, in an order
drawn from `--seed`, as soon as the last one returned. After the window
it checks one scene the window produced, drawn from `--seed`, against the
plain reference (benchmark/reference) and prints one JSON line: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from the window's spans and one profiled scene after it.

Everything the cell needs is found by name: benchmark/workloads/<cell>.json
(the traffic), benchmark/configs/<config>.json (the configuration and its
check limits), benchmark/pipelines/<pipeline>.py (how the program is
driven) and benchmark/metrics/<metric>.py (one reader per metric).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# where the port builds its CUDA libraries (a fixed directory in the
# checkout): a run that finds none there compiles them in its set-up
BUILD_DIR = os.path.join(ROOT, "vggsfm_tpu_torch", "_build")
# what no process of the benchmark may load: the JAX stack and the JAX
# package the port was made from (top-level names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "vggsfm_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports."""
    metrics = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this cell needs {need} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2

    from benchmark.harness.cell import run_cell

    compiles = not any(n.endswith(".so") and "emu" not in n
                       for n in (os.listdir(BUILD_DIR)
                                 if os.path.isdir(BUILD_DIR) else ()))
    rec = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), T_START)
    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        value = importlib.import_module(
            f"benchmark.metrics.{m['name']}").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    if compiles:
        print(f"set-up {rec['setup_s']:.3f} s includes building the "
              f"port's kernels: the first run in this checkout",
              file=sys.stderr)
    for c in rec["checks"]:
        print(f"check {c['name']}: {c['value']!r} {c['side']} "
              f"{c['limit']!r} ({c['reads']})", file=sys.stderr)
    result = {"correct": rec["correct"], "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics,
              "device": rec["device"]}
    if args.trace:
        result["breakdown"] = rec["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]}
                        for c in rec["checks"]}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

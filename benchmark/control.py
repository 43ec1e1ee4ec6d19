"""The readings the check's limits are set from, on the chip, at a cell's
own size: for each seed, one run of the cell's pipeline over the one
scene the benchmark samples for that seed (its window cut after the first
scene, or with `--seconds` after that long), and every number the
configuration compares: read for the
program, and with `--modes` for the control too (the reference itself in
lower-precision products against the float32 reference); with `--fault`
for the program with that fault planted underneath (the family's
`FAULTS`, benchmark/faults.py).

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        [--modes fp8,tf32] [--fault ba_unchanged] [--seconds 60]

Prints one JSON line per seed. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from benchmark.faults import Patches, plant
    from benchmark.harness import family
    from benchmark.harness.cell import load_cell, neural_readings, \
        run_loaded

    cfg, wl = load_cell(args.workload)
    install = (family.of(cfg).entry("FAULTS", args.fault)[0]
               if args.fault else None)
    modes = tuple(m for m in args.modes.split(",") if m)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        patches = Patches()
        if install is not None:
            plant(family.pipeline_module(cfg).Pipeline, install, patches)
        try:
            rec = run_loaded(cfg, wl, seed, args.seconds, False, device,
                             t0)
        except Exception as e:  # a crash reads no number
            print(json.dumps({"seed": seed, "fault": args.fault,
                              "error": repr(e)}), flush=True)
            continue
        finally:
            patches.undo()
        readings = rec["readings"]
        if modes:
            for name, r in neural_readings(cfg, rec["max_pts"], device,
                                           rec["frames"], rec["sample"],
                                           modes).items():
                readings[name].update(r)
        print(json.dumps({
            "seed": seed, "fault": args.fault, "readings": readings,
            "scenes": [{k: s[k] for k in ("index", "solve", "auc5",
                                          "seconds")}
                       for s in rec["scenes"]],
            "setup_s": rec["setup_s"],
            "total_s": time.perf_counter() - t0}), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI: the IMC benchmark harness on the GPU: bags -> sparse runner ->
AUC@30 table. Counterpart of the JAX package's imc_eval.py, with its
flags and defaults, and one more, --device.

Runs every bag of an IMC tree (`datasets.imc.IMCDataset`: bag lists and
per-image calibrations) through `VGGSfMRunner.sparse_reconstruct`, one
runner for all bags, and scores each with `evaluate_bag` (pairwise
relative rotation and translation errors, AUC@30; reference
vggsfm/utils/metric.py:107-218). Prints a JSON table of each bag's AUC,
errors, valid tracks, wall time and stage times (the runner's, each
ending in a device synchronize), and one line per bag on stderr.

Usage:
    python -m vggsfm_tpu_torch.imc_eval --imc-dir /path/to/IMC \\
        --out imc_results.json [--bags 5bag_000_british_museum ...] \\
        [--checkpoint vggsfm_v2_0_0.bin] [--device cpu]
    python -m vggsfm_tpu_torch.imc_eval --imc-dir DIR --calib-ext .npz

--calib-ext .npz reads the calibrations from .npz files (where h5py is
not installed); without h5py the submission files are .npz too.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--imc-dir", required=True)
    ap.add_argument("--bags", nargs="*", default=None,
                    help="bag names to run (default: all)")
    ap.add_argument("--img-size", type=int, default=1024)
    ap.add_argument("--query-frame-num", type=int, default=3)
    ap.add_argument("--max-query-pts", type=int, default=4096)
    ap.add_argument("--query-method", default="aliked")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--no-fine-tracking", action="store_true")
    ap.add_argument("--calib-ext", default=".h5", choices=[".h5", ".npz"],
                    help="calibration file format (npz for fixtures)")
    ap.add_argument("--exclude-london-bridge", action="store_true")
    ap.add_argument("--shared-camera", action="store_true")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace (Chrome JSON) of "
                         "each bag under PROFILE_DIR/<bag>")
    ap.add_argument("--submission-dir", default=None,
                    help="write per-bag pose h5 files (IMC submission "
                         "layout) here")
    ap.add_argument("--pack-submission", default=None,
                    help="also write full IMC method directories "
                         "(keypoints/scores/matches h5 + COLMAP model, "
                         "datasets/imc_submission.py) under this base")
    ap.add_argument("--out", default=None, help="write JSON results here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises "
                         "without a GPU unless given cpu)")
    return ap.parse_args(argv)


def runner_config(args):
    """The runner's configuration from the parsed flags."""
    from vggsfm_tpu_torch.runner import RunnerConfig

    return RunnerConfig(img_size=args.img_size,
                        query_frame_num=args.query_frame_num,
                        max_query_pts=args.max_query_pts,
                        query_method=args.query_method,
                        shared_camera=args.shared_camera,
                        fine_tracking=not args.no_fine_tracking,
                        checkpoint=args.checkpoint)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])

    from vggsfm_tpu_torch.datasets.imc import (
        IMCDataset,
        evaluate_bag,
        save_pose_submission,
    )
    from vggsfm_tpu_torch.datasets.imc_submission import (
        pack_scene_submission,
    )
    from vggsfm_tpu_torch.runner import VGGSfMRunner, to_host
    from vggsfm_tpu_torch.utils.device import resolve_device

    # without a GPU this raises before any file is read, unless the CPU
    # was asked for
    device = resolve_device(args.device)
    ds = IMCDataset(args.imc_dir, img_size=args.img_size,
                    exclude_london_bridge=args.exclude_london_bridge,
                    calib_ext=args.calib_ext)
    names = args.bags or ds.sequence_names()
    if not names:
        print("no bags found under", args.imc_dir, file=sys.stderr)
        return 1

    cfg = runner_config(args)
    runner = VGGSfMRunner(cfg, device=device)

    results = {"bags": {}, "config": {
        "img_size": args.img_size, "query_frame_num": args.query_frame_num,
        "max_query_pts": args.max_query_pts,
        "query_method": args.query_method,
        "checkpoint": args.checkpoint}}
    aucs = []
    for name in names:
        data = ds.load_bag(name)
        if args.profile_dir:
            # one trace folder per bag
            runner.cfg = dataclasses.replace(
                cfg, profile_dir=os.path.join(args.profile_dir, name))
        t0 = time.time()
        out = runner.sparse_reconstruct(data["images"],
                                        image_names=data["image_names"])
        # the copy to the host ends in a synchronize, and so the wall
        out = to_host({k: out[k] for k in (
            "extrinsics", "intrinsics", "extra_params", "points3d",
            "valid_tracks", "valid_2d_mask", "pred_track", "pred_score",
            "colors", "timings")})
        wall = time.time() - t0
        scores = evaluate_bag(out["extrinsics"], data["gt_extrinsics"])
        if args.submission_dir:
            save_pose_submission(args.submission_dir, name,
                                 data["image_names"], out["extrinsics"])
        if args.pack_submission:
            pack_scene_submission(
                args.pack_submission, "imc", name, "vggsfm_tpu",
                data["image_names"], out,
                image_size=(args.img_size, args.img_size))
        m = scores["pair_mask"]
        row = {
            "num_frames": int(len(data["images"])),
            "auc30": scores["auc30"],
            "rot_err_med_deg": (float(np.median(scores["rot_err_deg"][m]))
                                if m.any() else None),
            "trans_err_med_deg": (float(np.median(
                scores["trans_err_deg"][m])) if m.any() else None),
            "valid_tracks": int(np.asarray(out["valid_tracks"]).sum()),
            "wall_s": round(wall, 2),
            "stage_s": {k: round(float(v), 3)
                        for k, v in out["timings"].items()},
        }
        results["bags"][name] = row
        aucs.append(scores["auc30"])
        print(f"{name}: AUC@30={row['auc30']:.4f} "
              f"frames={row['num_frames']} tracks={row['valid_tracks']} "
              f"wall={wall:.1f}s", file=sys.stderr)

    results["mean_auc30"] = float(np.mean(aucs))
    text = json.dumps(results, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

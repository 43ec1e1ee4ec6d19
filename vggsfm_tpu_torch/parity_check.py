"""Golden-parity harness: checkpoint audit, scene run, fixture diff.
Counterpart of the JAX package's parity_check.py, with its flags and one
more, --device.

    python -m vggsfm_tpu_torch.parity_check --checkpoint vggsfm_v2_0_0.bin \
        [--scene DIR] [--fixtures DIR [--write-fixtures]] [--min-auc 0.85] \
        [--convert-only] [--out report.json] [--device cpu]

  1. **Checkpoint audit**: the reference state_dict (its
     ``track_predictor.*`` and ``camera_predictor.*`` names) loaded
     strictly into the port's TrackerPredictor and CameraPredictor, on the
     meta device (no weights allocated). The report names every missing
     key (the port's module expects it, the checkpoint lacks it), every
     unexpected key (the checkpoint has it, no module takes it) and every
     shape mismatch. Any of them fails the run: a checkpoint must break
     loudly, not at inference.
  2. **Scene run**: the sparse pipeline on a scene folder (``--scene``,
     DemoLoader layout) or on the built-in synthetic scene
     (`render_two_plane_scene`, 8 frames), with ``matching_init`` off and
     the neural camera init, so the behaviour is the reference's (tracks
     start at the query point and the trained tracker walks them).
  3. **Fixture diff**: with ``--fixtures DIR`` holding golden arrays
     (``extrinsics.npy``, ``points3d.npy``, ``valid_tracks.npy`` of a
     reference run), pose AUC@30 and the relative pose errors against
     them; with ``--write-fixtures`` this run is stored as the fixtures.

Exit status is non-zero on an audit failure or (with fixtures) on AUC@30
below ``--min-auc``. The entry point runs on the GPU unless asked for the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

PARTS = ("track_predictor.", "camera_predictor.")


def audit_checkpoint(state_dict) -> dict:
    """Strict load of the reference names into the port's modules (meta
    device). Returns the report: key counts, missing, unexpected and
    shape-mismatched keys (full reference names), ``ok``."""
    from vggsfm_tpu_torch.models import CameraPredictor, TrackerPredictor

    modules = {"track_predictor.": TrackerPredictor,
               "camera_predictor.": CameraPredictor}
    missing, unexpected, mismatched = [], [], []
    consumed = 0
    for prefix, cls in modules.items():
        with torch.device("meta"):
            module = cls()
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        part = {k[len(prefix):]: v for k, v in state_dict.items()
                if k.startswith(prefix)}
        missing += [prefix + k for k in sorted(set(want) - set(part))]
        unexpected += [prefix + k for k in sorted(set(part) - set(want))]
        for k in sorted(set(part) & set(want)):
            if tuple(part[k].shape) != want[k]:
                mismatched.append(f"{prefix}{k}: {tuple(part[k].shape)}, "
                                  f"expected {want[k]}")
            else:
                consumed += 1
    unexpected += sorted(k for k in state_dict if not k.startswith(PARTS))
    return {
        "total_keys": len(state_dict),
        "consumed_keys": consumed,
        "missing_keys": missing,
        "unexpected_keys": unexpected,
        "shape_mismatches": mismatched,
        "ok": not (missing or unexpected or mismatched),
    }


def _part(state_dict, prefix):
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def run_scene(state_dict, scene_dir, img_size, query_method, max_query_pts,
              query_frame_num, device="cuda"):
    """The sparse pipeline on `scene_dir` (or the synthetic scene) with
    the checkpoint's weights: the host arrays of the reconstruction, and
    ``auc30_vs_planted`` on the synthetic scene."""
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner

    cfg = RunnerConfig(img_size=img_size, query_method=query_method,
                       max_query_pts=max_query_pts,
                       query_frame_num=query_frame_num,
                       # the reference's behaviour: trust the trained
                       # tracker, no weights-free extras
                       matching_init=False, camera_init="neural")
    runner = VGGSfMRunner(
        cfg, device=device,
        state_dict=_part(state_dict, "track_predictor."),
        camera_state_dict=_part(state_dict, "camera_predictor."))
    gt_extr = None
    if scene_dir:
        from vggsfm_tpu_torch.datasets.demo_loader import DemoLoader

        data = DemoLoader(scene_dir, img_size=img_size).load()
        out = runner.sparse_reconstruct(data["images"],
                                        masks=data.get("masks"),
                                        image_names=data["image_names"])
    else:
        from vggsfm_tpu_torch.utils.synth import render_two_plane_scene

        scene = render_two_plane_scene(num_frames=8, image_size=img_size)
        gt_extr = scene["extrinsics"]
        out = runner.sparse_reconstruct(scene["images"])
    res = {k: out[k].detach().cpu().numpy() for k in (
        "extrinsics", "intrinsics", "points3d", "valid_tracks")}
    if gt_extr is not None:
        from vggsfm_tpu_torch.geometry.metrics import pose_auc30

        res["auc30_vs_planted"] = float(pose_auc30(
            torch.as_tensor(res["extrinsics"]),
            torch.as_tensor(gt_extr, dtype=torch.float32)))
    return res


def diff_fixtures(res, fixtures) -> dict:
    """AUC@30, median relative rotation / translation errors and the valid
    track ratio of `res` against the golden arrays in `fixtures`."""
    from vggsfm_tpu_torch.geometry.metrics import (
        pose_auc30,
        relative_pose_errors,
    )

    extr = torch.as_tensor(res["extrinsics"], dtype=torch.float32)
    gold = torch.as_tensor(np.load(os.path.join(fixtures, "extrinsics.npy")),
                           dtype=torch.float32)
    report = {"auc30_vs_fixture": float(pose_auc30(extr, gold))}
    r_err, t_err, mask = relative_pose_errors(extr, gold)
    if bool(mask.any()):
        report["rot_err_med_deg"] = float(r_err[mask].median())
        report["trans_err_med_deg"] = float(t_err[mask].median())
    vfile = os.path.join(fixtures, "valid_tracks.npy")
    if os.path.exists(vfile):
        gold_valid = int(np.load(vfile).sum())
        report["valid_tracks_fixture"] = gold_valid
        report["valid_tracks_ratio"] = (float(res["valid_tracks"].sum())
                                        / max(gold_valid, 1))
    return report


def main(argv=None, state_dict=None):
    """The CLI; `state_dict` stands in for the file of --checkpoint when
    a caller holds the weights in memory. Returns the exit status."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=state_dict is None,
                    help="torch state_dict (.bin/.pt) of the reference model")
    ap.add_argument("--scene", default=None,
                    help="scene dir (DemoLoader layout); default: synthetic "
                         "scene")
    ap.add_argument("--fixtures", default=None,
                    help="dir with golden extrinsics.npy etc. to diff against")
    ap.add_argument("--write-fixtures", action="store_true",
                    help="store this run's outputs as the golden fixtures")
    ap.add_argument("--img-size", type=int, default=1024)
    ap.add_argument("--query-method", default="aliked")
    ap.add_argument("--max-query-pts", type=int, default=2048)
    ap.add_argument("--query-frame-num", type=int, default=3)
    # the gate of the reconstruction's quality floor (bench.py's 0.85)
    ap.add_argument("--min-auc", type=float, default=0.85)
    ap.add_argument("--convert-only", action="store_true",
                    help="stop after the checkpoint audit")
    ap.add_argument("--out", default=None, help="write JSON report here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises "
                         "without a GPU unless given cpu)")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])

    from vggsfm_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if state_dict is None:
        state_dict = torch.load(args.checkpoint, map_location="cpu",
                                weights_only=False)
        if isinstance(state_dict, dict) and "state_dict" in state_dict:
            state_dict = state_dict["state_dict"]

    report = {"conversion": audit_checkpoint(state_dict)}
    if not report["conversion"]["ok"]:
        _emit(report, args.out)
        print("FAIL: checkpoint does not match the port's modules",
              file=sys.stderr)
        return 1
    if args.convert_only:
        _emit(report, args.out)
        return 0

    res = run_scene(state_dict, args.scene, args.img_size,
                    args.query_method, args.max_query_pts,
                    args.query_frame_num, device=device)
    report["scene"] = {"valid_tracks": int(res["valid_tracks"].sum()),
                       "num_frames": int(res["extrinsics"].shape[0])}
    if "auc30_vs_planted" in res:
        report["scene"]["auc30_vs_planted"] = res["auc30_vs_planted"]

    rc = 0
    if args.fixtures and not args.write_fixtures:
        report["fixture_diff"] = diff_fixtures(res, args.fixtures)
        if report["fixture_diff"]["auc30_vs_fixture"] < args.min_auc:
            rc = 1
    elif args.fixtures and args.write_fixtures:
        os.makedirs(args.fixtures, exist_ok=True)
        for k in ("extrinsics", "intrinsics", "points3d", "valid_tracks"):
            np.save(os.path.join(args.fixtures, f"{k}.npy"), res[k])
        report["fixtures_written"] = args.fixtures
    _emit(report, args.out)
    return rc


def _emit(report, out):
    text = json.dumps(report, indent=2)
    print(text)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    sys.exit(main())

"""CLI: reconstruct a scene folder into a COLMAP sparse model on the GPU.
Counterpart of the JAX package's demo.py (reference demo.py, a hydra
entry over cfgs/demo.yaml:6-67), with the flags of what the port runs and
one more, --device.

Usage:
    python -m vggsfm_tpu_torch.demo SCENE_DIR [--output OUT] [--img-size N]
    python -m vggsfm_tpu_torch.demo SCENE_DIR=/path/to/scene --glb
    python -m vggsfm_tpu_torch.demo SCENE_DIR --device cpu

Writes OUT/sparse/{cameras,images,points3D}.bin (OUT defaults to
SCENE_DIR), OUT/scene.glb with --glb, OUT/additional_points.npz with
--extra-pt-pixel-interval, OUT/depths/*.bin with --dense-depth,
OUT/visuals/ with --visual-tracks, --reproj-frames and
--visual-query-points, a torch.profiler trace (Chrome JSON) with
--profile-dir, and prints one JSON summary line. The scene's images are
read with Pillow.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scene_dir", help="scene folder (images/ inside or bare)")
    p.add_argument("--output", default=None,
                   help="output dir (default: SCENE_DIR)")
    p.add_argument("--img-size", type=int, default=1024)
    p.add_argument("--query-frame-num", type=int, default=3)
    p.add_argument("--max-query-pts", type=int, default=4096)
    p.add_argument("--query-method", default="aliked")
    p.add_argument("--no-fine-tracking", action="store_true")
    p.add_argument("--dense-depth", action="store_true",
                   help="write aligned monocular depth maps to "
                        "OUT/depths/*.bin (COLMAP array format)")
    p.add_argument("--depth-checkpoint", default=None,
                   help="DepthAnythingV2 torch checkpoint (optional)")
    p.add_argument("--load-gt", action="store_true",
                   help="load COLMAP GT from SCENE/sparse[/0] and report "
                        "pose AUC@30 against it")
    p.add_argument("--visual-tracks", action="store_true",
                   help="write track overlays (PNGs + GIF) to OUT/visuals")
    p.add_argument("--reproj-frames", action="store_true",
                   help="write reprojection overlays to OUT/visuals")
    p.add_argument("--glb", action="store_true",
                   help="write OUT/scene.glb (point cloud + camera "
                        "frusta, viewable in any glTF viewer)")
    p.add_argument("--extra-pt-pixel-interval", type=int, default=-1,
                   help="densify: one extra grid point per N pixels, "
                        "tracked + triangulated without BA; writes "
                        "OUT/additional_points.npz (<=0 disables)")
    p.add_argument("--extra-by-neighbor", type=int, default=-1,
                   help="track each frame's extra grid only into this "
                        "many neighbor frames (<=0: all frames)")
    p.add_argument("--concat-extra-points", action="store_true",
                   help="also append the extra points (trackless) to the "
                        "exported COLMAP model")
    p.add_argument("--query-by-midpoint", action="store_true",
                   help="midpoint query ranking instead of DINO FPS "
                        "(reference query_by_midpoint)")
    p.add_argument("--query-by-interval", action="store_true",
                   help="stride query ranking (reference "
                        "query_by_interval; midpoint wins if both set)")
    p.add_argument("--center-order", action="store_true",
                   help="anchor the solve on the top-ranked query frame "
                        "(reference center_order)")
    p.add_argument("--visual-query-points", action="store_true",
                   help="save query-point overlays to OUT/visuals "
                        "(reference visual_query_points)")
    p.add_argument("--camera-type", default="SIMPLE_PINHOLE",
                   choices=["SIMPLE_PINHOLE", "SIMPLE_RADIAL"])
    p.add_argument("--shared-camera", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="reference torch checkpoint (optional)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run here "
                        "(Chrome trace JSON: chrome://tracing, Perfetto), "
                        "each stage and span a range vggsfm.<name>")
    p.add_argument("--config", default=None,
                   help="YAML config (cfgs/demo.yaml schema); CLI flags "
                        "override file values")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; raises "
                        "without a GPU unless given cpu)")
    # accept hydra-style SCENE_DIR=... for muscle-memory compatibility
    argv = [a.split("=", 1)[1] if a.startswith("SCENE_DIR=") else a
            for a in argv]
    args = p.parse_args(argv)
    # which dest values differ from the parser defaults — with --config,
    # only these override the file (a default-valued flag the user never
    # typed must not clobber a YAML setting)
    args._non_default = {
        a.dest for a in p._actions
        if a.dest != "help" and getattr(args, a.dest, None) != a.default
    }
    return args


def build_config(args):
    """RunnerConfig from CLI args (+ optional YAML --config).

    Precedence: explicitly-typed CLI flags > YAML file > dataclass
    defaults. A flag left at its argparse default never clobbers a YAML
    value; YAML keys the port's RunnerConfig lacks are ignored.
    """
    from vggsfm_tpu_torch.runner import RunnerConfig

    overrides = dict(
        img_size=args.img_size,
        query_frame_num=args.query_frame_num,
        max_query_pts=args.max_query_pts,
        query_method=args.query_method,
        fine_tracking=not args.no_fine_tracking,
        camera_type=args.camera_type,
        shared_camera=args.shared_camera,
        checkpoint=args.checkpoint,
        dense_depth=args.dense_depth,
        depth_checkpoint=args.depth_checkpoint,
        make_glb=args.glb,
        visual_tracks=args.visual_tracks,
        make_reproj_frames=args.reproj_frames,
        query_by_midpoint=args.query_by_midpoint,
        query_by_interval=args.query_by_interval,
        center_order=args.center_order,
        visual_query_points=args.visual_query_points,
        seed=args.seed,
        profile_dir=args.profile_dir,
        extra_pt_pixel_interval=args.extra_pt_pixel_interval,
        extra_by_neighbor=args.extra_by_neighbor,
        concat_extra_points=args.concat_extra_points,
    )
    # maps RunnerConfig field -> argparse dest (they differ for a few)
    dest_of = {"fine_tracking": "no_fine_tracking", "make_glb": "glb",
               "make_reproj_frames": "reproj_frames"}
    if args.config:
        import yaml

        with open(args.config) as f:
            file_cfg = yaml.safe_load(f) or {}
        fields = {f.name for f in dataclasses.fields(RunnerConfig)}
        base = {k: v for k, v in file_cfg.items() if k in fields}
        # only explicitly-typed CLI flags override the file
        base.update({k: v for k, v in overrides.items()
                     if dest_of.get(k, k) in args._non_default})
        return RunnerConfig(**base)
    return RunnerConfig(**overrides)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])

    from vggsfm_tpu_torch.runner import VGGSfMRunner

    cfg = build_config(args)
    runner = VGGSfMRunner(cfg, device=args.device)
    out_dir = args.output or args.scene_dir
    predictions = runner.run_scene(args.scene_dir, output_dir=out_dir,
                                   load_gt=args.load_gt)
    summary = {
        "frames": int(predictions["extrinsics"].shape[0]),
        "valid_tracks": int(predictions["valid_tracks"].sum()),
        "valid_frames": int(predictions["valid_frame_mask"].sum()),
        "total_time_s": round(predictions["total_time"], 2),
        "timings": {k: round(v, 2)
                    for k, v in predictions["timings"].items()},
        "output": out_dir,
    }
    if "gt_auc30" in predictions:
        summary["gt_auc30"] = round(predictions["gt_auc30"], 4)
    print(json.dumps(summary))
    return predictions


if __name__ == "__main__":
    main()

"""CLI video demo: windowed incremental reconstruction of a frame folder on
the GPU. Counterpart of the JAX package's video_demo.py (reference
video_demo.py, a hydra entry over VideoRunner, cfgs/video_demo.yaml:6-14
window knobs), with its flags and one more, --device.

Usage:
    python -m vggsfm_tpu_torch.video_demo FRAMES --output OUT \
        [--init-window 16] [--window 8] [--joint-ba-interval 4]
    python -m vggsfm_tpu_torch.video_demo FRAMES --device cpu

Writes OUT/sparse/{cameras,images,points3D}.bin (OUT defaults to FRAMES)
and prints one JSON summary line. With --num-hosts N > 1 each process
runs with its own --host-id and a shared --exchange-dir; host 0 merges
the partial maps through files (no process group), runs the joint BA and
exports.

With --distributed-ba N > 1, N processes run the same command, each with
its own rank (VGGSFM_COORDINATOR=host:port VGGSFM_NUM_PROCESSES=N
VGGSFM_PROCESS_ID=r, or under torchrun) and its own --output: every rank
runs the pipeline, the joint BA's observations are sharded over the
ranks, and every rank writes the same model.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scene_dir")
    p.add_argument("--output", default=None)
    p.add_argument("--img-size", type=int, default=512)
    # defaults = the reference video operating point
    # (reference cfgs/video_demo.yaml:6-13): 32/16/6 windows, shared
    # SIMPLE_RADIAL camera, midpoint query ranking
    p.add_argument("--init-window", type=int, default=32)
    p.add_argument("--window", type=int, default=16)
    p.add_argument("--joint-ba-interval", type=int, default=6)
    p.add_argument("--max-query-pts", type=int, default=1024)
    p.add_argument("--query-method", default="auto")
    p.add_argument("--camera-type", default="SIMPLE_RADIAL",
                   choices=["SIMPLE_PINHOLE", "SIMPLE_RADIAL"],
                   help="SIMPLE_RADIAL carries a shared radial "
                        "coefficient through the incremental map "
                        "(the reference's video default)")
    p.add_argument("--no-query-by-midpoint", action="store_true",
                   help="rank the initial window's query frames by DINO "
                        "similarity instead of midpoint spread (the "
                        "reference video default is midpoint)")
    p.add_argument("--config", default=None,
                   help="YAML config (cfgs/video_demo.yaml schema); CLI "
                        "flags override file values")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--state-checkpoint", default=None,
                   help="path prefix for pipeline-state checkpoints "
                        "(saved after every joint BA)")
    p.add_argument("--resume", default=None,
                   help="resume from a prior --state-checkpoint prefix")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="partition the sequence's windows over this many "
                        "processes; each runs with its own --host-id and "
                        "a shared --exchange-dir, host 0 merges + joint-"
                        "BAs + exports")
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--exchange-dir", default=None,
                   help="shared directory for multi-host partial maps "
                        "(required when --num-hosts > 1)")
    p.add_argument("--distributed-ba", type=int, default=0,
                   help="shard the joint BA over this many ranks of the "
                        "process group (one process per rank, started "
                        "with VGGSFM_COORDINATOR / VGGSFM_NUM_PROCESSES / "
                        "VGGSFM_PROCESS_ID or torchrun's variables); with "
                        "fewer ranks the plain solver runs")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend (default: nccl on "
                        "the GPU, gloo on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; raises "
                        "without a GPU unless given cpu)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    # which dest values differ from the parser defaults — with --config,
    # only these override the file (same precedence rule as demo.py)
    non_default = {
        a.dest for a in p._actions
        if a.dest != "help" and getattr(args, a.dest, None) != a.default
    }

    from vggsfm_tpu_torch.datasets.demo_loader import DemoLoader
    from vggsfm_tpu_torch.runner import RunnerConfig, VGGSfMRunner
    from vggsfm_tpu_torch.video import VideoConfig, VideoRunner

    # argparse dest -> VideoConfig field (where the names differ)
    vmap = {"init_window": "init_window_size", "window": "window_size",
            "joint_ba_interval": "joint_ba_interval",
            "max_query_pts": "max_query_pts",
            "query_method": "query_method", "camera_type": "camera_type",
            "distributed_ba": "distributed_ba_devices"}
    voverrides = {f: getattr(args, d) for d, f in vmap.items()}
    query_by_midpoint = not args.no_query_by_midpoint
    if args.config:
        import yaml

        with open(args.config) as f:
            file_cfg = yaml.safe_load(f) or {}
        vfields = {f.name for f in dataclasses.fields(VideoConfig)}
        base = {k: v for k, v in file_cfg.items() if k in vfields}
        base.update({f: v for d, f in vmap.items()
                     if d in non_default
                     for v in [getattr(args, d)]})
        voverrides = base
        if "query_by_midpoint" in file_cfg \
                and "no_query_by_midpoint" not in non_default:
            query_by_midpoint = bool(file_cfg["query_by_midpoint"])

    vcfg = VideoConfig(**voverrides)
    if args.num_hosts > 1 and vcfg.distributed_ba_devices > 1:
        p.error("--num-hosts > 1 runs the joint BA on host 0 alone; it "
                "takes no --distributed-ba")
    if args.num_hosts > 1 or vcfg.distributed_ba_devices > 1:
        # the process group (no-op for a single process), where the JAX
        # CLI initializes jax.distributed, and before a sharded joint BA
        from vggsfm_tpu_torch.parallel.multihost import init_multihost

        if init_multihost(backend=args.dist_backend, device=args.device):
            import torch.distributed as dist

            from vggsfm_tpu_torch.parallel.mesh import rank_device

            # one card per rank (ranks beyond the cards share them)
            args.device = str(rank_device(dist.get_rank(), args.device))
    scfg = RunnerConfig(img_size=args.img_size, query_frame_num=1,
                        max_query_pts=vcfg.max_query_pts,
                        query_method=vcfg.query_method,
                        camera_type=vcfg.camera_type,
                        query_by_midpoint=query_by_midpoint,
                        checkpoint=args.checkpoint)
    runner = VideoRunner(VGGSfMRunner(scfg, device=args.device), vcfg)

    data = DemoLoader(args.scene_dir, img_size=args.img_size).load()
    out_dir = args.output or args.scene_dir
    if args.num_hosts > 1:
        if args.exchange_dir is None:
            p.error("--num-hosts > 1 requires --exchange-dir")
        preds = runner.run_multihost(
            data["images"], args.num_hosts, args.host_id,
            args.exchange_dir, output_dir=out_dir,
            image_names=data["image_names"],
            crop_params=data["crop_params"])
        if preds is None:  # non-zero hosts publish their partial and exit
            print(json.dumps({"host_id": args.host_id, "done": True}))
            return None
    else:
        preds = runner.run(data["images"], output_dir=out_dir,
                           resume_from=args.resume,
                           checkpoint_path=args.state_checkpoint,
                           image_names=data["image_names"],
                           crop_params=data["crop_params"])
    print(json.dumps({
        "frames": int(preds["extrinsics"].shape[0]),
        "registered": int(preds["registered"].sum()),
        "points": int(preds["num_points"]),
        "observations": int(preds["num_observations"]),
        "output": out_dir,
    }))
    return preds


if __name__ == "__main__":
    main()

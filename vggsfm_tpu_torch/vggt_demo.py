"""CLI of VGGT-1B's feed-forward reconstruction: a folder of frames to a
COLMAP model on the GPU, as the public repository's `demo_colmap.py` runs
it without `--use_ba` (vggt/runner.py).

Usage:
    python -m vggsfm_tpu_torch.vggt_demo SCENE_DIR --output OUT \
        [--checkpoint model.pt] [--conf-thres 5.0] [--seed 42]
    python -m vggsfm_tpu_torch.vggt_demo SCENE_DIR --device cpu

Loads SCENE_DIR/images (or the folder's own images) square at the
model's size (518 px) with the demo loader, writes
OUT/sparse/{cameras,images,points3D}.bin (OUT defaults to SCENE_DIR) in
the original images' pixels and prints one JSON summary line. Without
--checkpoint the weights are seeded from --seed, which also draws the
kept points.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("scene_dir")
    p.add_argument("--output", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--conf-thres", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; raises "
                        "without a GPU unless given cpu)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    from vggsfm_tpu_torch.datasets.demo_loader import DemoLoader
    from vggsfm_tpu_torch.vggt import VGGTConfig, VGGTRunner

    cfg = VGGTConfig(conf_thres=args.conf_thres, seed=args.seed,
                     checkpoint=args.checkpoint)
    runner = VGGTRunner(cfg, device=args.device)
    data = DemoLoader(args.scene_dir, img_size=cfg.img_size).load()
    out_dir = args.output or args.scene_dir
    preds = runner.reconstruct(data["images"], output_dir=out_dir,
                               image_names=data["image_names"],
                               crop_params=data["crop_params"])
    print(json.dumps({
        "frames": int(preds["extrinsics"].shape[0]),
        "points": int(preds["points3d"].shape[0]),
        "timings": {k: round(v, 4) for k, v in preds["timings"].items()},
        "output": out_dir,
    }))
    return preds


if __name__ == "__main__":
    main()

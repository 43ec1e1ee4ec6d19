"""The oracle video scene that the port's video tests share with the JAX
package, and the JAX side of the whole-slice comparison, run in a fresh
subprocess:

    python tests/torch_video_cases.py jax_oracle OUT.npz
    python tests/torch_video_cases.py port_multihost_worker DIR HOST HOSTS

The scene is tests/video_cases.py's oracle (a projection-oracle tracker
and an oracle initial map, T = 12 frames at 128 px), with one change: the
oracle's pixel noise is a fixed table per (frame, point), so that both
packages see the same observations whatever order they ask in. The JAX
run records the random draws it makes (the fresh query points of each
window attempt, the PnP minimal sets), which the port is handed in place
of its own generators' draws.
"""

from __future__ import annotations

import sys
import types

import numpy as np

T, R_IMG, N = 12, 128, 300


def make_scene(T=T, R_img=R_IMG, N=N, seed=0, step=1.0):
    """Cameras on a slow yaw + translation path looking at N points;
    `step` scales the per-frame motion."""
    rng = np.random.default_rng(seed)
    f = float(R_img)
    K = np.array([[f, 0, R_img / 2], [0, f, R_img / 2], [0, 0, 1.0]])
    X = rng.uniform([-2, -2, 6], [2, 2, 10], size=(N, 3))
    extr_gt = np.zeros((T, 3, 4))
    for t in range(T):
        a = 0.04 * t * step
        Rm = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]])
        tr = np.array([0.15 * t, 0.01 * t, 0.02 * t]) * step
        extr_gt[t] = np.concatenate([Rm, tr[:, None]], axis=1)
    video = rng.uniform(size=(T, R_img, R_img, 3)).astype(np.float32)
    noise = rng.normal(scale=0.2, size=(T, N, 2))
    return {"K": K, "X": X, "extr_gt": extr_gt, "video": video,
            "noise": noise}


def project(sc, t, pts):
    Xc = (sc["extr_gt"][t, :, :3] @ pts.T).T + sc["extr_gt"][t, :, 3]
    uv = (sc["K"] @ Xc.T).T
    return uv[:, :2] / uv[:, 2:]


def install_oracle(runner, sc):
    """Replace the runner's initial sparse solve and window tracker by the
    oracle (works on either package's VideoRunner)."""
    X = sc["X"]

    def oracle_init(images_init, **kw):
        S0 = images_init.shape[0]
        track = np.stack([project(sc, t, X) for t in range(S0)])
        track = track + sc["noise"][:S0]
        return {
            "extrinsics": sc["extr_gt"][:S0].astype(np.float32),
            "intrinsics": np.tile(sc["K"], (S0, 1, 1)).astype(np.float32),
            "points3d": X.astype(np.float32),
            "valid_tracks": np.ones(len(X), bool),
            "valid_2d_mask": np.ones((S0, len(X)), bool),
            "pred_track": track[None].astype(np.float32),
        }

    def oracle_track(self, images_w, query_xy, frames_w=None):
        query_xy = np.asarray(query_xy)
        Sw, Nq = len(frames_w), len(query_xy)
        tr = np.zeros((Sw, Nq, 2), np.float32)
        vis = np.zeros((Sw, Nq), np.float32)
        proj_q = project(sc, frames_w[0], X)
        d = np.linalg.norm(query_xy[:, None] - proj_q[None], axis=-1)
        nearest = d.argmin(1)
        matched = d.min(1) < 2.0
        for i, t in enumerate(frames_w):
            tr[i] = project(sc, t, X)[nearest] + sc["noise"][t][nearest]
            vis[i] = matched.astype(np.float32)
        return tr, vis

    runner.r.sparse_reconstruct = oracle_init
    runner._track_window = types.MethodType(oracle_track, runner)


def configs(pkg):
    """The oracle case's RunnerConfig and VideoConfig of `pkg`'s runner
    and video modules."""
    runner_mod, video_mod = pkg
    scfg = runner_mod.RunnerConfig(
        img_size=R_IMG, query_frame_num=1, max_query_pts=64,
        query_method="harris", fine_tracking=False, comple_nonvis=False,
        robust_refine=0, ba_iters=1)
    vcfg = video_mod.VideoConfig(
        init_window_size=4, window_size=3, joint_ba_interval=2,
        max_query_pts=256, query_method="harris", min_inlier_per_frame=10,
        align_with_camera_predictor=False)
    return scfg, vcfg


def jax_oracle(out_path: str) -> None:
    """The JAX package's VideoRunner.run on the oracle scene; saves its
    predictions and the draws it made."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vggsfm_tpu import runner as jrunner
    from vggsfm_tpu import video as jvideo
    from vggsfm_tpu.twoview.utils import generate_samples
    from vggsfm_tpu.video import runner as jvr

    sc = make_scene()
    scfg, vcfg = configs((jrunner, jvideo))
    runner = jvideo.VideoRunner(jrunner.VGGSfMRunner(scfg), vcfg)
    install_oracle(runner, sc)

    draws = {}
    gqp, pnp = jvr.get_query_points, jvr.absolute_pose_ransac

    def seed_of(key):
        return int(np.asarray(key)[-1])  # PRNGKey(n) is [0, n]

    def rec_gqp(image, key, method, budget, **kw):
        xy, valid = gqp(image, key, method, budget, **kw)
        draws[f"q_{seed_of(key)}"] = np.asarray(xy)
        draws[f"qv_{seed_of(key)}"] = np.asarray(valid)
        return xy, valid

    def rec_pnp(points3D, points2D, intrinsics, key, **kw):
        idx, _ = generate_samples(key, points3D.shape[1],
                                  kw["max_ransac_iters"], 6)
        draws[f"p_{seed_of(key)}_{points3D.shape[1]}"] = np.asarray(idx)
        return pnp(points3D, points2D, intrinsics, key, **kw)

    jvr.get_query_points, jvr.absolute_pose_ransac = rec_gqp, rec_pnp
    preds = runner.run(sc["video"])
    np.savez(out_path, extrinsics=preds["extrinsics"],
             intrinsics=preds["intrinsics"], points3d=preds["points3d"],
             registered=preds["registered"],
             num_observations=preds["num_observations"], **draws)
    print("JAX_ORACLE_OK")


def port_multihost_worker(exchange_dir: str, host_id: int,
                          num_hosts: int) -> None:
    """One host of the port's two-process run_multihost on the CPU with
    the oracle (every host builds the same scene and initial map)."""
    import torch

    from vggsfm_tpu_torch import runner as trunner
    from vggsfm_tpu_torch import video as tvideo

    torch.set_num_threads(1)
    sc = make_scene(T=16, seed=21, step=0.6)
    scfg, vcfg = configs((trunner, tvideo))
    runner = tvideo.VideoRunner(trunner.VGGSfMRunner(scfg, device="cpu"),
                                vcfg)
    install_oracle(runner, sc)
    preds = runner.run_multihost(sc["video"], num_hosts, host_id,
                                 exchange_dir, output_dir=exchange_dir)
    if preds is not None:
        np.savez(f"{exchange_dir}/merged.npz", **{
            k: preds[k] for k in ("extrinsics", "points3d", "registered")})
    print(f"HOST{host_id}_OK")


if __name__ == "__main__":
    if sys.argv[1] == "jax_oracle":
        jax_oracle(sys.argv[2])
    else:
        port_multihost_worker(sys.argv[2], int(sys.argv[3]),
                              int(sys.argv[4]))

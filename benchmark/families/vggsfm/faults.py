"""Faults planted in a VGGSfM pipeline underneath a run, for the readings
the check's limits are set from (`control.py --fault`) and for the tests
that see each one make `correct` false. A fault is installed after the
warm-up (`benchmark/faults.py` `plant`), beneath the benchmark's own
hooks, so what the check reads is what the broken program passed on.

Each entry of FAULTS is (install, {pipeline: the number that reads it
there}); `install(pipe, patch)` takes `patch(obj, attr, value)`, a
setattr that can be undone.
"""

from __future__ import annotations


def _alter_output(module, patch, alter):
    """`module`'s forward with `alter` applied to what it returns
    (beneath the module's hooks, where the benchmark reads it)."""
    forward = module.forward
    patch(module, "forward", lambda *a, **k: alter(forward(*a, **k)))


def _shifted(at, delta):
    def alter(output):
        out = list(output)
        out[at] = [t + delta for t in out[at]]
        return tuple(out)
    return alter


def tracks_moved(pipe, patch):
    """The coarse tracker's tracks 20 px off."""
    _alter_output(pipe.runner.tracker.coarse_predictor, patch,
                  _shifted(0, 20.0))


def fine_moved(pipe, patch):
    """The fine tracker's patch tracks 1 px off."""
    _alter_output(pipe.runner.tracker.fine_predictor, patch,
                  _shifted(0, 1.0))


def features_scaled(pipe, patch):
    """The camera predictor's image features 10% off."""
    _alter_output(pipe.runner.camera, patch, lambda out: {
        **out, "rgb_feat_init": out["rgb_feat_init"] * 1.1})


def trunk_scaled(pipe, patch):
    """The camera trunk's last attention block 10% off."""
    _alter_output(pipe.runner.camera.trunk[-1], patch, lambda out: out * 1.1)


def scores_scaled(pipe, patch):
    """The ALIKED score map 10% off."""
    from vggsfm_tpu_torch.extractors.cnn import load_aliked

    _alter_output(load_aliked(pipe.runner.device), patch,
                  lambda out: out * 0.9)


def query_points_moved(pipe, patch):
    """The batched query points 1 px off."""
    import vggsfm_tpu_torch.runner as runner

    extract = runner.get_query_points_batched

    def moved(*args, **kwargs):
        xy, valid = extract(*args, **kwargs)
        return xy + 1.0, valid
    patch(runner, "get_query_points_batched", moved)


def corners_moved(pipe, patch):
    """The weights-free extractors' candidates 1 px off."""
    import vggsfm_tpu_torch.extractors.dispatch as dispatch

    candidates = dispatch.candidate_points

    def moved(*args, **kwargs):
        xy, valid = candidates(*args, **kwargs)
        return xy + 1.0, valid
    patch(dispatch, "candidate_points", moved)


def points_moved(pipe, patch):
    """The sparse solve's points moved by 5% of their spread."""
    solve = pipe.runner.solve

    def moved(*args, **kwargs):
        out = solve(*args, **kwargs)
        p = out["points3d"]
        out["points3d"] = p + 0.05 * p.std(dim=0)
        return out
    patch(pipe.runner, "solve", moved)


def ba_unchanged(pipe, patch):
    """Every bundle adjustment returns the state it was given."""
    import vggsfm_tpu_torch.sfm.refine as refine
    import vggsfm_tpu_torch.sfm.triangulator as triangulator
    import vggsfm_tpu_torch.video.runner as video

    def unchanged(solver):
        def call(extrinsics, intrinsics, points3d, *args, **kwargs):
            info = solver(extrinsics, intrinsics, points3d, *args,
                          **kwargs)[-1]
            return (extrinsics, intrinsics, kwargs.get("extra_params"),
                    points3d, info)
        return call

    for mod in (triangulator, refine, video):
        patch(mod, "bundle_adjust", unchanged(mod.bundle_adjust))
    patch(video, "bundle_adjust_sparse",
          unchanged(video.bundle_adjust_sparse))


FAULTS = {
    "tracks_moved": (tracks_moved, {"sparse": "coarse_px",
                                    "video": "coarse_px"}),
    "fine_moved": (fine_moved, {"sparse": "fine_px", "video": "fine_px"}),
    "features_scaled": (features_scaled, {"sparse": "camera_rel",
                                          "video": "camera_rel"}),
    "trunk_scaled": (trunk_scaled, {"sparse": "trunk_rel",
                                    "video": "trunk_rel"}),
    "scores_scaled": (scores_scaled, {"sparse": "aliked_rel"}),
    "query_points_moved": (query_points_moved, {"sparse": "query_miss"}),
    "corners_moved": (corners_moved, {"video": "corner_miss"}),
    "points_moved": (points_moved, {"sparse": "reproj_over"}),
    "ba_unchanged": (ba_unchanged, {"sparse": "pose_err_deg",
                                    "video": "valid_tracks"}),
}

"""IMC benchmark packaging: features, matches and the model, written and
read back (host-side, numpy). Counterpart of
vggsfm_tpu/datasets/imc_submission.py (reference
datasets/imc_helper.py:767-1148: the IMC2020 toolkit's path and IO
helpers). A method directory of the benchmark:

    <base>/<dataset>/<scene>/<method_label>/
        keypoints.h5      one (N, 2) dataset per image stem
        descriptors.h5    one (N, D) dataset per image stem
        scores.h5         one (N,)   dataset per image stem
        matches.h5        one (2, M) dataset per "stemA-stemB" pair
        model/            COLMAP cameras/images/points3D

Tracks give each image's keypoints, their co-visibility the pairwise
matches, and the reconstruction is written through the port's
`io.bridge` and `io.colmap`. Without h5py each file is the .npz beside
the .h5 name (`datasets.imc.save_h5`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vggsfm_tpu_torch.datasets.imc import load_h5, save_h5


def _np(x):
    """A tensor (on any device) or array-like as numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def submission_paths(base: str, dataset: str, scene: str,
                     method_label: str) -> dict:
    """The method directory's layout (imc_helper.py:838-1106)."""
    root = os.path.join(base, dataset, scene, method_label)
    return {
        "root": root,
        "keypoints": os.path.join(root, "keypoints.h5"),
        "descriptors": os.path.join(root, "descriptors.h5"),
        "scores": os.path.join(root, "scores.h5"),
        "matches": os.path.join(root, "matches.h5"),
        "model": os.path.join(root, "model"),
    }


def _stem(name: str) -> str:
    return os.path.splitext(os.path.basename(name))[0]


def pair_key(name_a: str, name_b: str) -> str:
    """The canonical 'stemA-stemB' pair key (sorted, as imc_helper)."""
    a, b = sorted([_stem(name_a), _stem(name_b)])
    return f"{a}-{b}"


def features_from_tracks(image_names: list, tracks, vis_mask,
                         scores=None) -> tuple[dict, dict]:
    """Per-image keypoints and scores from the (S, N, 2) tracks: a track
    visible in an image gives its 2D location there, and a keypoint's
    index within an image is the track's index, which keeps
    `matches_from_tracks` consistent with these files. Invisible tracks
    keep a row (NaN, score 0) so the indices stay aligned."""
    tracks = _np(tracks)
    vis = _np(vis_mask).astype(bool)
    kps, scs = {}, {}
    for i, name in enumerate(image_names):
        xy = np.where(vis[i][:, None], tracks[i], np.nan)
        kps[_stem(name)] = xy.astype(np.float32)
        s = (_np(scores)[i] if scores is not None
             else vis[i].astype(np.float32))
        scs[_stem(name)] = np.where(vis[i], s, 0.0).astype(np.float32)
    return kps, scs


def matches_from_tracks(image_names: list, vis_mask,
                        max_pairs: int | None = None) -> dict:
    """(2, M) index matches of each co-visible image pair from the tracks'
    co-visibility (keypoint index == track index, see above)."""
    vis = _np(vis_mask).astype(bool)
    S = vis.shape[0]
    out = {}
    for i in range(S):
        for j in range(i + 1, S):
            both = np.nonzero(vis[i] & vis[j])[0]
            if len(both) == 0:
                continue
            out[pair_key(image_names[i], image_names[j])] = np.stack(
                [both, both]).astype(np.int64)
            if max_pairs is not None and len(out) >= max_pairs:
                return out
    return out


def pack_scene_submission(base: str, dataset: str, scene: str,
                          method_label: str, image_names: list,
                          predictions: dict, image_size,
                          descriptors: dict | None = None) -> dict:
    """Write one scene's IMC method directory from the runner's output.

    `predictions` is `sparse_reconstruct`'s dict (``pred_track``,
    ``valid_2d_mask``, ``valid_tracks``, ``pred_score``, ``extrinsics``,
    ``intrinsics``, ``points3d``, ``extra_params``, ``colors``; tensors
    on any device or numpy); `image_size` is (width, height) of the
    runner's pixels. The model is the arrays the normal export writes,
    through `io.bridge` and `io.colmap`. Returns the paths."""
    from vggsfm_tpu_torch.io import arrays_to_reconstruction, write_model

    paths = submission_paths(base, dataset, scene, method_label)
    os.makedirs(paths["root"], exist_ok=True)

    track = _np(predictions["pred_track"])[0]
    vis2d = _np(predictions["valid_2d_mask"]).astype(bool)
    valid = predictions.get("valid_tracks")
    if valid is not None:
        vis2d = vis2d & _np(valid).astype(bool)[None]
    score = predictions.get("pred_score")
    score = _np(score)[0] if score is not None else None

    kps, scs = features_from_tracks(image_names, track, vis2d, score)
    save_h5(kps, paths["keypoints"])
    save_h5(scs, paths["scores"])
    if descriptors is not None:
        save_h5({_stem(k): _np(v) for k, v in descriptors.items()},
                paths["descriptors"])
    save_h5(matches_from_tracks(image_names, vis2d), paths["matches"])

    os.makedirs(paths["model"], exist_ok=True)
    extra = predictions.get("extra_params")
    colors = predictions.get("colors")
    rec = arrays_to_reconstruction(
        _np(predictions["points3d"]), _np(predictions["extrinsics"]),
        _np(predictions["intrinsics"]), track, vis2d, image_size,
        image_names=[os.path.basename(n) for n in image_names],
        extra_params=None if extra is None else _np(extra),
        colors=(None if colors is None else
                np.clip(_np(colors) * 255, 0, 255).astype(np.uint8)))
    write_model(rec, paths["model"])
    return paths


def load_scene_submission(base: str, dataset: str, scene: str,
                          method_label: str) -> dict:
    """Read back a packed scene: each file's arrays (a missing file gives
    {}), and the model when there is one."""
    paths = submission_paths(base, dataset, scene, method_label)

    def _maybe(path):
        for cand in (path, path + ".npz"):
            if os.path.exists(cand):
                return load_h5(cand)
        return {}

    out = {
        "keypoints": _maybe(paths["keypoints"]),
        "scores": _maybe(paths["scores"]),
        "descriptors": _maybe(paths["descriptors"]),
        "matches": _maybe(paths["matches"]),
    }
    if os.path.isdir(paths["model"]):
        from vggsfm_tpu_torch.io import read_model

        out["model"] = read_model(paths["model"])
    return out

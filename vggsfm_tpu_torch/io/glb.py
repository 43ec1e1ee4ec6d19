"""Minimal GLB (binary glTF 2.0) scene export: point cloud + camera frusta
(host-side, numpy). Counterpart of vggsfm_tpu/io/glb.py; the files are
byte-identical to that package's.

The reference shows a reconstruction as a GLB scene of the point cloud and
camera cones through trimesh (vggsfm/utils/gradio.py:50-233,
`vggsfm_predictions_to_glb`). This writer produces the same artifact, a
POINTS primitive with vertex colors for the cloud and a LINES primitive
for the camera frusta, with no external dependency: GLB is a small binary
container (12-byte header + JSON chunk + BIN chunk) written directly.
Viewable in any glTF viewer (three.js, Blender, <model-viewer>).
"""

from __future__ import annotations

import json
import struct

import numpy as np

_COMPONENT_F32 = 5126
_COMPONENT_U32 = 5125
_TARGET_ARRAY = 34962
_TARGET_ELEMENT = 34963
_MODE_POINTS = 0
_MODE_LINES = 1


def _pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
    return b + fill * ((4 - len(b) % 4) % 4)


def _frustum_segments(extrinsics, intrinsics, image_size, scale):
    """Line segments (P, 2, 3) of every camera's frustum pyramid.

    extrinsics: (S, 3, 4) world->cam OpenCV; the apex is the camera
    center, the base is the image rectangle back-projected to depth
    `scale`.
    """
    W, H = image_size
    segs = []
    for s in range(extrinsics.shape[0]):
        R = extrinsics[s, :, :3]
        t = extrinsics[s, :, 3]
        C = -R.T @ t
        K = intrinsics[s]
        fx, fy = K[0, 0], K[1, 1]
        cx, cy = K[0, 2], K[1, 2]
        corners_px = np.array(
            [[0, 0], [W, 0], [W, H], [0, H]], np.float64)
        rays = np.stack([(corners_px[:, 0] - cx) / fx,
                         (corners_px[:, 1] - cy) / fy,
                         np.ones(4)], axis=-1)
        base = (rays * scale) @ R + C  # cam->world: Rᵀ x + C
        for i in range(4):
            segs.append([C, base[i]])
            segs.append([base[i], base[(i + 1) % 4]])
    return np.asarray(segs, np.float32)


def write_glb_scene(path, points3d, colors=None, extrinsics=None,
                    intrinsics=None, image_size=None,
                    frustum_scale: float | None = None):
    """Write a GLB file with the point cloud and optional camera frusta.

    Args:
      points3d: (N, 3) float (world coordinates).
      colors: optional (N, 3) float in [0, 1] or uint8.
      extrinsics/intrinsics: optional (S, 3, 4) / (S, 3, 3) cameras
        (needs `image_size=(W, H)`).
      frustum_scale: frustum depth in world units (default: 5% of the
        cloud's bounding-box diagonal).
    """
    pts = np.ascontiguousarray(np.asarray(points3d, np.float32))
    n = len(pts)

    if colors is None:
        col = np.full((n, 3), 0.7, np.float32)
    else:
        col = np.asarray(colors)
        col = (col.astype(np.float32) / 255.0 if col.dtype == np.uint8
               else col.astype(np.float32))
    col = np.ascontiguousarray(np.clip(col, 0.0, 1.0))

    bin_parts: list[bytes] = []
    buffer_views = []
    accessors = []
    offset = 0

    def add_view(arr, target):
        nonlocal offset
        raw = _pad4(arr.tobytes())
        bin_parts.append(raw)
        buffer_views.append({"buffer": 0, "byteOffset": offset,
                             "byteLength": len(arr.tobytes()),
                             "target": target})
        offset += len(raw)
        return len(buffer_views) - 1

    def add_accessor(view, comp, count, atype, vmin=None, vmax=None):
        acc = {"bufferView": view, "componentType": comp, "count": count,
               "type": atype}
        if vmin is not None:
            acc["min"] = vmin
            acc["max"] = vmax
        accessors.append(acc)
        return len(accessors) - 1

    pos_acc = add_accessor(
        add_view(pts, _TARGET_ARRAY), _COMPONENT_F32, n, "VEC3",
        [float(x) for x in pts.min(0)] if n else [0.0, 0.0, 0.0],
        [float(x) for x in pts.max(0)] if n else [0.0, 0.0, 0.0])
    col_acc = add_accessor(
        add_view(col, _TARGET_ARRAY), _COMPONENT_F32, n, "VEC3")

    primitives = [{"attributes": {"POSITION": pos_acc,
                                  "COLOR_0": col_acc},
                   "mode": _MODE_POINTS}]

    if extrinsics is not None and intrinsics is not None \
            and image_size is not None and len(extrinsics):
        if frustum_scale is None:
            diag = float(np.linalg.norm(pts.max(0) - pts.min(0))) if n \
                else 1.0
            frustum_scale = 0.05 * max(diag, 1e-6)
        segs = _frustum_segments(np.asarray(extrinsics, np.float64),
                                 np.asarray(intrinsics, np.float64),
                                 image_size, frustum_scale)
        verts = np.ascontiguousarray(segs.reshape(-1, 3))
        idx = np.arange(len(verts), dtype=np.uint32)
        vpos = add_accessor(
            add_view(verts, _TARGET_ARRAY), _COMPONENT_F32, len(verts),
            "VEC3", [float(x) for x in verts.min(0)],
            [float(x) for x in verts.max(0)])
        vcol_arr = np.ascontiguousarray(
            np.tile(np.array([[1.0, 0.3, 0.1]], np.float32),
                    (len(verts), 1)))
        vcol = add_accessor(
            add_view(vcol_arr, _TARGET_ARRAY), _COMPONENT_F32, len(verts),
            "VEC3")
        iacc = add_accessor(
            add_view(idx, _TARGET_ELEMENT), _COMPONENT_U32, len(idx),
            "SCALAR")
        primitives.append({"attributes": {"POSITION": vpos,
                                          "COLOR_0": vcol},
                           "indices": iacc, "mode": _MODE_LINES})

    gltf = {
        "asset": {"version": "2.0", "generator": "vggsfm_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": primitives}],
        "buffers": [{"byteLength": offset}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }

    json_chunk = _pad4(json.dumps(gltf).encode(), b" ")
    bin_chunk = b"".join(bin_parts)
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)
    return path


def reconstruction_to_glb(predictions, path, image_size=None,
                          conf_thresh: float = 0.0):
    """Write a runner `predictions` dict (numpy arrays) as a GLB scene.

    Mirrors the reference's gradio path (visual_util call at
    runners/runner.py:168-178): valid tracks only, colors when present,
    cameras as frusta.
    """
    valid = np.asarray(predictions["valid_tracks"])
    if conf_thresh > 0.0 and predictions.get("pred_score") is not None:
        score = np.asarray(predictions["pred_score"])
        # (B, S, N) confidence -> per-track mean over frames
        conf = score.reshape(-1, score.shape[-1]).mean(axis=0)
        valid = valid & (conf >= conf_thresh)
    pts = np.asarray(predictions["points3d"])[valid]
    colors = predictions.get("colors")
    if colors is not None:
        colors = np.asarray(colors)[valid]
    return write_glb_scene(
        path, pts, colors=colors,
        extrinsics=np.asarray(predictions["extrinsics"]),
        intrinsics=np.asarray(predictions["intrinsics"]),
        image_size=image_size)

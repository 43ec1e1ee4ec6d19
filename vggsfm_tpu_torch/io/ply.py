"""PLY point-cloud export + camera-frustum wireframe export. Counterpart
of vggsfm_tpu/io/ply.py; the files are byte for byte the JAX package's.

The reference visualizes through visdom / gradio GLB (vggsfm/utils/
gradio.py:50-105, trimesh camera cones). Neither visdom nor trimesh is a
dependency here; PLY is the portable interchange every 3D viewer reads.
`export_scene_ply` writes the sparse cloud (+ optional RGB) and camera
frustum edges as a second PLY with line elements.
"""

from __future__ import annotations

import numpy as np


def write_ply_points(path: str, points: np.ndarray,
                     colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY of (N, 3) points, optional (N, 3) uint8."""
    points = np.asarray(points, np.float32)
    n = len(points)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}",
                  "property float x", "property float y",
                  "property float z"]
        if colors is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode())
        if colors is None:
            f.write(points.astype("<f4").tobytes())
        else:
            rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"),
                                     ("z", "<f4"), ("r", "u1"),
                                     ("g", "u1"), ("b", "u1")])
            rec["x"], rec["y"], rec["z"] = points.T
            c = np.asarray(colors, np.uint8)
            rec["r"], rec["g"], rec["b"] = c.T
            f.write(rec.tobytes())


def camera_frustum_edges(extrinsics: np.ndarray, intrinsics: np.ndarray,
                         image_size, scale: float = 0.3):
    """Per-camera frustum wireframes -> (vertices (V,3), edges (E,2))."""
    W, H = image_size
    verts, edges = [], []
    for extr, K in zip(extrinsics, intrinsics):
        R, t = extr[:, :3], extr[:, 3]
        C = -R.T @ t  # camera center in world
        corners_px = np.array([[0, 0], [W, 0], [W, H], [0, H]], np.float64)
        rays = np.linalg.inv(K) @ np.concatenate(
            [corners_px, np.ones((4, 1))], axis=1).T  # (3, 4) cam dirs
        world_corners = (R.T @ (rays * scale)).T + C
        base = len(verts)
        verts.extend([C] + list(world_corners))
        for k in range(4):
            edges.append((base, base + 1 + k))
            edges.append((base + 1 + k, base + 1 + (k + 1) % 4))
    return np.asarray(verts, np.float32), np.asarray(edges, np.int32)


def write_ply_wireframe(path: str, vertices: np.ndarray,
                        edges: np.ndarray) -> None:
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {len(vertices)}",
                  "property float x", "property float y",
                  "property float z",
                  f"element edge {len(edges)}",
                  "property int vertex1", "property int vertex2",
                  "end_header"]
        f.write(("\n".join(header) + "\n").encode())
        f.write(np.asarray(vertices, "<f4").tobytes())
        f.write(np.asarray(edges, "<i4").tobytes())


def export_scene_ply(output_prefix: str, points: np.ndarray,
                     extrinsics: np.ndarray, intrinsics: np.ndarray,
                     image_size, colors: np.ndarray | None = None) -> None:
    """Write `<prefix>_points.ply` and `<prefix>_cameras.ply`."""
    write_ply_points(f"{output_prefix}_points.ply", points, colors)
    v, e = camera_frustum_edges(extrinsics, intrinsics, image_size)
    write_ply_wireframe(f"{output_prefix}_cameras.ply", v, e)

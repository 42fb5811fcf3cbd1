"""PLY point-cloud / mesh export (a numpy copy of
`monocular_slam_tpu/io/ply.py`; the port keeps its own).

Replaces the PCL visualizer output path (`src/PointCloudVisualizer.cpp`):
instead of an interactive window, write standard PLY files viewable anywhere.
"""

from __future__ import annotations

import numpy as np


def write_ply_points(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None) -> None:
    """ASCII PLY of a point cloud. xyz: (N, 3); rgb optional (N, 3) uint8."""
    xyz = np.asarray(xyz)
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if rgb is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            line = f"{xyz[i, 0]:.6f} {xyz[i, 1]:.6f} {xyz[i, 2]:.6f}"
            if rgb is not None:
                line += f" {int(rgb[i, 0])} {int(rgb[i, 1])} {int(rgb[i, 2])}"
            f.write(line + "\n")


def write_ply_mesh(path: str, xyz: np.ndarray, faces: np.ndarray) -> None:
    """ASCII PLY mesh. xyz: (N, 3); faces: (M, 3) int vertex indices."""
    xyz = np.asarray(xyz)
    faces = np.asarray(faces)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for p in xyz:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def read_ply_points(path: str) -> np.ndarray:
    """Read vertices of an ASCII PLY (xyz only)."""
    with open(path) as f:
        line = f.readline()
        assert line.strip() == "ply"
        n = 0
        while True:
            line = f.readline().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header":
                break
        pts = []
        for _ in range(n):
            vals = f.readline().split()
            pts.append([float(v) for v in vals[:3]])
    return np.asarray(pts)


def read_ply_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read an ASCII PLY mesh back as (verts (N, 3), faces (M, 3) int)."""
    with open(path) as f:
        assert f.readline().strip() == "ply"
        n_v = n_f = 0
        while True:
            line = f.readline().strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element face"):
                n_f = int(line.split()[-1])
            elif line == "end_header":
                break
        verts = np.array(
            [[float(x) for x in f.readline().split()[:3]] for _ in range(n_v)]
        )
        faces = np.array(
            [[int(x) for x in f.readline().split()[1:4]] for _ in range(n_f)],
            dtype=np.int64,
        )
    return verts, faces

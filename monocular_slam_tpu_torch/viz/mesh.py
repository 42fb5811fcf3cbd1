"""Surface reconstruction from point clouds: normals, filters, greedy and
Poisson meshing (counterpart of `monocular_slam_tpu/viz/mesh.py`).

The reference replaces PCL's meshing (normal estimation + greedy projection
triangulation, `UnitTest/pcl/UnitTestPCL.cpp:9-63`; Poisson meshing with
statistical-outlier and voxel filters, `src/PointCloudVisualizer.cpp:533-738`)
with numpy. Here the same steps are torch ops in float64 on the device of
the points given (a tensor's own device; an array goes to the card unless
it is handed over as a CPU tensor):

  - `estimate_normals`: PCA over the k nearest neighbours, the distances as
    one matmul per block of rows, batched 3x3 `eigh`;
  - `remove_outliers` / `voxel_downsample`: the StatisticalOutlierRemoval /
    VoxelGrid filters;
  - `greedy_projection_mesh`: projection onto the dominant plane, 2D
    Delaunay (scipy, on the host), long-edge and sliver filtering;
  - `poisson_mesh`: trilinear splat of the oriented normals, a spectral
    Poisson solve (`torch.fft`), marching tetrahedra.

Every scatter-add is a deterministic segment sum (`utils/scatter.py`) in the
reference's `np.add.at` order.
"""

from __future__ import annotations

import numpy as np
import torch

from monocular_slam_tpu_torch.utils.device import resolve_device
from monocular_slam_tpu_torch.utils.scatter import segment_sum

KNN_BLOCK_ROWS = 4096  # rows of the distance matrix held at once


def _cloud(points) -> torch.Tensor:
    if torch.is_tensor(points):
        return points.to(torch.float64)
    return torch.as_tensor(np.asarray(points), dtype=torch.float64, device=resolve_device(None))


def knn_indices(points, k: int) -> torch.Tensor:
    """(N, k) indices of each point's k nearest neighbours (itself excluded),
    nearest first, from the squared distances |x|^2 + |y|^2 - 2 x.y."""
    X = _cloud(points)
    sq = (X * X).sum(1)
    out = []
    for r0 in range(0, X.shape[0], KNN_BLOCK_ROWS):
        rows = torch.arange(r0, min(r0 + KNN_BLOCK_ROWS, X.shape[0]), device=X.device)
        D = sq[rows, None] + sq[None, :] - 2.0 * (X[rows] @ X.T)
        D[torch.arange(rows.shape[0], device=X.device), rows] = float("inf")
        out.append(torch.topk(D, k, dim=1, largest=False).indices)
    return torch.cat(out)


def estimate_normals(points, k: int = 12) -> torch.Tensor:
    """Per-point unit normals from PCA of the k-NN neighbourhood, oriented
    away from the cloud's centroid (a consistent hemisphere)."""
    X = _cloud(points)
    nbrs = X[knn_indices(X, k)]  # (N, k, 3)
    d = nbrs - nbrs.mean(dim=1, keepdim=True)
    C = torch.einsum("nki,nkj->nij", d, d) / k
    normals = torch.linalg.eigh(C).eigenvectors[:, :, 0]  # smallest eigenvalue
    flip = (normals * (X - X.mean(dim=0))).sum(1) < 0
    return torch.where(flip[:, None], -normals, normals)


def remove_outliers(points, k: int = 8, std_ratio: float = 2.0):
    """Statistical outlier removal (PCL StatisticalOutlierRemoval): drop the
    points whose mean k-NN distance exceeds mean + std_ratio * std.
    Returns (kept points, keep mask)."""
    X = _cloud(points)
    d = torch.linalg.norm(X[knn_indices(X, k)] - X[:, None], dim=-1).mean(dim=1)
    keep = d <= d.mean() + std_ratio * d.std(correction=0)
    return X[keep], keep


def voxel_downsample(points, voxel: float) -> torch.Tensor:
    """VoxelGrid filter: one centroid per occupied voxel, voxels in
    lexicographic order of their integer coordinates (as `np.unique`)."""
    X = _cloud(points)
    keys = torch.floor(X / voxel).long()
    _, inv, counts = torch.unique(keys, dim=0, return_inverse=True, return_counts=True)
    return segment_sum(X, inv, counts.shape[0]) / counts[:, None]


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median: the mean of the two middle values for an even count."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def greedy_projection_mesh(points, max_edge: float | None = None, min_angle_deg: float = 10.0):
    """Triangulate a mostly-2.5D cloud: PCA plane projection, 2D Delaunay
    (scipy, on the host) and long-edge/sliver filtering. Returns (vertices
    (N, 3), faces (M, 3) int64) on the points' device."""
    from scipy.spatial import Delaunay

    X = _cloud(points)
    mu = X.mean(dim=0)
    C = (X - mu).T @ (X - mu) / X.shape[0]
    basis = torch.linalg.eigh(C).eigenvectors[:, 1:]  # the two largest principal directions
    UV = (X - mu) @ basis
    faces = torch.as_tensor(Delaunay(UV.cpu().numpy()).simplices, dtype=torch.long, device=X.device)

    a, b, c = X[faces[:, 0]], X[faces[:, 1]], X[faces[:, 2]]
    L = torch.stack([torch.linalg.norm(a - b, dim=1), torch.linalg.norm(b - c, dim=1),
                     torch.linalg.norm(c - a, dim=1)], dim=1)
    if max_edge is None:
        max_edge = 4.0 * _median(L)
    keep = L.max(dim=1).values <= max_edge
    # the smallest angle, by the law of cosines
    a2, b2, c2 = L[:, 0] ** 2, L[:, 1] ** 2, L[:, 2] ** 2
    cosines = torch.stack([
        (b2 + c2 - a2) / (2 * torch.sqrt(b2 * c2) + 1e-12),
        (a2 + c2 - b2) / (2 * torch.sqrt(a2 * c2) + 1e-12),
        (a2 + b2 - c2) / (2 * torch.sqrt(a2 * b2) + 1e-12),
    ], dim=1)
    min_ang = torch.rad2deg(torch.arccos(torch.clamp(cosines, -1, 1))).min(dim=1).values
    keep &= min_ang >= min_angle_deg
    return X, faces[keep]


# --- Poisson surface reconstruction ------------------------------------------

# 6-tetrahedra decomposition of a cube around the 0-7 diagonal. Corner
# numbering: bit 0 = +x, bit 1 = +y, bit 2 = +z (c0=(0,0,0) ... c7=(1,1,1)).
_CUBE_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                 (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))
_TETS = ((0, 5, 1, 7), (0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7))


def _tet_cases():
    """(inside-corner code, triangles as three (corner a, corner b) edges)
    of one tetrahedron: one corner inside (and its complement) gives one
    triangle of the three edges leaving it; two inside, a quad as two."""
    cases = []
    for c in range(4):
        others = [o for o in range(4) if o != c]
        tri = [(c, others[0]), (c, others[1]), (c, others[2])]
        cases.append((1 << c, [tri]))
        cases.append((15 ^ (1 << c), [tri[::-1]]))
    for a, b in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
        o = [x for x in range(4) if x not in (a, b)]
        quad = [(a, o[0]), (a, o[1]), (b, o[1]), (b, o[0])]
        cases.append(((1 << a) | (1 << b), [[quad[0], quad[1], quad[2]],
                                            [quad[0], quad[2], quad[3]]]))
    return cases


def _solve_poisson_fft(div: torch.Tensor, h: float) -> torch.Tensor:
    """Solve lap(chi) = div on a periodic grid spectrally. The domain is
    padded well beyond the cloud, so the periodic wrap never touches the
    surface band."""
    R = div.shape[0]
    c = 2.0 * torch.cos(2.0 * np.pi * torch.fft.fftfreq(R, dtype=torch.float64,
                                                        device=div.device)) - 2.0
    eig = (c[:, None, None] + c[None, :, None] + c[None, None, :]) / (h * h)
    eig[0, 0, 0] = 1.0  # zero mode: chi is defined up to a constant
    chi_hat = torch.fft.fftn(div) / eig
    chi_hat[0, 0, 0] = 0.0
    return torch.fft.ifftn(chi_hat).real


def _marching_tetrahedra(field: torch.Tensor, iso: float, origin, h: float):
    """The iso-surface of an (R, R, R) scalar field by marching tetrahedra
    (6 tets a cube, per-tet cases): watertight by construction, since every
    interior face is shared by two tetrahedra that cut it along the same two
    edges. Returns (verts (V, 3) float64, tris (T, 3) int64)."""
    R = field.shape[0]
    dev = field.device
    g = field - iso
    base = torch.arange(R - 1, device=dev)
    ii, jj, kk = torch.meshgrid(base, base, base, indexing="ij")
    corner_vals = torch.stack([g[ii + dx, jj + dy, kk + dz].reshape(-1)
                               for dx, dy, dz in _CUBE_CORNERS], dim=1)  # (C, 8)
    corner_lin = torch.stack([(((ii + dx) * R + (jj + dy)) * R + (kk + dz)).reshape(-1)
                              for dx, dy, dz in _CUBE_CORNERS], dim=1)  # (C, 8)
    weights = torch.tensor([1, 2, 4, 8], device=dev)

    tri_edges = []  # (M, 3, 2) grid-point ids of each triangle's three cut edges
    for tet in _TETS:
        lin = corner_lin[:, tet]
        code = ((corner_vals[:, tet] < 0.0).long() * weights).sum(1)
        for case, tris in _tet_cases():
            sel = torch.nonzero(code == case)[:, 0]
            if sel.numel() == 0:
                continue
            for tri in tris:
                a = torch.stack([lin[sel, p] for p, _ in tri], dim=1)
                b = torch.stack([lin[sel, q] for _, q in tri], dim=1)
                tri_edges.append(torch.stack([a, b], dim=2))

    if not tri_edges:
        return (torch.zeros((0, 3), dtype=torch.float64, device=dev),
                torch.zeros((0, 3), dtype=torch.long, device=dev))
    ea = torch.cat(tri_edges).reshape(-1, 2)
    # one vertex per grid EDGE (sorted endpoint pair)
    n3 = R ** 3
    key = torch.where(ea[:, 0] < ea[:, 1], ea[:, 0] * n3 + ea[:, 1], ea[:, 1] * n3 + ea[:, 0])
    uniq, inv = torch.unique(key, return_inverse=True)
    a, b = uniq // n3, uniq % n3
    gf = g.reshape(-1)
    va, vb = gf[a], gf[b]
    t = torch.clamp(va / torch.where((va - vb).abs() > 1e-12, va - vb, 1.0), 0.0, 1.0)

    def lin2xyz(q):
        return torch.stack([q // (R * R), (q // R) % R, q % R], dim=1).to(torch.float64)

    pa, pb = lin2xyz(a), lin2xyz(b)
    origin = torch.as_tensor(origin, dtype=torch.float64, device=dev)
    verts = origin[None, :] + h * (pa + t[:, None] * (pb - pa))
    tris = inv.reshape(-1, 3)
    # drop degenerate triangles (two corners on the same edge vertex)
    ok = (tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2]) & (tris[:, 0] != tris[:, 2])
    return verts, tris[ok]


def _gradient(f: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """`np.gradient(f, h, axis=dim)`: central differences inside, one-sided
    first-order differences at the two ends."""
    n = f.shape[dim]
    fwd = (f.narrow(dim, 1, 1) - f.narrow(dim, 0, 1)) / h
    mid = (f.narrow(dim, 2, n - 2) - f.narrow(dim, 0, n - 2)) / (2.0 * h)
    bwd = (f.narrow(dim, n - 1, 1) - f.narrow(dim, n - 2, 1)) / h
    return torch.cat([fwd, mid, bwd], dim=dim)


def poisson_mesh(points, normals=None, depth: int = 6, pad: float = 0.15, normal_k: int = 16):
    """Poisson surface reconstruction: a watertight mesh from an oriented
    point cloud (the capability the reference gets from `pcl::Poisson`,
    `src/PointCloudVisualizer.cpp:533-605`), on regular grids:

      1. estimate normals if not given (PCA, centroid-oriented);
      2. splat the oriented normals into a (2^depth)^3 vector grid V
         (trilinear): the smoothed indicator gradient field;
      3. solve lap(chi) = div V spectrally (the grid is padded so the
         periodic wrap never touches the surface);
      4. iso-level = mean of chi at the samples (Kazhdan's choice);
      5. extract the iso-surface with marching tetrahedra.

    Returns (verts (V, 3), tris (T, 3) int64). Apply `remove_outliers` /
    `voxel_downsample` first for the PCL filter chain (:607-641)."""
    X = _cloud(points)
    N = estimate_normals(X, k=normal_k) if normals is None else _cloud(normals).to(X.device)

    R = 1 << depth
    lo, hi = X.min(dim=0).values, X.max(dim=0).values
    span = float((hi - lo).max())
    half = span * (0.5 + pad)
    origin = (hi + lo) / 2.0 - half
    h = (2.0 * half) / (R - 1)

    # trilinear splat of the normals, in np.add.at's order: corner by
    # corner, point by point
    gc = (X - origin[None, :]) / h
    i0 = torch.clamp(torch.floor(gc).long(), 0, R - 2)
    f = gc - i0
    cells, contrib = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                cells.append(((i0[:, 0] + dx) * R + (i0[:, 1] + dy)) * R + (i0[:, 2] + dz))
                contrib.append(w[:, None] * N)
    V = segment_sum(torch.cat(contrib), torch.cat(cells), R ** 3).reshape(R, R, R, 3)

    div = sum(_gradient(V[..., ax], h, ax) for ax in range(3))
    chi = _solve_poisson_fft(div, h)

    iso = chi[i0[:, 0], i0[:, 1], i0[:, 2]].mean()
    g = chi - iso
    verts, tris = _marching_tetrahedra(g, 0.0, origin, h)
    if verts.shape[0] == 0:
        verts, tris = _marching_tetrahedra(-g, 0.0, origin, h)
    return verts, tris


def mesh_boundary_edges(tris) -> int:
    """Number of boundary (odd-degree) edges: 0 for a watertight mesh."""
    tris = torch.as_tensor(tris).long()
    e = torch.cat([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = torch.sort(e, dim=1).values
    key = e[:, 0] * (tris.max() + 1) + e[:, 1]
    _, counts = torch.unique(key, return_counts=True)
    return int((counts % 2 != 0).sum())

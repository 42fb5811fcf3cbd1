"""Surface meshing of the port (`monocular_slam_tpu_torch/viz/mesh.py`) against
the reference's (`monocular_slam_tpu/viz/mesh.py`, numpy) on the same seeded
float64 inputs, then the reference's own mesh cases
(`tests/test_depth_mesh_compare.py`) on the port. CPU tensors in, so
everything runs on the CPU; the tolerance is stated in each test."""

import numpy as np
import pytest
import torch

from monocular_slam_tpu.viz import mesh as jmesh
from monocular_slam_tpu_torch.io import ply
from monocular_slam_tpu_torch.viz import mesh as tmesh

from port_util import one_torch_thread  # noqa: F401 (autouse)


def _surface(n=400, seed=0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    return np.column_stack([xy, 0.2 * np.sin(2 * xy[:, 0]) + 0.1 * xy[:, 1] ** 2])


def _sphere(n=4000, seed=0):
    d = np.random.RandomState(seed).normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _box(n=1500, seed=1):
    rng = np.random.RandomState(seed)
    face = rng.randint(0, 6, n)
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.zeros((n, 3))
    ax = face % 3
    sign = np.where(face < 3, 1.0, -1.0)
    for i in range(n):
        others = [a for a in range(3) if a != ax[i]]
        pts[i, ax[i]] = sign[i]
        pts[i, others[0]] = uv[i, 0]
        pts[i, others[1]] = uv[i, 1]
    return pts


def T(a):
    return torch.as_tensor(a)


def _face_set(f):
    f = np.sort(np.asarray(f), axis=1)
    return f[np.lexsort(f.T[::-1])]


# --- each function against the reference --------------------------------------------------

def test_knn_and_normals_match_reference():
    """The same neighbour sets (order aside); normals to 1e-9 (float64)."""
    pts = _surface(300, seed=3)
    np.testing.assert_array_equal(np.sort(tmesh.knn_indices(T(pts), 8).numpy(), axis=1),
                                  np.sort(jmesh.knn_indices(pts, 8), axis=1))
    np.testing.assert_allclose(tmesh.estimate_normals(T(pts), k=12).numpy(),
                               jmesh.estimate_normals(pts, k=12), atol=1e-9)


def test_knn_in_row_blocks(monkeypatch):
    """Blocks of rows give the whole matrix's neighbours."""
    pts = T(_surface(300, seed=4))
    whole = tmesh.knn_indices(pts, 6)
    monkeypatch.setattr(tmesh, "KNN_BLOCK_ROWS", 64)
    np.testing.assert_array_equal(tmesh.knn_indices(pts, 6).numpy(), whole.numpy())


def test_filters_match_reference():
    """Outlier masks equal and kept points exact; voxel centroids to 1e-12,
    in `np.unique`'s order."""
    pts = np.vstack([_surface(), [[0.0, 0.0, 5.0], [1.0, 1.0, -7.0]]])
    kept_t, keep_t = tmesh.remove_outliers(T(pts), k=8, std_ratio=2.0)
    kept_j, keep_j = jmesh.remove_outliers(pts, k=8, std_ratio=2.0)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    np.testing.assert_array_equal(kept_t.numpy(), kept_j)
    big = _surface(1000)
    np.testing.assert_allclose(tmesh.voxel_downsample(T(big), 0.2).numpy(),
                               jmesh.voxel_downsample(big, 0.2), atol=1e-12)


def test_greedy_mesh_matches_reference():
    """The same vertices and the same set of triangles (Delaunay on the
    host, then the same long-edge and sliver filters)."""
    pts = _surface()
    vt, ft = tmesh.greedy_projection_mesh(T(pts))
    vj, fj = jmesh.greedy_projection_mesh(pts)
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_array_equal(_face_set(ft), _face_set(fj))


def test_poisson_pieces_match_reference():
    """The spectral solve to 1e-9 relative; marching tetrahedra on the same
    field exactly (vertices to 1e-12); the boundary-edge count equal on a
    mesh with a hole."""
    rng = np.random.RandomState(5)
    div = rng.randn(16, 16, 16)
    chi_t = tmesh._solve_poisson_fft(T(div), 0.1).numpy()
    chi_j = jmesh._solve_poisson_fft(div, 0.1)
    np.testing.assert_allclose(chi_t, chi_j, rtol=1e-9, atol=1e-9 * np.abs(chi_j).max())
    x = np.linspace(-1, 1, 12)
    field = np.sqrt(x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2) - 0.7
    origin = np.array([-1.0, -1.0, -1.0])
    vt, tt = tmesh._marching_tetrahedra(T(field), 0.0, T(origin), 2.0 / 11)
    vj, tj = jmesh._marching_tetrahedra(field, 0.0, origin, 2.0 / 11)
    np.testing.assert_allclose(vt.numpy(), vj, atol=1e-12)
    np.testing.assert_array_equal(tt.numpy(), tj)
    holed = tj[5:]
    assert tmesh.mesh_boundary_edges(T(holed)) == jmesh.mesh_boundary_edges(holed) > 0


@pytest.mark.parametrize("normals", [True, False])
def test_poisson_mesh_matches_reference(normals):
    """The whole reconstruction of the sphere (given normals) and of the
    box (estimated normals), depth 5: the same triangles, vertices to 1e-9."""
    pts = _sphere() if normals else _box()
    kw = {"normals": T(pts)} if normals else {}
    vt, tt = tmesh.poisson_mesh(T(pts), depth=5, **kw)
    vj, tj = jmesh.poisson_mesh(pts, depth=5, **({"normals": pts} if normals else {}))
    np.testing.assert_array_equal(tt.numpy(), tj)
    np.testing.assert_allclose(vt.numpy(), vj, atol=1e-9)


# --- the reference's mesh cases on the port -----------------------------------------------

def test_normals_of_plane():
    rng = np.random.RandomState(1)
    pts = np.column_stack([rng.uniform(-1, 1, (200, 2)), np.zeros(200)])
    n = tmesh.estimate_normals(T(pts), k=8).numpy()
    assert (np.abs(n[:, 2]) > 0.99).mean() > 0.95


def test_outlier_removal():
    allp = np.vstack([_surface(), [[0.0, 0.0, 5.0], [1.0, 1.0, -7.0]]])
    _, keep = tmesh.remove_outliers(T(allp), k=8, std_ratio=2.0)
    keep = keep.numpy()
    assert not keep[-1] and not keep[-2]
    assert keep[:-2].mean() > 0.95


def test_voxel_downsample():
    down = tmesh.voxel_downsample(T(_surface(1000)), 0.2)
    assert 10 < len(down) < 1000


def test_greedy_mesh(tmp_path):
    verts, faces = tmesh.greedy_projection_mesh(T(_surface()))
    assert len(faces) > 300 and int(faces.max()) < len(verts)
    L = torch.linalg.norm(verts[faces[:, 0]] - verts[faces[:, 1]], dim=1)
    assert float(L.median()) < 0.4  # triangles connect nearby points only
    ply.write_ply_mesh(str(tmp_path / "m.ply"), verts.numpy(), faces.numpy())


def test_sphere_watertight():
    d = _sphere()
    v, t = tmesh.poisson_mesh(T(d), normals=T(d), depth=5)
    assert len(t) > 1000
    assert tmesh.mesh_boundary_edges(t) == 0
    r = np.linalg.norm(v.numpy() - d.mean(0), axis=1)
    assert abs(r.mean() - 1.0) < 0.05 and r.std() < 0.05


def test_estimated_normals_box(tmp_path):
    """A box from positions only, then the mesh through PLY and back."""
    v, t = tmesh.poisson_mesh(T(_box()), depth=5)
    assert len(t) > 500 and tmesh.mesh_boundary_edges(t) == 0
    v, t = v.numpy(), t.numpy()
    assert np.median(np.abs(np.abs(v).max(axis=1) - 1.0)) < 0.15
    path = str(tmp_path / "box.ply")
    ply.write_ply_mesh(path, v, t)
    v2, t2 = ply.read_ply_mesh(path)
    np.testing.assert_allclose(v2, v, atol=1e-4)
    np.testing.assert_array_equal(t2, t)


def test_arrays_default_to_the_card():
    """A numpy cloud goes to the card; without one it raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        assert tmesh.estimate_normals(_surface(50)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tmesh.estimate_normals(_surface(50))

"""K3's Jacobi schedule and arithmetic on the CPU (`csrc/small_eigh.cu` runs
only on a card; `tests/test_torch_cuda.py` holds the kernels themselves
against `torch.linalg` there). These tests cover the CUDA source only as
far as `tests/k3_emulation.py` copies it by hand: only the card tests
cover the kernel, so a change to the kernel is copied into the emulation
and the K3 cases of `tests/test_torch_cuda.py` are run on a card.

`small_eigh.jacobi_rounds`, the kernel's round-robin schedule, must pair
every index pair once a sweep and no index twice in a round. The float64
emulation of the kernels (`tests/k3_emulation.py`) is held against JAX's
`jnp.linalg.eigh` / `svd` (CPU) and `torch.linalg` on `chip_smoke.py`'s K3
inputs, by the smoke's rules: values within 1e-5 of the largest,
|<v, v_ref>| >= 1 - 1e-5 where the eigengap exceeds 1e-3 of the largest,
U S Vt within 1e-5; then on degenerate inputs (identity, zero, rank 1 and 2,
repeated eigenvalues, NaN) and 3x3 matrices near a rank deficiency, and its
sweep counts are bounded.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import k3_emulation as emu
from monocular_slam_tpu_torch.geometry import so3
from monocular_slam_tpu_torch.ops import small_eigh
from port_util import one_torch_thread  # noqa: F401 (autouse)

TOL = chip_smoke.K3_TOL
GAP = chip_smoke.K3_GAP


def _inputs():
    """`chip_smoke._k3_inputs` (seeded numpy) as float32 numpy arrays."""
    return {name: x.numpy() for name, x in chip_smoke._k3_inputs("cpu").items()}


def _vector_dot(V, Vr, wr):
    """min |<v, v_ref>| where the eigengap exceeds GAP of the largest
    |value| (None if no vector qualifies)."""
    wr = np.asarray(wr, np.float64)
    scale = np.abs(wr).max(-1, keepdims=True)
    gap = np.full_like(wr, np.inf)
    d = np.abs(np.diff(wr, axis=-1))
    gap[..., 1:] = np.minimum(gap[..., 1:], d)
    gap[..., :-1] = np.minimum(gap[..., :-1], d)
    dots = np.abs((np.asarray(V, np.float64) * np.asarray(Vr, np.float64)).sum(-2))
    sel = gap > GAP * scale
    return float(dots[sel].min()) if sel.any() else None


@pytest.mark.parametrize("n", range(1, 13))
def test_jacobi_rounds_pair_each_pair_once(n):
    rounds = small_eigh.jacobi_rounds(n)
    m = n + (n & 1)
    assert len(rounds) == m - 1
    seen = []
    for pairs in rounds:
        idx = [i for pq in pairs for i in pq]
        assert len(idx) == len(set(idx)), f"an index twice in a round: {pairs}"
        assert all(0 <= p < q < n for p, q in pairs)
        seen += pairs
    assert sorted(seen) == list(itertools.combinations(range(n), 2))


@pytest.mark.parametrize("name", ["eigh (1000, 4, 4)", "eigh (1, 12, 12)"])
def test_emulated_eigh_matches_jax_and_torch(name):
    A = _inputs()[name]
    w, V, _ = emu.eigh(A)
    w32, V32 = w.astype(np.float32), V.astype(np.float32)  # the kernel writes float32
    wj, Vj = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(A)))
    wt, Vt = (x.numpy() for x in torch.linalg.eigh(torch.from_numpy(A)))
    for wr, Vr in ((wj, Vj), (wt, Vt)):
        scale = np.abs(wr).max(-1, keepdims=True)
        assert np.abs(w32 - wr).max() / scale.max() <= TOL
        assert (np.abs(w32 - wr) / scale).max() <= TOL
        dot = _vector_dot(V32, Vr, wr)
        assert dot is not None and dot >= 1 - TOL
    assert (np.diff(w, axis=-1) >= 0).all()
    A64 = A.astype(np.float64)
    scale = np.abs(w).max()
    assert np.abs(A64 @ V - V * w[..., None, :]).max() / scale <= 1e-12
    assert np.abs(np.swapaxes(V, -1, -2) @ V - np.eye(A.shape[-1])).max() <= 1e-12
    big = np.take_along_axis(V, np.abs(V).argmax(-2)[..., None, :], -2)
    assert (big > 0).all()  # each vector's largest-magnitude entry positive


@pytest.mark.parametrize("name", ["svd3 (1, 3, 3)", "svd3 (512, 3, 3)"])
def test_emulated_svd3_matches_jax_and_torch(name):
    M = _inputs()[name]
    U, S, Vt, _ = emu.svd3(M)
    U32, S32, Vt32 = (x.astype(np.float32) for x in (U, S, Vt))
    Uj, Sj, Vtj = (np.asarray(x) for x in jnp.linalg.svd(jnp.asarray(M)))
    Ut, St, Vtt = (x.numpy() for x in torch.linalg.svd(torch.from_numpy(M)))
    for Ur, Sr, Vtr in ((Uj, Sj, Vtj), (Ut, St, Vtt)):
        scale = Sr.max(-1, keepdims=True)
        assert (np.abs(S32 - Sr) / scale).max() <= TOL
        for dot in (_vector_dot(U32, Ur, Sr), _vector_dot(np.swapaxes(Vt32, -1, -2),
                                                           np.swapaxes(Vtr, -1, -2), Sr)):
            assert dot is not None and dot >= 1 - TOL
    assert (np.diff(S, axis=-1) <= 0).all()
    rec = (U32 * S32[..., None, :]) @ Vt32
    assert np.abs(rec - M).max() / np.abs(M).max() <= TOL
    eye = np.eye(3)
    assert np.abs(np.swapaxes(U, -1, -2) @ U - eye).max() <= 1e-12
    assert np.abs(Vt @ np.swapaxes(Vt, -1, -2) - eye).max() <= 1e-12


def test_emulated_sweeps_at_the_step_shapes():
    """The round-robin ordering needs no more sweeps than the cyclic one
    did: at most 8 at 12x12, 6 at 4x4 on the smoke's inputs (the
    earlier cyclic kernel: 6 at 12x12, 4.1 on average at 4x4)."""
    inp = _inputs()
    _, _, s12 = emu.eigh(inp["eigh (1, 12, 12)"])
    _, _, s4 = emu.eigh(inp["eigh (1000, 4, 4)"])
    _, _, _, s3 = emu.svd3(inp["svd3 (512, 3, 3)"])
    assert 1 <= s12.max() <= 8
    assert 1 <= s4.max() <= 6 and s4.mean() <= 4.1
    assert 1 <= s3.max() <= 6


def _degenerate(kind, n, rng):
    if kind == "identity":
        return np.eye(n)
    if kind == "zero":
        return np.zeros((n, n))
    if kind in ("rank1", "rank2"):
        x = rng.normal(size=(int(kind[-1]), n))
        return x.T @ x
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))  # repeated eigenvalues
    d = np.array([1.0, 1.0, 2.0, 2.0, 2.0, 3.0, 3.0, 3.0, 3.0, 5.0, 5.0, 6.0])[:n]
    return (Q * d) @ Q.T


@pytest.mark.parametrize("kind", ["identity", "zero", "rank1", "rank2", "repeated"])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 9, 12])
def test_emulated_eigh_degenerate(kind, n):
    """Values as numpy's float64 `eigh`; A V = V diag(w) and V orthonormal
    (a repeated eigenvalue's basis is any); identity and zero take no
    sweep and give V = I."""
    A = _degenerate(kind, n, np.random.default_rng(n))
    w, V, sweeps = emu.eigh(A)
    wn = np.linalg.eigh(A)[0]
    scale = max(np.abs(wn).max(), 1.0)
    assert np.abs(w - wn).max() <= 1e-13 * scale
    assert np.abs(A @ V - V * w).max() <= 1e-13 * scale
    assert np.abs(V.T @ V - np.eye(n)).max() <= 1e-13
    assert sweeps <= 10
    if kind in ("identity", "zero"):
        assert sweeps == 0 and np.array_equal(V, np.eye(n))


@pytest.mark.parametrize("n", [1, 4, 12])
def test_emulated_eigh_nan_stops(n):
    """A NaN matrix: the off-diagonal mass is not finite, so the stop test
    ends the loop before its first sweep (far inside the cap); every
    eigenvalue comes out NaN, each written once."""
    w, V, sweeps = emu.eigh(np.full((2, n, n), np.nan))
    assert (sweeps == 0).all() and sweeps.max() <= emu.MAX_SWEEPS
    assert np.isnan(w).all()
    assert np.array_equal(V, np.broadcast_to(np.eye(n), (2, n, n)))


@pytest.mark.parametrize("kind", ["identity", "zero", "rank1", "rank2", "rotation"])
def test_emulated_svd3_degenerate(kind):
    """Singular values as numpy's float64 SVD, U S Vt = M, U and V
    orthonormal: the rank-deficient completion of U included."""
    rng = np.random.default_rng(3)
    if kind == "rotation":
        M = so3.exp(torch.tensor([[0.3, -1.2, 0.5]], dtype=torch.float64))[0].numpy()
    elif kind in ("rank1", "rank2"):
        r = int(kind[-1])
        M = rng.normal(size=(3, r)) @ rng.normal(size=(r, 3))
    else:
        M = _degenerate(kind, 3, rng)
    U, S, Vt, sweeps = emu.svd3(M)
    Sn = np.linalg.svd(M, compute_uv=False)
    scale = max(Sn.max(), 1.0)
    assert np.abs(S - Sn).max() <= 1e-13 * scale
    assert np.abs((U * S) @ Vt - M).max() <= 1e-13 * scale
    assert np.abs(U.T @ U - np.eye(3)).max() <= 1e-13
    assert np.abs(Vt @ Vt.T - np.eye(3)).max() <= 1e-13
    assert 1 <= sweeps <= 6


def test_cpu_eigh_nan_for_nonfinite_only():
    """`eigh` on the CPU: a matrix with a non-finite entry comes out NaN
    (XLA's answer; torch's CPU routine raises on it), the others are
    `eigh_plain`'s, which stays the bare `torch.linalg.eigh`."""
    A = torch.as_tensor(np.random.default_rng(4).normal(size=(3, 4, 4)))
    A = A + A.transpose(-1, -2)
    A[1, 2, 0] = np.inf
    w, V = small_eigh.eigh(A)
    assert torch.isnan(w[1]).all() and torch.isnan(V[1]).all()
    keep = torch.tensor([0, 2])
    wp, Vp = small_eigh.eigh_plain(A[keep])
    assert torch.equal(w[keep], wp) and torch.equal(V[keep], Vp)
    with pytest.raises(Exception):
        small_eigh.eigh_plain(A)


def test_emulated_svd3_nan_stops():
    U, S, Vt, sweeps = emu.svd3(np.full((3, 3), np.nan))
    assert sweeps == 1 and np.isnan(S).all()


def test_rotation_from_svd_is_project_to_so3():
    """The helper the PnP refit takes on a card, on the CPU's factors: the
    same rotation as `project_to_so3`, reflections included."""
    rng = np.random.default_rng(5)
    M = torch.from_numpy(rng.normal(size=(64, 3, 3)).astype(np.float32))
    U, _, Vt = torch.linalg.svd(M)
    R = so3.rotation_from_svd(U, Vt)
    torch.testing.assert_close(R, so3.project_to_so3(M), rtol=0, atol=0)
    torch.testing.assert_close(R.mT @ R, torch.eye(3).expand(64, 3, 3), rtol=0, atol=1e-5)
    assert float((torch.linalg.det(R) - 1).abs().max()) < 1e-5


@pytest.mark.parametrize("s2,tol", [(1e-2, 1e-13), (1e-4, 1e-11), (1e-8, 1e-7)])
def test_emulated_svd3_near_rank_deficiency(s2, tol):
    """Singular values (1, s2, 0): the Jacobi on M^T M squares the
    condition, so the error grows toward sqrt(eps) of the largest value as
    s2 falls, and no further; a diagonal entry of G that rounding takes
    below 0 must not freeze its pairs (the test on |g_pp g_qq|)."""
    rng = np.random.default_rng(int(-np.log10(s2)))
    for _ in range(20):
        Q1, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        Q2, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        M = (Q1 * np.array([1.0, s2, 0.0])) @ Q2.T
        U, S, Vt, _ = emu.svd3(M)
        assert np.abs(S - np.linalg.svd(M, compute_uv=False)).max() <= tol
        assert np.abs((U * S) @ Vt - M).max() <= tol
        assert np.abs(U.T @ U - np.eye(3)).max() <= 1e-13


def test_k3ab_sites_cover_every_binding():
    """`chip_profile.K3_SITES`, the sites the k3ab routes swap, holds every
    module global of the port bound to `small_eigh.eigh`, `svd3`,
    `svdvals3`, `linalg.det3x3` or PnP's `scale_and_rotation` (a binding
    made at import keeps its function when only the defining module's
    attribute is swapped), and nothing else; `k3_sites` swaps every site of
    a kind and restores it."""
    import importlib
    import pkgutil

    import chip_profile
    import monocular_slam_tpu_torch as pkg
    from monocular_slam_tpu_torch.geometry import pnp
    from monocular_slam_tpu_torch.utils import linalg

    kinds = [(small_eigh.eigh, "eigh"), (small_eigh.svd3, "svd3"),
             (small_eigh.svdvals3, "svdvals3"), (linalg.det3x3, "det3x3"),
             (pnp.scale_and_rotation, "pnp_scale_and_rotation")]
    found = set()
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mod = importlib.import_module(m.name)
        for name, value in vars(mod).items():
            for fn, kind in kinds:
                if value is fn:
                    found.add((kind, m.name, name))
    sites = {(kind, mod, attr) for kind, ss in chip_profile.K3_SITES.items() for mod, attr in ss}
    assert found == sites, (found - sites, sites - found)

    def sentinel(*a):
        raise AssertionError("swapped")

    with chip_profile.k3_sites(**dict.fromkeys(chip_profile.K3_SITES, sentinel)):
        assert all(getattr(importlib.import_module(m), a) is sentinel for _, m, a in sites)
    assert not any(getattr(importlib.import_module(m), a) is sentinel for _, m, a in sites)


K3AB_FIRST_IMPORT = r"""
import importlib, sys
import chip_profile
sites = [(m, a) for ss in chip_profile.K3_SITES.values() for m, a in ss]
assert "monocular_slam_tpu_torch.geometry.alignment" not in sys.modules
with chip_profile.k3_sites(**chip_profile.parent_calls()):
    pass
from monocular_slam_tpu_torch.geometry import pnp
from monocular_slam_tpu_torch.ops import small_eigh
from monocular_slam_tpu_torch.utils import linalg
want = {"det3x3": linalg.det3x3, "eigh": small_eigh.eigh, "svd3": small_eigh.svd3,
        "svdvals3": small_eigh.svdvals3, "scale_and_rotation": pnp.scale_and_rotation}
left = [(m, a) for m, a in sites if getattr(importlib.import_module(m), a) is not want[a]]
assert not left, left
print("restored", len(sites))
"""


def test_k3ab_sites_restore_modules_first_imported_inside():
    """`k3_sites` must leave every site bound to its own function even
    when a site's module is first imported by the swap itself (otherwise
    `chip_profile.py k3ab` gave 3.863 cm on the cli course where every
    fresh run gives 4.222). In a fresh interpreter where
    `geometry.alignment` is not yet imported, the parent route's swap and
    restore must leave `alignment.det3x3` the closed form; when the module
    was imported inside the swap, it bound `torch.linalg.det` by name and
    kept it, so every later route of the process fit its Sim3s with it."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", K3AB_FIRST_IMPORT], capture_output=True,
                         text=True, cwd=str(root), timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "restored" in out.stdout


def test_pnp_scale_and_rotation_apart_is_the_reference_calls():
    """PnP's decomposition as the reference makes it (the CPU's, and the
    k3ab parent route's on a card): the scale from `svdvals3`, the rotation
    from `project_to_so3`; the card's one-`svd3` form gives the same values
    (here both on `torch.linalg`)."""
    from monocular_slam_tpu_torch.geometry import pnp

    rng = np.random.default_rng(3)
    M = torch.as_tensor(rng.normal(size=(16, 3, 3)) + 2 * np.eye(3), dtype=torch.float64)
    s, R = pnp.scale_and_rotation(M)
    torch.testing.assert_close(s, torch.linalg.svdvals(M).mean(-1), rtol=0, atol=0)
    torch.testing.assert_close(R, so3.project_to_so3(M), rtol=0, atol=0)
    U, S, Vt = torch.linalg.svd(M)
    torch.testing.assert_close(R, so3.rotation_from_svd(U, Vt), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(s, S.mean(-1), rtol=1e-12, atol=1e-12)

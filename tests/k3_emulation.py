"""A float64 numpy emulation of K3's kernels (`csrc/small_eigh.cu`), for the
CPU tests: the CUDA kernels run only on a card, so their arithmetic is
checked here step for step as the kernels take it. Nothing ties it to the
CUDA source but this copy: a change to `csrc/small_eigh.cu` is made here
too, and the K3 cases of `tests/test_torch_cuda.py` are run on a card.

`eigh(A)` follows `small_eigh_warp_kernel` / `small_eigh_thread_kernel`: the
lower triangle read into double, an odd n padded with a zero phantom index,
sweeps of `small_eigh.jacobi_rounds(n)`'s rounds, every rotation of a round
computed from the round's matrix (theta, t, c, s; a pair whose entry is
exactly 0 left alone) and applied to whole 2x2 blocks (columns first, then
rows), the diagonal blocks set to app - t apq, aqq + t apq and an exact 0;
the stop test `not off > 1e-30 diag` before each sweep, at most 30 sweeps;
eigenvalues ascending (NaN last, ties by index) and each eigenvector's
first largest-magnitude entry made positive.

`svd3(M)` follows `svd3_kernel`: G = M^T M in double, the cyclic Jacobi
method on G over the pairs (0, 1), (0, 2), (1, 2), a pair rotated while
|g_pq| > 1e-15 sqrt(|g_pp g_qq|), sweeps until none rotates (at most 30);
B = M V, singular values B's column norms in a stable descending order,
U's columns B's first normalised, its second orthogonalised against the
first, its third their signed cross product, with the kernel's floor and
completion for small singular values.

Both work on a batch at once; a matrix that has stopped is left as it is
(a mask), as its warp or thread would be. Each returns its sweep counts
too: the sweeps that rotated (eigh) or ran (svd3) before the stop.
"""

from __future__ import annotations

import numpy as np

from monocular_slam_tpu_torch.ops.small_eigh import jacobi_rounds

MAX_SWEEPS = 30


def _rotation(app, aqq, apq):
    """c, s, t of the kernel's `rotation` (the identity where apq == 0)."""
    on = apq != 0.0
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        theta = (aqq - app) / (2.0 * np.where(on, apq, 1.0))
        t = 1.0 / (np.abs(theta) + np.sqrt(theta * theta + 1.0))
        t = np.where(theta < 0.0, -t, t)
        c = 1.0 / np.sqrt(t * t + 1.0)
        s = t * c
    return np.where(on, c, 1.0), np.where(on, s, 0.0), np.where(on, t, 0.0), on


def _pairs_of_round(n, r):
    """The kernel's round r with the phantom slots kept: (p, q) per slot."""
    m = n + (n & 1)
    out = []
    for k in range(m // 2):
        a, b = (r, m - 1) if k == 0 else ((r + k) % (m - 1), (r - k) % (m - 1))
        out.append((min(a, b), max(a, b)))
    return out


def eigh(A: np.ndarray):
    """(w, V, sweeps) of symmetric (..., n, n), as the kernels compute them,
    in float64."""
    A = np.asarray(A, np.float64)
    n = A.shape[-1]
    lead = A.shape[:-2]
    A = A.reshape(-1, n, n)
    B = A.shape[0]
    m = n + (n & 1)
    low = np.tril(A)
    a = np.zeros((B, m, m))
    a[:, :n, :n] = low + np.swapaxes(np.tril(A, -1), -1, -2)  # symmetric from the lower triangle
    v = np.broadcast_to(np.eye(m), (B, m, m)).copy()
    assert [[pq for pq in _pairs_of_round(n, r) if pq[1] < n] for r in range(m - 1)] \
        == jacobi_rounds(n)
    active = np.ones(B, bool)
    sweeps = np.zeros(B, np.int64)
    il = np.tril_indices(n, -1)
    for _ in range(MAX_SWEEPS):
        with np.errstate(invalid="ignore", over="ignore"):
            off = 2.0 * (a[:, :n, :n][:, il[0], il[1]] ** 2).sum(-1)
            dg = np.diagonal(a[:, :n, :n], axis1=-2, axis2=-1)
            diag = (dg * dg).sum(-1)
            active &= off > 1e-30 * diag
        if not active.any():
            break
        sweeps += active
        for r in range(m - 1):
            pairs = _pairs_of_round(n, r)
            rot = [_rotation(a[:, p, p], a[:, q, q], a[:, q, p]) for p, q in pairs]
            new = a.copy()
            for (p, q), (c, s, t, on) in zip(pairs, rot):
                upd = on & active
                apq = a[:, q, p]
                new[:, p, p] = np.where(upd, a[:, p, p] - t * apq, a[:, p, p])
                new[:, q, q] = np.where(upd, a[:, q, q] + t * apq, a[:, q, q])
                new[:, q, p] = new[:, p, q] = np.where(upd, 0.0, apq)
            for i, ((pI, qI), (cI, sI, _, _)) in enumerate(zip(pairs, rot)):
                for (pJ, qJ), (cJ, sJ, _, _) in zip(pairs[:i], rot[:i]):
                    b00, b01 = a[:, pI, pJ], a[:, pI, qJ]
                    b10, b11 = a[:, qI, pJ], a[:, qI, qJ]
                    c00, c01 = cJ * b00 - sJ * b01, sJ * b00 + cJ * b01
                    c10, c11 = cJ * b10 - sJ * b11, sJ * b10 + cJ * b11
                    blk = {(pI, pJ): cI * c00 - sI * c10, (qI, pJ): sI * c00 + cI * c10,
                           (pI, qJ): cI * c01 - sI * c11, (qI, qJ): sI * c01 + cI * c11}
                    for (x, y), val in blk.items():
                        val = np.where(active, val, a[:, x, y])
                        new[:, x, y] = new[:, y, x] = val
            for (p, q), (c, s, _, _) in zip(pairs, rot):
                c, s = np.where(active, c, 1.0)[:, None], np.where(active, s, 0.0)[:, None]
                vp, vq = v[:, :n, p].copy(), v[:, :n, q].copy()
                v[:, :n, p] = c * vp - s * vq
                v[:, :n, q] = s * vp + c * vq
            a = new
    d = np.diagonal(a, axis1=-2, axis2=-1)[:, :n]
    vv = v[:, :n, :n]
    w = np.empty((B, n))
    V = np.empty((B, n, n))
    for b in range(B):
        nan = np.isnan(d[b])
        order = np.lexsort((np.arange(n), np.where(nan, 0.0, d[b]), nan))
        for rank, k in enumerate(order):
            col = vv[b, :, k]
            big = col[np.argmax(np.where(np.isnan(col), -1.0, np.abs(col)))]
            w[b, rank] = d[b, k]
            V[b, :, rank] = -col if big < 0.0 else col
    return w.reshape(lead + (n,)), V.reshape(lead + (n, n)), sweeps.reshape(lead)


def _unit_orthogonal(u):
    """The kernel's `unit_orthogonal`: u x e_i for u's smallest |entry|."""
    i = (0 if abs(u[0]) <= abs(u[2]) else 2) if abs(u[0]) <= abs(u[1]) else \
        (1 if abs(u[1]) <= abs(u[2]) else 2)
    out = np.cross(u, np.eye(3)[i])
    return out / np.sqrt((out * out).sum())


def svd3(M: np.ndarray):
    """(U, S, Vt, sweeps) of (..., 3, 3), as `svd3_kernel` computes them, in
    float64."""
    M = np.asarray(M, np.float64)
    lead = M.shape[:-2]
    M = M.reshape(-1, 3, 3)
    B = M.shape[0]
    g = np.einsum("bri,brj->bij", M, M)
    v = np.broadcast_to(np.eye(3), (B, 3, 3)).copy()
    running = np.ones(B, bool)
    sweeps = np.zeros(B, np.int64)
    for _ in range(MAX_SWEEPS):
        if not running.any():
            break
        sweeps += running
        rotated = np.zeros(B, bool)
        for p, q in ((0, 1), (0, 2), (1, 2)):
            o = 3 - p - q
            al, be, ga = g[:, p, p].copy(), g[:, q, q].copy(), g[:, p, q].copy()
            with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
                on = running & (np.abs(ga) > 1e-15 * np.sqrt(np.abs(al * be)))
                zeta = (be - al) / (2.0 * np.where(on, ga, 1.0))
                t = 1.0 / (np.abs(zeta) + np.sqrt(1.0 + zeta * zeta))
                t = np.where(zeta < 0.0, -t, t)
                c = 1.0 / np.sqrt(1.0 + t * t)
                s = c * t
            rotated |= on
            gop, goq = g[:, o, p].copy(), g[:, o, q].copy()
            g[:, p, p] = np.where(on, al - t * ga, al)
            g[:, q, q] = np.where(on, be + t * ga, be)
            g[:, p, q] = g[:, q, p] = np.where(on, 0.0, ga)
            g[:, o, p] = g[:, p, o] = np.where(on, c * gop - s * goq, gop)
            g[:, o, q] = g[:, q, o] = np.where(on, s * gop + c * goq, goq)
            vp, vq = v[:, :, p].copy(), v[:, :, q].copy()
            cc, ss = c[:, None], s[:, None]
            v[:, :, p] = np.where(on[:, None], cc * vp - ss * vq, vp)
            v[:, :, q] = np.where(on[:, None], ss * vp + cc * vq, vq)
        running &= rotated
    bm = M @ v  # columns: M v_c
    sig = np.sqrt((bm * bm).sum(-2))
    U = np.empty((B, 3, 3))
    S = np.empty((B, 3))
    Vt = np.empty((B, 3, 3))
    for b in range(B):
        order = [0, 1, 2]  # the kernel's bubble sort: stable, descending
        for i in range(2):
            for j in range(2 - i):
                if sig[b, order[j]] < sig[b, order[j + 1]]:
                    order[j], order[j + 1] = order[j + 1], order[j]
        sg = sig[b, order]
        floor = sg[0] * 1e-15
        have = int(sum(x > floor and x > 1e-300 for x in sg))
        cols = bm[b][:, order].T
        if have == 0:
            u = np.eye(3)
        else:
            u = np.empty((3, 3))
            u[0] = cols[0] / sg[0]
            if have >= 2:
                x = cols[1] - (u[0] @ cols[1]) * u[0]
                u[1] = x / np.sqrt((x * x).sum())
            else:
                u[1] = _unit_orthogonal(u[0])
            u[2] = np.cross(u[0], u[1])
            if have == 3 and u[2] @ cols[2] < 0.0:
                u[2] = -u[2]
        U[b] = u.T
        S[b] = sg
        Vt[b] = v[b][:, order].T
    return (U.reshape(lead + (3, 3)), S.reshape(lead + (3,)), Vt.reshape(lead + (3, 3)),
            sweeps.reshape(lead))

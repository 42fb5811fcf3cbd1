"""Parity of K2's plain version and the port's matching and vocabulary with
the JAX reference on the CPU: `hamming_top2_plain` against the Pallas
kernel in interpret mode (exact), `match(use_kernel=True)` against
`match_pallas` (exact on `ok`, and on idx/dist where `ok`), the dense
`match` and `guided_match` (exact), and the vocabulary's transform, BoW
vectors, scores and training (integers exact, float32 within 1e-6)."""

import hashlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_slam_tpu.ops import matching as jmatch
from monocular_slam_tpu.ops.pallas import hamming as jham
from monocular_slam_tpu.retrieval import vocabulary as jvoc
from monocular_slam_tpu_torch.ops import launches
from monocular_slam_tpu_torch.ops import hamming as tham
from monocular_slam_tpu_torch.ops import matching as tmatch
from monocular_slam_tpu_torch.retrieval import vocabulary as tvoc
from port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent


def _pm1(rng, n):
    return np.where(rng.rand(n, 256) > 0.5, 1, -1).astype(np.int8)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


_SEEDS = {"300x700": 0, "97x123": 1, "all_invalid": 2, "duplicates": 3, "single_valid": 4}


def _top2_case(name):
    rng = np.random.RandomState(_SEEDS[name])
    if name == "300x700":  # the shapes of tests/test_pallas_kernels.py
        a, b = _pm1(rng, 300), _pm1(rng, 700)
        bv = np.ones(700, bool)
        bv[5] = False
    elif name == "97x123":
        a, b = _pm1(rng, 97), _pm1(rng, 123)
        bv = rng.rand(123) > 0.2
    elif name == "all_invalid":
        a, b = _pm1(rng, 32), _pm1(rng, 64)
        bv = np.zeros(64, bool)
    elif name == "duplicates":  # equal minima: lowest index, d2 == d1
        a = _pm1(rng, 40)
        b = np.concatenate([_pm1(rng, 30), a[:20], a[:20], _pm1(rng, 10)])
        bv = np.ones(len(b), bool)
        bv[35] = False
    else:  # "single_valid": d2 stays BIG
        a, b = _pm1(rng, 20), _pm1(rng, 50)
        bv = np.zeros(50, bool)
        bv[17] = True
    return a, b, bv


@pytest.mark.parametrize("name", ["300x700", "97x123", "all_invalid", "duplicates", "single_valid"])
def test_hamming_top2_plain_matches_pallas(name):
    a, b, bv = _top2_case(name)
    tile = 128 if len(a) > 64 else 32
    jd1, jd2, jidx = jham.hamming_top2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bv),
                                       tile_n=tile, tile_m=tile, interpret=True)
    td1, td2, tidx = tham.hamming_top2(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(bv))
    for t, j in ((td1, jd1), (td2, jd2), (tidx, jidx)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(_np(t), np.asarray(j))
    if name == "all_invalid":
        assert (_np(td1) == tham.BIG).all() and (_np(tidx) == 0).all()
    if name == "single_valid":
        assert (_np(tidx) == 17).all() and (_np(td2) == tham.BIG).all()
    if name == "duplicates":
        rows = np.r_[0:5, 6:20]  # row 5's first copy (database row 35) is invalid
        assert (_np(td2)[rows] == _np(td1)[rows]).all() and (_np(tidx)[rows] == 30 + rows).all()
        assert _np(tidx)[5] == 55


@pytest.mark.parametrize("cross_check", [True, False])
def test_match_kernel_route_matches_pallas(cross_check):
    rng = np.random.RandomState(2)
    a = _pm1(rng, 200)
    b = np.concatenate([a[:150], _pm1(rng, 100)])
    flip = rng.rand(*b.shape) < 0.05
    b = np.where(flip, -b, b).astype(np.int8)
    av, bv = rng.rand(200) > 0.1, rng.rand(250) > 0.1
    mj = jham.match_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(av), jnp.asarray(bv),
                           ratio=0.8, cross_check=cross_check, interpret=True)
    T = [torch.as_tensor(x) for x in (a, b, av, bv)]
    mt = tmatch.match(*T, ratio=0.8, cross_check=cross_check, use_kernel=True)
    ok = np.asarray(mj.ok)
    np.testing.assert_array_equal(_np(mt.ok), ok)
    np.testing.assert_array_equal(_np(mt.idx)[ok], np.asarray(mj.idx)[ok])
    np.testing.assert_array_equal(_np(mt.dist)[ok], np.asarray(mj.dist)[ok])
    assert int(mt.n_matches) == int(mj.n_matches) > 50
    # the dense route agrees with the kernel route wherever a match stands
    md = tmatch.match(*T, ratio=0.8, cross_check=cross_check, use_kernel=False)
    np.testing.assert_array_equal(_np(md.ok), ok)
    np.testing.assert_array_equal(_np(md.idx)[ok], _np(mt.idx)[ok])


def test_dense_and_guided_match_exact():
    rng = np.random.RandomState(3)
    a = _pm1(rng, 120)
    b = np.concatenate([a[:90], _pm1(rng, 60)])
    b = np.where(rng.rand(*b.shape) < 0.04, -b, b).astype(np.int8)
    av, bv = rng.rand(120) > 0.1, rng.rand(150) > 0.1
    na, nb = rng.randint(0, 4, 120), rng.randint(0, 4, 150)
    nb[:90] = na[:90]
    J = [jnp.asarray(x) for x in (a, b, av, bv)]
    T = [torch.as_tensor(x) for x in (a, b, av, bv)]
    for mj, mt in (
        (jmatch.match(*J, ratio=0.9, max_dist=80), tmatch.match(*T, ratio=0.9, max_dist=80)),
        (jmatch.guided_match(*J, jnp.asarray(na), jnp.asarray(nb), ratio=0.9),
         tmatch.guided_match(*T, torch.as_tensor(na), torch.as_tensor(nb), ratio=0.9)),
    ):
        for f in ("idx", "dist", "ok"):
            np.testing.assert_array_equal(_np(getattr(mt, f)), np.asarray(getattr(mj, f)), err_msg=f)


def test_kernel_entry_refuses_cpu_and_bad_inputs():
    a = torch.ones(4, 256, dtype=torch.int8)
    with pytest.raises(ValueError):
        tham.hamming_top2_cuda(a, a, torch.ones(4, dtype=torch.bool))
    # the default route on CPU tensors is the dense table, never the kernel
    before = launches.read()
    tmatch.match(a, a, torch.ones(4, dtype=torch.bool), torch.ones(4, dtype=torch.bool))
    assert launches.read() == before


# --- vocabulary -------------------------------------------------------------------

def test_default_vocab_is_byte_identical():
    ours = ROOT / "monocular_slam_tpu_torch" / "retrieval" / "default_vocab.npz"
    ref = ROOT / "monocular_slam_tpu" / "retrieval" / "default_vocab.npz"
    assert hashlib.sha256(ours.read_bytes()).digest() == hashlib.sha256(ref.read_bytes()).digest()


@pytest.fixture(scope="module")
def vocabs():
    rng = np.random.RandomState(5)
    centers = _pm1(rng, 40)
    train_desc = centers[rng.randint(0, 40, 3000)]
    train_desc = np.where(rng.rand(*train_desc.shape) < 0.08, -train_desc, train_desc).astype(np.int8)
    return {
        "bundled": (jvoc.load_default(), tvoc.load_default(device="cpu")),
        "trained": (jvoc.train(train_desc, k=6, L=3, seed=1),
                    tvoc.train(train_desc, k=6, L=3, seed=1, device="cpu")),
        "queries": np.where(rng.rand(*train_desc[:400].shape) < 0.1, -train_desc[:400],
                            train_desc[:400]).astype(np.int8),
    }


@pytest.mark.parametrize("which", ["bundled", "trained"])
def test_vocabulary_transform_bow_score(vocabs, which):
    jv, tv = vocabs[which]
    for lvl in range(jv.L):
        np.testing.assert_array_equal(_np(tv.nodes[lvl]).astype(np.int8), np.asarray(jv.nodes[lvl]))
    np.testing.assert_array_equal(_np(tv.weights), np.asarray(jv.weights))
    q = vocabs["queries"]
    valid = np.random.RandomState(6).rand(len(q)) > 0.1
    jw = jvoc.transform_words(jv, jnp.asarray(q), jnp.asarray(valid))
    tw = tvoc.transform_words(tv, torch.as_tensor(q), torch.as_tensor(valid))
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    np.testing.assert_array_equal(
        _np(tvoc.node_words(tv, torch.as_tensor(q), torch.as_tensor(valid), levels_up=1)),
        np.asarray(jvoc.node_words(jv, jnp.asarray(q), jnp.asarray(valid), levels_up=1)))
    # BoW vectors of 8 query "frames" and every scoring scheme between them
    jb = np.stack([np.asarray(jvoc.bow_vector(jv, jnp.asarray(q[f::8]), jnp.asarray(valid[f::8])))
                   for f in range(8)])
    tb = torch.stack([tvoc.bow_vector(tv, torch.as_tensor(q[f::8]), torch.as_tensor(valid[f::8]))
                      for f in range(8)])
    np.testing.assert_allclose(_np(tb), jb, rtol=1e-5, atol=1e-7)
    for kind in tvoc.SCORING:
        np.testing.assert_allclose(
            _np(tvoc.score_against_database(tb[0], tb, kind)),
            np.asarray(jvoc.score_against_database(jnp.asarray(jb[0]), jnp.asarray(jb), kind)),
            rtol=1e-5, atol=1e-6, err_msg=kind)


def test_vocabulary_from_numpy_and_save_roundtrip(vocabs, tmp_path):
    jv, tv = vocabs["trained"]
    tv2 = tvoc.vocabulary_from_numpy([np.asarray(n) for n in jv.nodes], np.asarray(jv.weights),
                                     jv.k, jv.L, device="cpu")
    p = str(tmp_path / "v.npz")
    tvoc.save(p, tv2)
    tv3 = tvoc.load(p, device="cpu")
    assert (tv3.k, tv3.L, tv3.n_words) == (jv.k, jv.L, jv.n_words)
    for a, b in zip(tv3.nodes, tv.nodes):
        assert torch.equal(a, b)
    if torch.cuda.is_available():
        assert tvoc.load_default().weights.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tvoc.load_default()  # the default device is the card


# --- K2's batch, split and merge ----------------------------------------------------


def _batched_case(seed, B=3, N=150, M=300):
    """B databases; in database 1, query rows 0-19 have exact copies at
    database rows 127 and 128 (either side of a 128-row tile boundary)."""
    rng = np.random.RandomState(seed)
    a = _pm1(rng, N)
    b = np.stack([_pm1(rng, M) for _ in range(B)])
    b[1, 127] = a[0]
    b[1, 128] = a[0]
    b[1, 100:120] = a[1:21]
    b[1, 200:220] = a[1:21]
    bv = rng.rand(B, M) > 0.15
    bv[1, [127, 128]] = True
    bv[2] = False
    return a, b, bv


def test_hamming_top2_plain_batched_matches_pallas():
    a, b, bv = _batched_case(7)
    td1, td2, tidx = tham.hamming_top2(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(bv))
    assert td1.shape == (3, 150)
    for w in range(3):
        jd1, jd2, jidx = jham.hamming_top2(jnp.asarray(a), jnp.asarray(b[w]), jnp.asarray(bv[w]),
                                           interpret=True)
        for t, j in ((td1[w], jd1), (td2[w], jd2), (tidx[w], jidx)):
            np.testing.assert_array_equal(_np(t), np.asarray(j))
    assert _np(tidx)[1, 0] == 127 and _np(td2)[1, 0] == _np(td1)[1, 0] == 0
    assert (_np(td1)[2] == tham.BIG).all() and (_np(tidx)[2] == 0).all()


# csrc/hamming_top2.cu's key arithmetic, in numpy
_IDX_BITS = 22
_BASE_VALID = 256 << (_IDX_BITS - 1)
_BASE_INVALID = 0xC0000000
_KEY_NONE = 0xFFFFFFFF


def _keys(a, b, bv):
    """(N, M) uint32 keys as the kernel's epilogue forms them: base - dot << 21."""
    dot = a.astype(np.int64) @ b.astype(np.int64).T
    base = np.where(bv, _BASE_VALID + np.arange(b.shape[0]), _BASE_INVALID).astype(np.int64)
    return (base[None, :] - (dot << (_IDX_BITS - 1))) % 2**32


def _merge(k1, k2, c1, c2):
    return np.minimum(k1, c1), np.minimum(np.minimum(k2, c2), np.maximum(k1, c1))


def _split_top2(a, b, bv, S, rng):
    """The kernel's split and merge pass: the database cut into S runs of
    whole 128-row tiles, each run's columns folded into a running top-2 in a
    random order by the insert rule, the S partials merged in a random
    order, then decoded."""
    N, M = a.shape[0], b.shape[0]
    keys = _keys(a, b, bv)
    n_tiles = -(-M // tham.DB_TILE)
    parts = []
    for s in range(S):
        lo = n_tiles * s // S * tham.DB_TILE
        hi = min(n_tiles * (s + 1) // S * tham.DB_TILE, M)
        k1 = np.full(N, _KEY_NONE, np.int64)
        k2 = k1.copy()
        for j in rng.permutation(np.arange(lo, hi)):
            k1, k2 = _merge(k1, k2, keys[:, j], np.full(N, _KEY_NONE, np.int64))
        parts.append((k1, k2))
    k1 = np.full(N, _KEY_NONE, np.int64)
    k2 = k1.copy()
    for s in rng.permutation(S):
        k1, k2 = _merge(k1, k2, *parts[s])
    v1, v2 = k1 < 2**31, k2 < 2**31
    d1 = np.where(v1, k1 >> _IDX_BITS, tham.BIG)
    idx = np.where(v1, k1 & ((1 << _IDX_BITS) - 1), 0)
    d2 = np.where(v2, k2 >> _IDX_BITS, tham.BIG)
    return d1, d2, idx


@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_split_merge_equals_whole(S):
    """Keys, per-split top-2 and the merge rule give the whole database's
    (d1, d2, idx) exactly: ties either side of a split boundary, a split
    whose rows are all invalid, a ragged last tile, an all-invalid
    database."""
    rng = np.random.RandomState(30 + S)
    a = _pm1(rng, 40)
    M = 5 * tham.DB_TILE + 37
    b = _pm1(rng, M)
    b[127] = b[128] = a[0]  # tile boundary 128 (a split boundary for S = 5)
    b[255] = b[256 + 10] = a[1]
    bv = rng.rand(M) > 0.1
    bv[[127, 128, 255, 266]] = True
    bv[384:512] = False  # a whole tile invalid
    for valid in (bv, np.zeros(M, bool)):
        got = _split_top2(a, b, valid, S, rng)
        want = tham.hamming_top2_plain(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(valid))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, _np(w))
    assert got[0][0] == tham.BIG  # the all-invalid pass


def test_split_count():
    """Grid sizing: at most one wave of 3 blocks per SM of a 132-SM card,
    whole tiles per split, never more splits than tiles."""
    assert tham.splits(1000, 1000, 1, 132) == 8  # every tile its own split
    assert tham.splits(1000, 1000, 5, 132) == 4  # 320 blocks
    assert tham.splits(5000, 1000, 1, 132) == 5  # 395 blocks
    assert tham.splits(2000, 65536, 1, 132) == 12  # 384 blocks
    assert tham.splits(1, 0, 1, 132) == 1
    assert tham.splits(64, 100, 1, 132) == 1


@pytest.mark.parametrize("cross_check", [True, False])
def test_match_kernel_batched_equals_dense(cross_check):
    """The batched kernel route (its plain version here) returns the dense
    route's whole `Matches`: idx, dist, ok and n_matches on every row,
    including rows with ~a_valid and a database with no valid row."""
    rng = np.random.RandomState(8)
    a = _pm1(rng, 90)
    b = np.stack([np.concatenate([a[rng.permutation(90)[:60]], _pm1(rng, 20)]) for _ in range(4)])
    b = np.where(rng.rand(*b.shape) < 0.05, -b, b).astype(np.int8)
    av = rng.rand(90) > 0.2
    bv = rng.rand(4, 80) > 0.1
    bv[3] = False
    T = [torch.as_tensor(x) for x in (a, b, av, bv)]
    mk = tmatch.match(*T, ratio=0.8, max_dist=80, cross_check=cross_check, use_kernel=True)
    md = tmatch.match(*T, ratio=0.8, max_dist=80, cross_check=cross_check, use_kernel=False)
    for f in ("idx", "dist", "ok", "n_matches"):
        np.testing.assert_array_equal(_np(getattr(mk, f)), _np(getattr(md, f)), err_msg=f)
    assert _np(mk.n_matches)[:3].min() > 20 and _np(mk.n_matches)[3] == 0

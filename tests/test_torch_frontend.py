"""Parity of the port's ORB front-end pieces with the JAX reference on
synthetic inputs: the plain version of K1 (against the reference's XLA path
and its Pallas kernel in interpret mode) on the kernel tests' images, the
BRIEF pattern and bit layout, and matching. The pyramid and `extract` run
on a rendered frame in `test_torch_slice.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_slam_tpu.ops import fast as jfast
from monocular_slam_tpu.ops import matching as jmatch
from monocular_slam_tpu.ops import orb as jorb
from monocular_slam_tpu.ops.pallas import fast_score as jfs
from monocular_slam_tpu_torch.ops import fast_score as tfs
from monocular_slam_tpu_torch.ops import matching as tmatch
from monocular_slam_tpu_torch.ops import orb as torb
from port_util import jnp32, np32, t32
from port_util import one_torch_thread  # noqa: F401 (autouse)


def _kernel_test_image(seed, h=96, w=160):
    """`tests/test_pallas_kernels.py::TestFastScoreKernel`'s image shape:
    smooth noise plus sharp blocks, so FAST has real responses."""
    rng = np.random.RandomState(seed)
    img = 40.0 * rng.rand(h, w)
    img[20:40, 30:50] += 120.0
    img[60:63, 100:140] += 90.0
    img[75, 20] += 150.0
    return img.astype(np.float32)


def _check_maps(img, thr):
    nms_t, raw_t = (np32(x) for x in tfs.corner_maps(t32(img), thr))
    j = jnp32(img)
    # (a) the reference's XLA formulation
    np.testing.assert_allclose(nms_t, np32(jfast.nms3(jfast.corner_score(j, thr))), atol=1e-5)
    np.testing.assert_allclose(raw_t[3:-3, 3:-3], np32(jfast.corner_score_raw(j))[3:-3, 3:-3],
                               atol=1e-5)
    # (b) the reference's Pallas kernel, interpreted
    nms_p, raw_p = jfs.corner_maps(j, thr, interpret=True)
    np.testing.assert_allclose(nms_t, np32(nms_p), atol=1e-5)
    np.testing.assert_allclose(raw_t[3:-3, 3:-3], np32(raw_p)[3:-3, 3:-3], atol=1e-5)
    assert nms_t.max() > thr


@pytest.mark.parametrize("shape,thr", [((96, 160), 20.0), ((101, 173), 15.0)])
def test_k1_plain_kernel_images(shape, thr):
    _check_maps(_kernel_test_image(7, *shape), thr)


def test_pattern_matches_reference():
    np.testing.assert_array_equal(torb.PATTERN, np.asarray(jorb.PATTERN))


def test_pack_unpack_bits():
    rng = np.random.RandomState(0)
    bits = rng.rand(9, 256) > 0.5
    packed = torb.pack_bits(torch.as_tensor(bits))
    # bit b of word w is test w*32+b (the reference's layout)
    ref = (bits.reshape(9, 8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    ref = ref.astype(np.uint32)
    np.testing.assert_array_equal(np32(packed).view(np.uint32), ref)
    np.testing.assert_array_equal(np32(torb.unpack_pm1(packed)), np.asarray(jorb.unpack_pm1(jnp.asarray(ref))))


def _pm1(rng, n):
    return np.where(rng.rand(n, 256) > 0.5, 1, -1).astype(np.int8)


@pytest.mark.parametrize("case", ["plain", "invalid_rows", "all_invalid_db", "duplicates"])
def test_match_exact(case):
    rng = np.random.RandomState(11)
    a = _pm1(rng, 120)
    b = a[rng.permutation(120)[:100]].copy()
    flip = rng.rand(*b.shape) < 0.08
    b[flip] *= -1
    a_valid = np.ones(120, bool)
    b_valid = np.ones(100, bool)
    if case == "invalid_rows":
        a_valid[::7] = False
        b_valid[::5] = False
    elif case == "all_invalid_db":
        b_valid[:] = False
    elif case == "duplicates":
        b[10] = b[11]  # exact ties: lowest index must win
    rj = jmatch.match(jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_valid), jnp.asarray(b_valid),
                      ratio=0.8, max_dist=80)
    rt = tmatch.match(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(a_valid),
                      torch.as_tensor(b_valid), ratio=0.8, max_dist=80)
    np.testing.assert_array_equal(np32(rt.idx), np.asarray(rj.idx))
    np.testing.assert_array_equal(np32(rt.dist), np.asarray(rj.dist))
    np.testing.assert_array_equal(np32(rt.ok), np.asarray(rj.ok))
    if case == "all_invalid_db":
        assert not np32(rt.ok).any()
    else:
        assert np32(rt.ok).sum() > 30
    np.testing.assert_array_equal(
        np32(tmatch.hamming_matrix(torch.as_tensor(a), torch.as_tensor(b))),
        np.asarray(jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))


def test_match_batched_equals_loop():
    """The tracker's batched window match equals one match per database."""
    rng = np.random.RandomState(12)
    a = torch.as_tensor(_pm1(rng, 64))
    bs = torch.as_tensor(np.stack([_pm1(rng, 50) for _ in range(3)]))
    bs[1, :20] = a[:20]
    av = torch.ones(64, dtype=torch.bool)
    bv = torch.as_tensor(rng.rand(3, 50) > 0.2)
    batched = tmatch.match(a, bs, av, bv, ratio=0.8)
    for w in range(3):
        one = tmatch.match(a, bs[w], av, bv[w], ratio=0.8)
        for x, y in zip(batched, one):
            np.testing.assert_array_equal(np32(x[w]), np32(y))


def test_corner_maps_rejects_non_cpu_non_cuda():
    with pytest.raises(ValueError):
        tfs.corner_maps(torch.zeros(8, 8, device="meta"))



def _level_test_image(seed, h=120, w=160):
    """Noise plus blocks and lines at several sizes, so every level of its
    8-level pyramid has FAST responses."""
    rng = np.random.RandomState(seed)
    img = 40.0 * rng.rand(h, w)
    for _ in range(12):
        y, x = rng.randint(0, h - 24), rng.randint(0, w - 24)
        s = rng.randint(6, 24)
        img[y:y + s, x:x + s] += rng.uniform(80.0, 160.0)
    return img.astype(np.float32)


def test_corner_maps_levels_plain_matches_pallas():
    """All 8 levels at once (the CPU route of K1's one-launch form) against
    the reference's Pallas kernel, interpreted, level by level: nms maps
    bit-equal everywhere, raw maps bit-equal >= 3 px from each level's
    edge."""
    from monocular_slam_tpu_torch.ops import pyramid as tpyr

    levels = tpyr.build_pyramid(t32(_level_test_image(21)))
    assert len(levels) == 8
    maps = tfs.corner_maps_levels(levels, 20.0)
    assert len(maps) == 8
    for lvl, (img, (nms_t, raw_t)) in enumerate(zip(levels, maps)):
        assert nms_t.shape == raw_t.shape == img.shape
        nms_p, raw_p = jfs.corner_maps(jnp32(np32(img)), 20.0, interpret=True)
        np.testing.assert_array_equal(np32(nms_t), np32(nms_p), err_msg=f"level {lvl}")
        np.testing.assert_array_equal(np32(raw_t)[3:-3, 3:-3], np32(raw_p)[3:-3, 3:-3],
                                      err_msg=f"level {lvl}")
        assert (np32(nms_t) > 0).sum() > 0, f"no corners on level {lvl}"
        one_nms, one_raw = tfs.corner_maps(img, 20.0)
        assert torch.equal(one_nms, nms_t) and torch.equal(one_raw, raw_t)


def test_corner_maps_levels_rejects_bad_tables():
    img = torch.zeros(16, 16)
    with pytest.raises(ValueError):
        tfs.corner_maps_levels([img] * (tfs.MAX_LEVELS + 1))
    with pytest.raises(ValueError):
        tfs.corner_maps_levels([])
    with pytest.raises(ValueError):
        tfs.corner_maps_levels([torch.zeros(8, 8, device="meta")])

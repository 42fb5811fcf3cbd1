"""Shared helpers for the PyTorch-port parity tests (`tests/test_torch_*.py`).

Inputs are made with numpy from a seed, in float32/int32 (the test session
runs JAX with x64 on, so dtypes are pinned on both sides), and handed to the
JAX reference and to the port; outputs come back as numpy arrays.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

# the rendered course of `tests/test_render_e2e.py`: key 3, 12 frames, 320x240
COURSE_KEY = 3
COURSE_FRAMES = 12
COURSE_WH = (320, 240)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while a module's tests run. The suite runs
    several worker processes at once, and torch's default of one thread per
    core in each of them oversubscribes the CPU: the port's small-op solver
    and session loops ran 2-10x slower that way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np32(x) -> np.ndarray:
    """numpy view of a JAX array or torch tensor (float64 -> float32)."""
    if torch.is_tensor(x):
        a = x.detach().cpu().numpy()
    else:
        a = np.array(x)  # a writable copy
    return a.astype(np.float32) if a.dtype == np.float64 else a


def jnp32(a):
    import jax.numpy as jnp

    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return jnp.asarray(a)


def t32(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(a))


def assert_close(actual, expected, rtol=1e-5, atol=1e-5, what=""):
    np.testing.assert_allclose(np32(actual), np32(expected), rtol=rtol, atol=atol, err_msg=what)


def random_poses(rng: np.random.RandomState, n: int, rot=0.3, trans=0.5) -> np.ndarray:
    """(n, 3, 4) float32 poses from random twists (through numpy Rodrigues)."""
    out = []
    for _ in range(n):
        w = rng.uniform(-rot, rot, 3)
        th = np.linalg.norm(w)
        W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        R = np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * W @ W
        t = rng.uniform(-trans, trans, 3)
        out.append(np.concatenate([R, t[:, None]], axis=1))
    return np.asarray(out, np.float32)


def reference_textures(key) -> np.ndarray:
    """`monocular_slam_tpu.datasets.render._texture` for each plane key of
    `render_sequence(key, ...)`: the same key splits and uniform draws (the
    default float dtype, float64 under the tests' x64), the same Keys-cubic
    upsampling to 2048x2048, mix, normalization, median and sigmoid — with
    the 2048x2048 products done in float64 torch matmuls, which give the
    reference's values to float64 rounding in a fraction of its CPU time."""
    import jax

    from monocular_slam_tpu.datasets import render
    from monocular_slam_tpu_torch.ops.pyramid import cubic_upsample

    n_planes = render.box_room().origin.shape[0]
    out = []
    for kk in jax.random.split(key, n_planes):
        k1, k2, k3, k4 = jax.random.split(kk, 4)
        img = torch.zeros((2048, 2048), dtype=torch.float64)
        for w, k, n in ((0.35, k1, 32), (0.30, k2, 96), (0.20, k3, 256), (0.15, k4, 512)):
            u = torch.from_numpy(np.array(jax.random.uniform(k, (n, n))))
            img = img + w * cubic_upsample(u, (2048, 2048))
        img = (img - img.min()) / (img.max() - img.min())
        flat = img.reshape(-1)
        m = flat.numel() // 2
        med = 0.5 * (torch.kthvalue(flat, m).values + torch.kthvalue(flat, m + 1).values)
        out.append((torch.sigmoid((img - med) * 16.0) * 255.0).numpy())
    return np.stack(out)


@functools.lru_cache(maxsize=1)
def rendered_course():
    """The reference renderer's course (`render.render_sequence(PRNGKey(3),
    12, (320, 240))`'s scene, poses and intrinsics, frames drawn by its
    `render_frame`) quantized as its PNG export stores them, plus frame 0 at
    640x480. Returns (images (12, 240, 320), poses_gt (12, 3, 4), k (4,),
    frame0_640x480)."""
    import jax
    import jax.numpy as jnp

    from monocular_slam_tpu.datasets import render
    from monocular_slam_tpu.datasets.synthetic import arc_trajectory

    planes = render.box_room()
    textures = jnp.asarray(reference_textures(jax.random.PRNGKey(COURSE_KEY)))
    poses = arc_trajectory(COURSE_FRAMES, radius=1.8, ang_step=0.06)
    W, H = COURSE_WH
    k = render.SYNTH_K * np.array([W / 640.0, H / 480.0, W / 640.0, H / 480.0])
    # textures go in as an argument: a closed-over 335 MB constant would be
    # folded into the compiled program
    draw = jax.jit(lambda p, kk, tex, wh: render.render_frame(p, kk, wh, planes, tex),
                   static_argnums=3)
    kj = jnp.asarray(k, jnp.float32)
    imgs = np.stack([np.asarray(draw(poses[i], kj, textures, COURSE_WH))
                     for i in range(COURSE_FRAMES)])
    big = np.asarray(draw(poses[0], jnp.asarray(render.SYNTH_K, jnp.float32), textures, (640, 480)))

    def q(a):
        return np.clip(a, 0, 255).astype(np.uint8).astype(np.float32)

    return q(imgs), np.asarray(poses, np.float32), np.asarray(k, np.float64), q(big)


def uniforms(key, n_hyp: int, n: int) -> np.ndarray:
    """The reference's RANSAC draws for `key`, as `_sample_indices` makes
    them (default float dtype: float64 under the tests' x64)."""
    import jax

    return np.array(jax.random.uniform(key, (n_hyp, n), minval=1e-6, maxval=1.0))

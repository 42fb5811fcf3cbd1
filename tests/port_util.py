"""Shared helpers for the PyTorch-port parity tests (`tests/test_torch_*.py`).

Inputs are made with numpy from a seed, in float32/int32 (the test session
runs JAX with x64 on, so dtypes are pinned on both sides), and handed to the
JAX reference and to the port; outputs come back as numpy arrays.
"""

from __future__ import annotations

import contextlib
import functools
import traceback

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

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


# --- gloo worlds for the distributed solvers ---------------------------------
#
# A rank is a process started with `spawn`, which imports the module that
# holds its target: this one (torch, numpy and pytest only). Never a test
# module, which imports JAX without `tests/conftest.py`'s CPU pinning.


def spawn_world(world: int, cases: str, inputs: dict) -> list:
    """Run this module's function `cases(rank, inp=inputs) -> dict` on
    `world` gloo ranks on the CPU (`monocular_slam_tpu_torch.benchmarks.
    spawn_world`: one intra-op thread each, a file rendezvous in a fresh
    temporary directory). Returns each rank's dict, rank order."""
    from monocular_slam_tpu_torch.benchmarks import spawn_world as spawn

    return spawn(world, f"port_util:{cases}", {"inp": inputs}, "cpu")


def ba_problem_numpy(prob) -> dict:
    """A BAProblem (either package's) as numpy arrays by field name."""
    return {f: np.array(getattr(prob, f)) for f in prob._fields}


def _port_problem(d: dict):
    from monocular_slam_tpu_torch.optim.ba import BAProblem

    return BAProblem(**{f: torch.as_tensor(d[f]) for f in BAProblem._fields})


def _port_graph(d: dict):
    from monocular_slam_tpu_torch.optim.pose_graph import PoseGraph

    return PoseGraph(**{f: torch.as_tensor(d[f]) for f in PoseGraph._fields[:7]})


def parallel_cases(rank: int, inp: dict) -> dict:
    """`tests/test_torch_parallel.py`'s cases on one rank of a world of 4:
    meshes of 1, 2 and 4 ranks and a (data 2, model 2) mesh, every rank
    calling every mesh's constructor; each case runs on the ranks of its
    mesh. Results as numpy, per case."""
    from monocular_slam_tpu_torch.parallel import distributed, sharded_ba, sharded_pose_graph
    from monocular_slam_tpu_torch.parallel.mesh import make_mesh

    meshes = {n: make_mesh(n, device="cpu") for n in (1, 2, 4)}
    mesh22 = make_mesh(4, data=2, device="cpu")
    prob = _port_problem(inp["problem"])
    out = {}

    def ba(name, mesh, n, p=prob, **kw):
        if rank < n:
            r = sharded_ba.distributed_bundle_adjust(p, mesh, **kw)
            out[name] = {f: r[i].numpy() for i, f in enumerate(r._fields)}

    ba("auto2", meshes[2], 2, n_iters=10)
    ba("auto4", meshes[4], 4, n_iters=10)
    ba("dense4", meshes[4], 4, n_iters=10, solver="dense")
    ba("cg4_tight", meshes[4], 4, n_iters=10, solver="cg", max_cg_iters=300, cg_rtol=1e-13)
    for n in (1, 2, 4):
        ba(f"shards{n}", meshes[n], n, n_iters=5)
    ba("mesh22", mesh22, 4, n_iters=5)
    ba("sparse4", meshes[4], 4, p=_port_problem(inp["sparse"]), n_iters=40, solver="cg",
       max_cg_iters=60, cg_rtol=1e-8)
    ba("golden4", meshes[4], 4, p=_port_problem(inp["golden"]), n_iters=15)
    if rank < 2:
        r = sharded_pose_graph.distributed_optimize(_port_graph(inp["graph"]), meshes[2],
                                                    n_iters=20, max_cg_iters=300, rtol=1e-13)
        out["pg2"] = {f: r[i].numpy() for i, f in enumerate(r._fields)}
    comm = _port_problem(inp["comm"])
    for solver in ("cg", "dense"):
        fn, args, _ = sharded_ba.build_sharded_fn(comm, meshes[4], n_iters=2, solver=solver,
                                                  max_cg_iters=8)
        with distributed.record_collectives() as rec:
            fn(*args)
        out[f"comm_{solver}"] = rec
    with distributed.record_collectives() as rec:
        sharded_ba.distributed_bundle_adjust(comm, meshes[4], n_iters=2, solver="cg", max_cg_iters=8)
    out["comm_full"] = rec
    x = torch.arange(48).reshape(8, 6)
    out["placement"] = {name: distributed.put_global(x, place).numpy() for name, place in (
        ("model4", distributed.model_sharded(meshes[4])),
        ("model22", distributed.model_sharded(mesh22)),
        ("replicated", distributed.replicated(meshes[4])))}
    return out


def multihost_rank() -> None:
    """One process of `tests/test_torch_multihost.py`: `initialize` from the
    MSLAM_* variables, the same seeded problem on every process (the shape
    of the reference's multi-process smoke: 8 frames, 1024 points, 256
    observations per frame), 4 LM iterations of the sharded CG solver over
    the global mesh; prints one JSON report line."""
    import json

    from monocular_slam_tpu_torch.geometry import se3, so3
    from monocular_slam_tpu_torch.optim.ba import BAProblem
    from monocular_slam_tpu_torch.parallel import distributed, sharded_ba

    torch.set_num_threads(1)
    multi = distributed.initialize(device="cpu")
    F, P, OBS = 8, 1024, 256
    rng = np.random.RandomState(0)
    X = rng.uniform(-10, 10, (P, 3)) + np.array([0.0, 0.0, 20.0])
    k = np.array([500.0, 500.0, 320.0, 240.0])
    f64 = torch.float64
    poses = se3.from_Rt(so3.exp(torch.tensor([[0.0, 0.02 * i, 0.0] for i in range(F)], dtype=f64)),
                        torch.tensor([[-0.2 * i, 0.0, 0.0] for i in range(F)], dtype=f64))
    cam = np.repeat(np.arange(F), OBS)
    pt = rng.randint(0, P, F * OBS)
    Xc = se3.apply(poses[torch.as_tensor(cam)], torch.as_tensor(X[pt]))
    uv = (k[:2] * Xc[:, :2].numpy() / Xc[:, 2:].numpy() + k[2:]) + 0.5 * rng.randn(F * OBS, 2)
    fixed = np.zeros(F, bool)
    fixed[0] = True
    prob = BAProblem(
        poses=se3.compose(se3.exp(torch.as_tensor(0.01 * rng.randn(F, 6))), poses),
        points=torch.as_tensor(X + 0.05 * rng.randn(P, 3)), k=torch.as_tensor(np.tile(k, (F, 1))),
        cam_idx=torch.as_tensor(cam), pt_idx=torch.as_tensor(pt), uv=torch.as_tensor(uv),
        info=torch.ones(F * OBS, dtype=torch.float64), valid=torch.ones(F * OBS, dtype=torch.bool),
        fixed=torch.as_tensor(fixed))
    mesh = distributed.global_mesh(device="cpu")
    res = sharded_ba.distributed_bundle_adjust(prob, mesh, n_iters=4, solver="cg")
    print("MULTIHOST_REPORT " + json.dumps({
        "process_id": torch.distributed.get_rank(), "process_count": torch.distributed.get_world_size(),
        "mesh_model": mesh.size(1), "multi": multi, "chi2_initial": float(res.chi2_initial),
        "chi2_final": float(res.chi2_history[-1])}), flush=True)
    torch.distributed.destroy_process_group()


# --- the host-sync checker of the step's CPU tests --------------------------------
# Under `sync_audit()`, every operation that would read a device value on the
# host, or copy host data to the device, in a CUDA run (`.item()`, `bool()`,
# `.tolist()`, `torch.tensor`, indexing with a 0-d tensor or a boolean mask,
# a Python number stored by indexing, `nonzero`, `torch.linalg.eigh`, ...)
# raises, so a CPU test can show that a function has no host round trip and
# can be captured into a CUDA graph.

_HOST_READS = {
    torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.cpu,
    torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.__float__,
    torch.Tensor.__index__,
}
_SYNC_OPS = {
    "aten._local_scalar_dense", "aten.lift_fresh", "aten.nonzero", "aten.masked_select",
    "aten.masked_scatter", "aten.masked_scatter_", "aten._unique", "aten._unique2",
    "aten.unique_dim", "aten.unique_consecutive", "aten.bincount", "aten.histc",
    "aten.is_nonzero", "aten.equal", "aten.allclose", "aten.linalg_eigh", "aten._linalg_eigh",
    "aten.linalg_eig", "aten.linalg_svd", "aten._linalg_svd", "aten.linalg_svdvals", "aten.linalg_cholesky",
    "aten.linalg_inv", "aten.linalg_solve", "aten.cholesky", "aten.inverse",
}
_CHECK_ERRORS_OPS = {
    "aten.linalg_cholesky_ex", "aten.linalg_inv_ex", "aten._linalg_solve_ex",
    "aten.linalg_lu_factor_ex", "aten.linalg_ldl_factor_ex",
}


class HostSyncError(RuntimeError):
    pass


def _where() -> str:
    for fr in reversed(traceback.extract_stack()[:-3]):
        if "monocular_slam_tpu_torch" in fr.filename and not fr.filename.endswith("graph.py"):
            return f"{fr.filename.split('monocular_slam_tpu_torch/')[-1]}:{fr.lineno}"
    return "?"


class _Audit:
    def __init__(self, raise_on_sync: bool):
        self.raise_on_sync = raise_on_sync
        self.events: list[tuple[str, str]] = []
        self.scalar_store = 0

    def hit(self, what: str):
        ev = (what, _where())
        self.events.append(ev)
        if self.raise_on_sync:
            raise HostSyncError(f"{what} at {ev[1]} would synchronise with the host on a card")


class _FnMode(TorchFunctionMode):
    def __init__(self, audit: _Audit):
        super().__init__()
        self.audit = audit

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _HOST_READS:
            self.audit.hit(f"Tensor.{func.__name__}")
        if func is torch.Tensor.__setitem__ and not torch.is_tensor(args[2]):
            # a Python number stored by indexing: on a card torch makes it a
            # host scalar tensor and copies it to the selected element (a
            # copy a capture refuses)
            self.audit.hit("Tensor.__setitem__ of a Python number")
            self.audit.scalar_store += 1
            try:
                return func(*args, **(kwargs or {}))
            finally:
                self.audit.scalar_store -= 1
        return func(*args, **(kwargs or {}))


class _DispatchMode(TorchDispatchMode):
    def __init__(self, audit: _Audit):
        super().__init__()
        self.audit = audit

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket) if hasattr(func, "overloadpacket") else str(func)
        if name == "aten.lift_fresh" and self.audit.scalar_store:
            pass
        elif name in _SYNC_OPS:
            self.audit.hit(name)
        elif name in _CHECK_ERRORS_OPS and kwargs.get("check_errors", False):
            self.audit.hit(f"{name}(check_errors=True)")
        elif name == "aten.segment_reduce" and not kwargs.get("unsafe", False):
            self.audit.hit("aten.segment_reduce(unsafe=False)")
        elif name == "aten.repeat_interleave" and torch.is_tensor(args[0]) and \
                kwargs.get("output_size") is None and len(args) == 1:
            self.audit.hit("aten.repeat_interleave(repeats tensor)")
        elif name in ("aten.index", "aten.index_put", "aten.index_put_", "aten._index_put_impl_"):
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(t is not None and t.dtype in (torch.bool, torch.uint8) for t in idx):
                self.audit.hit(f"{name} with a boolean mask")
        return func(*args, **kwargs)


@contextlib.contextmanager
def sync_audit(raise_on_sync: bool = True):
    """Within: any operation that would synchronise a CUDA run with the host
    raises `HostSyncError` naming the port's source line (or, with
    `raise_on_sync=False`, is recorded in the yielded object's `events`)."""
    audit = _Audit(raise_on_sync)
    with _FnMode(audit), _DispatchMode(audit):
        yield audit

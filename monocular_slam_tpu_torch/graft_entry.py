"""Driver entry points of the port (the counterpart of `__graft_entry__.py`).

entry():             (fn, example_args): one tracking step of the flagship
                     workload (`tracker.track`: PnP, association,
                     triangulation) over a populated, bootstrapped SlamState.
dryrun_multichip(n): ONE distributed bundle-adjustment run of 2 LM
                     iterations (linearize -> Schur sums over the ranks ->
                     replicated solve -> landmark back-substitution) over a
                     mesh of n ranks on tiny shapes: NCCL in this process at
                     n = 1 on the card, gloo ranks otherwise
                     (`benchmarks.spawn_world`).

Both take the reference's inputs from the same threefry keys
(`utils/prng.py`) and run on the card unless given `device="cpu"`.

    python -m monocular_slam_tpu_torch.graft_entry [--device cpu] [--ranks N]
"""

from __future__ import annotations

import argparse
import sys

import torch


def _tiny_state(device="cuda"):
    """The reference's populated state: `feature_sequence(PRNGKey(0))`'s 6
    frames of 128 features (300 world points) ingested, their ground-truth
    poses set and valid; max_frames 8, max_points 512. Returns (cfg, state)."""
    from monocular_slam_tpu_torch.benchmarks.compile_profile import base_state
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig

    cfg = SlamConfig(max_frames=8, max_points=512, frontend=FrontendConfig(n_features=128))
    st, _ = base_state(cfg, 6, 128, device, n_world_points=300, pix_noise=0.2, drop_prob=0.05)
    return cfg, st


def entry(device="cuda"):
    """(fn, example_args): `fn(state, key) -> (poses, n_pnp_inliers)` is one
    `tracker.track` of frame 3 on the 6-frame state bootstrapped from
    `PRNGKey(1)`; the example key is `PRNGKey(2)`."""
    from monocular_slam_tpu_torch.slam import tracker
    from monocular_slam_tpu_torch.utils import prng
    from monocular_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg, st = _tiny_state(dev)
    with torch.inference_mode():
        st = tracker.bootstrap(st, prng.PRNGKey(1), cfg).state

    def fn(state, key):
        with torch.inference_mode():
            res = tracker.track(state, torch.tensor(3, device=state.poses.device), key, cfg)
        return res.state.poses, res.n_pnp_inliers

    return fn, (st, prng.PRNGKey(2))


def dryrun_problem(device="cuda"):
    """The reference's tiny BA problem: F = 4 cameras, P = 64 points in
    [-2, 2]^3 + (0, 0, 5) (key 0) seen by every camera, poses perturbed by
    0.01-sigma twists (key 1; camera 0 exact and fixed), points by 0.05 m
    (key 2)."""
    from monocular_slam_tpu_torch.benchmarks.scaling import orbit_poses, synthetic_ba
    from monocular_slam_tpu_torch.utils import prng

    dev = torch.device(device)
    F, P = 4, 64

    def draw(fn, key, *a, **kw):
        return torch.as_tensor(fn(prng.PRNGKey(key), *a, **kw), device=dev)

    X = draw(prng.uniform, 0, (P, 3), minval=-2, maxval=2) + torch.tensor([0, 0, 5.0],
                                                                          device=dev)
    return synthetic_ba(torch.tensor([300.0, 300.0, 160.0, 120.0], device=dev),
                        orbit_poses(F, 0.1, 0.3, dev), X,
                        torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(P),
                        torch.arange(P, dtype=torch.int32, device=dev).repeat(F), None,
                        0.01 * draw(prng.normal, 1, (F, 6)),
                        0.05 * draw(prng.normal, 2, tuple(X.shape)))


def dryrun_rank(rank: int, n_devices: int, device: str) -> dict:
    """One rank of `dryrun_multichip`: the (data, model) mesh of the
    reference (data 2 when n_devices is even and >= 4), 2 LM iterations;
    asserts a finite chi2 history that does not rise."""
    import torch.distributed as dist

    from monocular_slam_tpu_torch.parallel import sharded_ba
    from monocular_slam_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(device)
    data = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    mesh = make_mesh(n_devices, data=data, device=dev.type)
    with torch.inference_mode():
        res = sharded_ba.distributed_bundle_adjust(dryrun_problem(dev), mesh, n_iters=2)
    hist = res.chi2_history.cpu()
    assert torch.isfinite(hist).all(), hist
    assert float(hist[-1]) <= float(res.chi2_initial), (float(res.chi2_initial), hist)
    return {"rank": rank, "backend": dist.get_backend(mesh.get_group("model")),
            "mesh": list(mesh.mesh.shape), "chi2_initial": float(res.chi2_initial),
            "chi2_history": hist.numpy(), "poses": res.poses.cpu().numpy()}


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """`dryrun_rank` over n_devices ranks; each rank's dict."""
    from monocular_slam_tpu_torch.benchmarks import nccl_world1, spawn_world
    from monocular_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices == 1:
        with nccl_world1():
            return [dryrun_rank(0, 1, str(dev))]
    return spawn_world(n_devices, "monocular_slam_tpu_torch.graft_entry:dryrun_rank",
                       {"n_devices": n_devices, "device": str(dev)}, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks of the dry run (default: the card count, or 2 on the CPU)")
    args = p.parse_args(argv)
    fn, ex = entry(args.device)
    poses, n_inl = fn(*ex)
    print("entry ok:", tuple(poses.shape), "inliers", int(n_inl))
    n = args.ranks or (torch.cuda.device_count() if torch.device(args.device).type == "cuda"
                       else 2)
    ranks = dryrun_multichip(n, args.device)
    print("dryrun_multichip ok:", n, "ranks, chi2", ranks[0]["chi2_initial"], "->",
          float(ranks[0]["chi2_history"][-1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

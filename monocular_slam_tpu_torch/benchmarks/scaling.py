"""Distributed-BA scaling on the card (the counterpart of
`benchmarks/scaling.py`, whose JSON keys it writes): LM iterations a second
of the landmark-sharded global BA (`parallel/sharded_ba.py`) at 1..N
shards, dense and CG, on the reference's problem drawn from the same
threefry keys (`utils/prng.py`): F = 32 cameras, P = 20,000 points, 1500
observations a camera, 10 LM iterations.

A shard is a rank of `torch.distributed`. On the CPU every shard count is
a world of gloo ranks (`benchmarks.spawn_world`, one intra-op thread a
rank). On the card world size 1 is NCCL in this process, and 2 and 4 are
gloo ranks sharing the one card (NCCL refuses two ranks on one device), so
absolute scaling needs several cards. Each solve's all-reduces are counted
by `distributed.record_collectives`: the CG route sums ONE (F, 6) float32
vector a PCG step, `cg_comm_bytes_per_iter(F)` = 4 * 6 * F bytes.

    python -m monocular_slam_tpu_torch.benchmarks.scaling [--shards 1 2 4] [--out F] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from monocular_slam_tpu_torch.benchmarks import (device_label, nccl_world1, spawn_world,
                                                  sync)

SOLVERS = ("dense", "cg")


def cg_comm_bytes_per_iter(n_frames: int) -> int:
    """Bytes one PCG step of the sharded CG route all-reduces: one (F, 6)
    float32 vector, independent of the landmark count."""
    return 4 * 6 * n_frames


def orbit_poses(F: int, yaw_step: float, x_step: float, device) -> torch.Tensor:
    """(F, 3, 4) world->camera poses: yaw 0, yaw_step, ... and translation
    (-x_step i, 0, 0), each made in float32 as the reference makes it."""
    from monocular_slam_tpu_torch.geometry import se3, so3

    dev = torch.device(device)
    return torch.stack([se3.from_Rt(so3.exp(torch.tensor([0.0, yaw_step * i, 0.0], device=dev)),
                                    torch.tensor([-x_step * i, 0.0, 0.0], device=dev))
                        for i in range(F)])


def synthetic_ba(k, poses, X, cam_idx, pt_idx, uv_noise, twists, X_noise,
                 exact_cam0: bool = True):
    """The drivers' synthetic BA problem from its draws: X[pt_idx] seen by
    poses[cam_idx] through k, plus `uv_noise` (None: exact); the poses
    perturbed by exp(`twists`), camera 0 left exact with `exact_cam0`, and
    fixed; the points perturbed by `X_noise`. Each driver draws its
    reference's keys and sizes and passes them here."""
    from monocular_slam_tpu_torch.geometry import camera, se3
    from monocular_slam_tpu_torch.optim.ba import BAProblem

    dev = X.device
    F, E = poses.shape[0], pt_idx.shape[0]
    uv = camera.project(k, se3.apply(poses[cam_idx.long()], X[pt_idx.long()]))
    if uv_noise is not None:
        uv = uv + uv_noise
    poses0 = se3.compose(se3.exp(twists), poses)
    if exact_cam0:
        poses0[0] = poses[0]
    fixed = torch.zeros(F, dtype=torch.bool, device=dev)
    fixed[0] = True
    return BAProblem(poses=poses0, points=X + X_noise, k=k.expand(F, 4).contiguous(),
                     cam_idx=cam_idx, pt_idx=pt_idx, uv=uv, info=torch.ones(E, device=dev),
                     valid=torch.ones(E, dtype=torch.bool, device=dev), fixed=fixed)


def ba_problem(frames: int = 32, points: int = 20000, obs_per_frame: int = 1500, device="cuda"):
    """The reference driver's global-BA problem from the same keys:
    points uniform in [-10, 10]^3 + (0, 0, 20) (key 0), observation points
    by `randint` (key 1), 0.5 px normal noise (key 2), poses perturbed by
    0.005-sigma twists (key 3; camera 0 exact and fixed), points by 0.05 m
    (key 4)."""
    from monocular_slam_tpu_torch.utils import prng

    dev = torch.device(device)
    F, P, E = frames, points, frames * obs_per_frame

    def draw(fn, key, *a, **kw):
        return torch.as_tensor(fn(prng.PRNGKey(key), *a, **kw), device=dev)

    X = draw(prng.uniform, 0, (P, 3), minval=-10, maxval=10) + torch.tensor([0, 0, 20.0],
                                                                            device=dev)
    cam_idx = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(obs_per_frame)
    return synthetic_ba(torch.tensor([500.0, 500.0, 320.0, 240.0], device=dev),
                        orbit_poses(F, 0.02, 0.3, dev), X, cam_idx,
                        draw(prng.randint, 1, (E,), 0, P), 0.5 * draw(prng.normal, 2, (E, 2)),
                        0.005 * draw(prng.normal, 3, (F, 6)),
                        0.05 * draw(prng.normal, 4, tuple(X.shape)))


def solve_rank(rank: int, world: int, frames: int, points: int, obs_per_frame: int, iters: int,
               n_rep: int, device: str, solvers=SOLVERS, max_cg_iters: int = 100) -> dict:
    """One rank's part of a world of `world` shards: the problem, then per
    solver a warm-up call and `n_rep` timed calls of
    `distributed_bundle_adjust` (the mean), and one more call under
    `record_collectives`. Returns per solver the seconds a call, chi2
    initial and history, poses, and the all-reduce records."""
    from monocular_slam_tpu_torch.parallel import distributed, sharded_ba
    from monocular_slam_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device(device)
    prob = ba_problem(frames, points, obs_per_frame, dev)
    mesh = make_mesh(world, device=dev.type)
    out = {"rank": rank}
    for solver in solvers:
        def call():
            return sharded_ba.distributed_bundle_adjust(prob, mesh, n_iters=iters, solver=solver,
                                                        max_cg_iters=max_cg_iters)

        with torch.inference_mode():
            call()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(n_rep):
                res = call()
            sync(dev)
            dt = (time.perf_counter() - t0) / n_rep
            with distributed.record_collectives() as rec:
                call()
        out[solver] = {"s": dt, "chi2_initial": float(res.chi2_initial),
                       "chi2_history": res.chi2_history.cpu().numpy(),
                       "poses": res.poses.cpu().numpy(), "collectives": list(rec)}
    return out


def solve_world(world: int, device="cuda", **kw) -> list:
    """`solve_rank` on every rank of a world of `world` shards (see the
    module's docstring for where the ranks run); each rank's dict."""
    dev = torch.device(device)
    kw = dict(kw, world=world, device=str(dev))
    if dev.type == "cuda" and world == 1:
        with nccl_world1():
            return [solve_rank(0, **kw)]
    return spawn_world(world, "monocular_slam_tpu_torch.benchmarks.scaling:solve_rank", kw, dev)


def pcg_bytes(collectives: list, n_frames: int) -> list:
    """The bytes of each PCG step's all-reduce in one CG solve's records:
    the (F, 6) sums of the LM loop (the final gather excluded)."""
    return [c["bytes"] for c in collectives if c["label"] != "gather"
            and c["elements"] == 6 * n_frames]


def run(frames: int = 32, points: int = 20000, obs_per_frame: int = 1500, iters: int = 10,
        shards=None, device="cuda", n_rep: int = 3, details: dict | None = None) -> dict:
    """The reference driver's measurement under its keys; each world's
    rank dicts go into `details` (by shard count) when given."""
    from monocular_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    shards = list(shards or (1, 2, 4))
    n_cores = os.cpu_count() or 1
    results = {s: {} for s in SOLVERS}
    for s in shards:
        ranks = solve_world(s, dev, frames=frames, points=points, obs_per_frame=obs_per_frame,
                            iters=iters, n_rep=n_rep)
        if details is not None:
            details[s] = ranks
        for solver in SOLVERS:
            r = ranks[0][solver]
            results[solver][s] = iters / r["s"]
            base = results[solver].get(shards[0])
            print(f"[{solver}] shards={s}: {r['s'] * 1e3:7.1f} ms / {iters} LM iters -> "
                  f"{iters / r['s']:7.1f} iters/s  speedup={iters / r['s'] / base:.2f}, chi2 "
                  f"{r['chi2_initial']:.6g} -> {float(r['chi2_history'][-1]):.6g}",
                  file=sys.stderr, flush=True)
    cpu = dev.type == "cpu"
    return {
        "metric": "distributed BA LM iters/sec by shard count",
        "frames": frames, "points": points, "edges": frames * obs_per_frame,
        "results": {sol: {str(k): v for k, v in r.items()} for sol, r in results.items()},
        "physical_cores": n_cores,
        "one_thread_per_device": cpu,
        "crossover_note": (
            "dense's per-LM-iteration collective is the full (F*6)^2 reduced system summed over "
            "the ranks - O(F^2) bytes per rank per iteration, while CG's one (F,6) sum per PCG "
            "step scales; distributed_bundle_adjust(solver='auto') picks dense <= 2 shards, cg "
            "beyond (the reference's measured crossover)"),
        "note": (
            "a shard is a torch.distributed rank: gloo ranks on the CPU, one intra-op thread "
            "each; on the card NCCL at 1 rank and gloo ranks sharing the one card at 2+ (NCCL "
            "refuses two ranks on one device), so these are not multi-card scaling numbers"
            if not cpu else
            "a shard is a gloo rank on the CPU with one intra-op thread; ranks share the "
            "host's cores, so speedup beyond the core count is impossible by construction"),
        "devices": device_label(dev),
        "cg_comm_model": {
            "bytes_per_cg_iter_per_direction": cg_comm_bytes_per_iter(frames),
            "formula": "4 * 6 * F (one (F,6) f32 all-reduce per PCG step; no F^2 or P terms)",
            "hlo_check": "distributed.record_collectives (tests/test_torch_scaling.py)",
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--points", type=int, default=20000)
    p.add_argument("--obs-per-frame", type=int, default=1500)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--shards", type=int, nargs="*", default=None)
    p.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU (--device cpu)")
    p.add_argument("--one-thread-per-device", action="store_true",
                   help="accepted for the reference's command line: CPU ranks always take one "
                        "intra-op thread")
    p.add_argument("--out", default=None, help="write the JSON here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = run(args.frames, args.points, args.obs_per_frame, args.iters, args.shards,
              "cpu" if args.cpu else args.device)
    s = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(json.dumps(out, indent=1) + "\n")
    print(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())

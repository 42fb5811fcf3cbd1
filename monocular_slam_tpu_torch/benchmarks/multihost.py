"""Multi-process distributed global BA on the card (the counterpart of
`benchmarks/multihost.py`, whose `multihost_r0*.json` keys it writes).

Parent mode (no `--process-id` and no MSLAM_PROCESS_ID): starts
`--num-processes` copies of this module on localhost with
MSLAM_COORDINATOR / MSLAM_NUM_PROCESSES / MSLAM_PROCESS_ID set, as a
launcher starts one process a host, waits, and prints their merged reports.

Child mode: `parallel.distributed.initialize()` from those variables
(gloo; CUDA tensors on the card, reduced through host memory, or the CPU
with `--device cpu`), the SAME seeded problem on every process (the
reference's draws from `PRNGKey(0)`'s three subkeys, `utils/prng.py`),
`distributed_bundle_adjust` over the global mesh, one warm-up and one timed
call a solver, and one `MULTIHOST_REPORT {...}` line. Each child asserts,
as the reference's does, that chi2 went down.

    python -m monocular_slam_tpu_torch.benchmarks.multihost --num-processes 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from monocular_slam_tpu_torch.benchmarks import sync

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPORT = "MULTIHOST_REPORT "


def ba_problem(frames: int = 32, points: int = 20000, obs_per_frame: int = 1500,
               device="cuda"):
    """The reference child's problem: kx, kn, kp = split(PRNGKey(0), 3);
    points uniform in [-10, 10]^3 + (0, 0, 20) from kx, observation points
    by `randint` from kp, 0.5 px noise and 0.01-sigma pose twists from kn
    (camera 0 perturbed too, and fixed), points perturbed by 0.05 m from
    kx."""
    from monocular_slam_tpu_torch.benchmarks.scaling import orbit_poses, synthetic_ba
    from monocular_slam_tpu_torch.utils import prng

    dev = torch.device(device)
    F, P, E = frames, points, frames * obs_per_frame
    kx, kn, kp = prng.split(prng.PRNGKey(0), 3)

    def draw(fn, key, *a, **kw):
        return torch.as_tensor(fn(key, *a, **kw), device=dev)

    X = draw(prng.uniform, kx, (P, 3), minval=-10, maxval=10) + torch.tensor([0, 0, 20.0],
                                                                             device=dev)
    cam_idx = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(obs_per_frame)
    return synthetic_ba(torch.tensor([500.0, 500.0, 320.0, 240.0], device=dev),
                        orbit_poses(F, 0.02, 0.2, dev), X, cam_idx,
                        draw(prng.randint, kp, (E,), 0, P), 0.5 * draw(prng.normal, kn, (E, 2)),
                        0.01 * draw(prng.normal, kn, (F, 6)),
                        0.05 * draw(prng.normal, kx, tuple(X.shape)), exact_cam0=False)


def child(args) -> dict:
    """One process of the run: initialize, solve, report."""
    import torch.distributed as dist

    from monocular_slam_tpu_torch.parallel import distributed, sharded_ba
    from monocular_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    multi = distributed.initialize(device=dev, backend="gloo")
    prob = ba_problem(args.frames, args.points, args.obs_per_frame, dev)
    mesh = distributed.global_mesh(device=dev.type)
    report = {
        "process_id": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "global_devices": dist.get_world_size(),  # one device a process
        "mesh_model": mesh.size(1),
        "multi": bool(multi),
    }
    for solver in args.solvers:
        with torch.inference_mode():
            sharded_ba.distributed_bundle_adjust(prob, mesh, n_iters=args.iters, solver=solver)
            sync(dev)
            t0 = time.perf_counter()
            res = sharded_ba.distributed_bundle_adjust(prob, mesh, n_iters=args.iters,
                                                       solver=solver)
            sync(dev)
            dt = time.perf_counter() - t0
        report[solver] = {"iters_per_sec": args.iters / dt,
                          "chi2_initial": float(res.chi2_initial),
                          "chi2_final": float(res.chi2_history[-1])}
        assert report[solver]["chi2_final"] < report[solver]["chi2_initial"], solver
    print(REPORT + json.dumps(report), flush=True)
    dist.destroy_process_group()
    return report


def run(num_processes: int = 2, frames: int = 32, points: int = 20000,
        obs_per_frame: int = 1500, iters: int = 10, solvers=("dense", "cg"), device="cuda",
        timeout: int = 900, port: int | None = None) -> dict:
    """The parent: `num_processes` children on localhost, rendezvous on
    `port` or else through a file in a fresh temporary directory; returns
    {"ok", "reports"} (reports in process order). Every child is waited
    for, and killed if it outlives `timeout`."""
    from monocular_slam_tpu_torch.utils.device import resolve_device

    resolve_device(device)  # raises without a card when one is asked for
    tmp = tempfile.mkdtemp(prefix="mslam_multihost_")
    coordinator = f"localhost:{port}" if port else f"file://{tmp}/rendezvous"
    env0 = dict(os.environ, MSLAM_COORDINATOR=coordinator,
                MSLAM_NUM_PROCESSES=str(num_processes),
                PYTHONPATH=os.pathsep.join([ROOT] + [
                    p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    cmd = [sys.executable, "-m", "monocular_slam_tpu_torch.benchmarks.multihost",
           "--frames", str(frames), "--points", str(points), "--obs-per-frame", str(obs_per_frame), "--iters", str(iters), "--device", str(device),
           "--solvers", *solvers]
    procs = [subprocess.Popen(cmd, env=dict(env0, MSLAM_PROCESS_ID=str(pid)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(num_processes)]
    reports, ok = [], True
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                ok = False
                sys.stderr.write(out[-4000:])
            reports += [json.loads(x[len(REPORT):]) for x in out.splitlines()
                        if x.startswith(REPORT)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    reports.sort(key=lambda r: r["process_id"])
    return {"ok": ok and len(reports) == num_processes, "reports": reports}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--points", type=int, default=20000)
    p.add_argument("--obs-per-frame", type=int, default=1500)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--local-devices", type=int, default=1,
                   help="devices a process: one (a rank drives one device)")
    p.add_argument("--solvers", nargs="*", default=["dense", "cg"])
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--timeout", type=int, default=900)
    p.add_argument("--out", default=None, help="write the merged JSON here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.process_id is not None:  # a child started by hand
        os.environ["MSLAM_PROCESS_ID"] = str(args.process_id)
        os.environ["MSLAM_NUM_PROCESSES"] = str(args.num_processes)
        if args.coordinator:
            os.environ["MSLAM_COORDINATOR"] = args.coordinator
    if "MSLAM_PROCESS_ID" in os.environ:
        child(args)
        return 0
    out = run(args.num_processes, args.frames, args.points, args.obs_per_frame, args.iters,
              args.solvers, args.device, args.timeout, args.port)
    s = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(s + "\n")
    print(s)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

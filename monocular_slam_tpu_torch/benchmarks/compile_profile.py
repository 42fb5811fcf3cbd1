"""Cold against steady time of every program the session runs, on the card
(the counterpart of `benchmarks/compile_profile.py`, whose
`compile_profile_tpu.json` keys it writes).

Each of the reference's nine programs (extraction of a 640x480 image, a
frame's feature ingest, the bootstrap, `tracker.track`, the windowed local
BA, fuse, point culling, the frame overlap and the session step) runs on
the same 12-frame state (`feature_sequence(PRNGKey(0))`'s frames ingested,
their ground-truth poses valid, key `PRNGKey(1)`) as a CUDA graph
(`benchmarks.Replayed`, without chaining): `cold_s` is its first call,
the capture (a warm-up run, then the capture) and one replay, which also
pays the kernels' nvcc builds (K1, K2, K3) when the build directory is
fresh; `steady_ms` is the mean of 5 replays. `--build-dir` is the
reference's `--cache`: by default a fresh temporary directory, removed at
the end, so the run is a true cold start (the native decoder `native/slamio.cpp` is built
there too, timed on its own). On the CPU the programs run op by op. The
graph nodes of each program (device operations of one replay, by
`torch.profiler`) go to stderr, not into the JSON.

    python -m monocular_slam_tpu_torch.benchmarks.compile_profile [--build-dir D] [--out F] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from monocular_slam_tpu_torch.benchmarks import Replayed, device_label, device_ops, sync

N_STEADY = 5


def base_state(cfg, n_frames: int, n_feat: int, device, n_world_points: int = 2500, **seq_kw):
    """(state, seq): `feature_sequence(PRNGKey(0), ..., **seq_kw)`'s frames
    ingested into slots 0..n_frames-1 of an empty state, their ground-truth
    poses set and valid (the reference's state)."""
    from monocular_slam_tpu_torch.datasets import synthetic
    from monocular_slam_tpu_torch.slam import state as state_mod
    from monocular_slam_tpu_torch.utils import prng

    seq = synthetic.feature_sequence(prng.PRNGKey(0), n_frames=n_frames,
                                     n_world_points=n_world_points, n_features=n_feat,
                                     device=device, **seq_kw)
    st = state_mod.empty_state(cfg, device=device)
    for i, f in enumerate(seq.frames):
        st = state_mod.add_frame_features(st, i, i, f.uv, f.scale, f.valid, f.desc, f.desc_pm1,
                                          seq.k)
    poses, valid = st.poses.clone(), st.pose_valid.clone()
    poses[:n_frames] = torch.as_tensor(seq.poses_gt, dtype=poses.dtype, device=poses.device)
    valid[:n_frames] = True
    return st._replace(poses=poses, pose_valid=valid), seq


def programs(cfg, st, seq, device, wh=(640, 480)) -> dict:
    """name -> (fn(inputs) -> outputs, inputs): the reference's nine
    programs on frame i = n - 1 (the overlap against frame i - 6, the
    session step with last keyframe i - 6)."""
    from monocular_slam_tpu_torch.benchmarks.step_profile import session_step_fn
    from monocular_slam_tpu_torch.ops import features as features_mod
    from monocular_slam_tpu_torch.slam import local_ba, mapping, state as state_mod, tracker
    from monocular_slam_tpu_torch.utils import prng

    dev = torch.device(device)
    n = len(seq.frames)
    key = prng.PRNGKey(1)
    W, H = wh
    img = torch.as_tensor(prng.uniform(key, (H, W)), device=dev) * 255.0
    fe, m = cfg.frontend, cfg.mapping
    i = torch.tensor(n - 1, device=dev)
    j = torch.tensor(n - 7, device=dev)
    lk = torch.tensor(n - 7, dtype=torch.int32, device=dev)
    f0, f1 = torch.tensor(0, device=dev), torch.tensor(1, device=dev)
    words = prng.key_on(key, dev)
    pnp_key = prng.key_on(prng.split(key)[0], dev)
    fr = seq.frames[0]
    k = torch.as_tensor(seq.k, dtype=torch.float32, device=dev)  # no host copy in a capture
    step: dict = {}

    def session_step(s):
        if "fn" not in step:  # the branch is read at the program's first call, in its cold time
            step["fn"] = session_step_fn(cfg, st, i, lk, pnp_key)[0]
        return step["fn"](s)

    return {
        "extract_640x480": (lambda im: features_mod.extract(
            im, n_features=fe.n_features, n_levels=fe.n_levels,
            fast_threshold=fe.fast_threshold), img),
        "add_feats": (lambda s: state_mod.add_frame_features(
            s, i, i, fr.uv, fr.scale, fr.valid, fr.desc, fr.desc_pm1, k), st),
        "bootstrap": (lambda s: tracker.bootstrap(s, words, cfg, f0, f1), st),
        "track": (lambda s: tracker.track(s, i, None, cfg, pnp_key=pnp_key), st),
        "local_ba": (lambda s: local_ba.local_bundle_adjust(s, i, cfg), st),
        "fuse": (lambda s: mapping.fuse(s, i, radius_px=m.fuse_radius_px,
                                        max_hamming=m.fuse_max_hamming, image_wh=cfg.image_wh),
                 st),
        "cull": (lambda s: mapping.cull_points(s, i, min_obs=m.cull_min_obs, grace=m.cull_grace),
                 st),
        "overlap": (lambda s: mapping.frame_overlap(s, i, j), st),
        "session_step": (session_step, st),
    }


def run(device="cuda", n_feat: int = 1000, build_dir: str | None = None, cfg=None,
        n_frames: int = 12, max_frames: int = 64, max_points: int = 20000,
        details: dict | None = None) -> dict:
    """The profile under the reference driver's keys (`cache_dir` holds the
    build directory). `details`, when given, receives per program the
    kernels' launches over its steady replays, its graph nodes (on the
    card), its outputs, the programs' input state and the native decoder's
    build seconds."""
    from monocular_slam_tpu_torch import native
    from monocular_slam_tpu_torch.ops import launches
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.utils import cuda_build, graph
    from monocular_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    fresh = build_dir is None
    build_dir = build_dir or tempfile.mkdtemp(prefix="mslam_coldbuild_")
    prev = cuda_build.use_build_dir(build_dir)
    label = device_label(dev)
    print("device:", label, " build dir:", build_dir, file=sys.stderr)
    det = details if details is not None else {}
    try:
        t0 = time.perf_counter()
        native.build()
        det["native_build_s"] = time.perf_counter() - t0
        cfg = cfg or SlamConfig(max_frames=max_frames, max_points=max_points,
                                frontend=FrontendConfig(n_features=n_feat))
        st, seq = base_state(cfg, n_frames, cfg.frontend.n_features, dev)
        det["state"] = st
        out = {"device": label, "cache_dir": build_dir, "n_feat": cfg.frontend.n_features,
               "programs": {}}
        total_cold = 0.0
        cuda = dev.type == "cuda"
        for name, (fn, inputs) in programs(cfg, st, seq, dev).items():
            sync(dev)
            t0 = time.perf_counter()
            prog = Replayed(fn, inputs, dev, chain=False)
            r = prog.step()
            sync(dev)
            cold = time.perf_counter() - t0
            if cuda:
                launches.reset()
            t0 = time.perf_counter()
            for _ in range(N_STEADY):
                r = prog.step()
            sync(dev)
            steady = (time.perf_counter() - t0) / N_STEADY
            total_cold += cold
            out["programs"][name] = {"cold_s": cold, "steady_ms": steady * 1e3}
            det[name] = {"replays": N_STEADY, "launches": launches.read() if cuda else None,
                         "nodes": device_ops(prog.step, dev) if cuda else None,
                         "outputs": graph.cloned(r)}
            print(f"{name:16s} cold {cold:7.2f}s  steady {steady * 1e3:8.2f} ms",
                  file=sys.stderr, flush=True)
        out["total_cold_s"] = total_cold
        if cuda:
            print("graph nodes a program (device operations of one replay): " + json.dumps(
                {n: det[n]["nodes"] for n in out["programs"]}), file=sys.stderr, flush=True)
        return out
    finally:
        cuda_build.use_build_dir(prev)
        if fresh:
            shutil.rmtree(build_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--build-dir", default=None,
                    help="build directory of the kernels and the native decoder (default: a "
                         "fresh temporary one = a true cold start)")
    ap.add_argument("--n-feat", type=int, default=1000)
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device, args.n_feat, args.build_dir)
    s = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(s + "\n")
    print(json.dumps({"total_cold_s": out["total_cold_s"], "written": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

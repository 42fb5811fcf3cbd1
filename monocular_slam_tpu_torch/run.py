"""CLI entry point of the port (counterpart of `monocular_slam_tpu/run.py`).

    python -m monocular_slam_tpu_torch.run --dataset /path/to/rgbd_dataset_freiburg1_xyz \
        --start 0 --end 200 --step 2 --out out/

Runs the full SLAM pipeline on a TUM / KITTI / synthetic sequence on the
card (`--device cpu` runs it on the CPU), writes a TUM-format trajectory, a
PLY point cloud, an offline trajectory plot (skipped where matplotlib is
absent), and, when ground truth exists, prints ATE/RPE in the summary JSON.
The default frame window [0, 200) step 2 mirrors `src/main.cpp:35`.

The reference enables JAX's persistent compilation cache here
(`utils/cache.py`); the port's counterpart is the build cache of
`utils/cuda_build.py` and `native/`, which keeps each compiled kernel and
the PNG decoder under `_build/`, keyed by a hash of its source.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   help="TUM sequence dir, KITTI root, or 'synthetic'")
    p.add_argument("--kitti-seq", default="00")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=200)
    p.add_argument("--step", type=int, default=2)
    p.add_argument("--out", default="out")
    p.add_argument("--features", type=int, default=1000)
    p.add_argument("--max-frames", type=int, default=256)
    p.add_argument("--max-points", type=int, default=30000)
    p.add_argument("--no-ba", action="store_true", help="disable local BA")
    p.add_argument("--loop-closure", action="store_true")
    p.add_argument("--vocab", default=None,
                   help="path to a trained vocabulary npz, or 'default' for the bundled one")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print every frame's outcome and, before the summary, the kernels' "
                        "launch counts")
    p.add_argument(
        "--profile", default=None, metavar="LOGDIR",
        help="capture a torch.profiler trace of the main loop (LOGDIR/trace.json) and the "
             "session's spans on the same clock (LOGDIR/spans.json)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import numpy as np

    from monocular_slam_tpu_torch.eval import ate as ate_mod
    from monocular_slam_tpu_torch.io import ply, trajectory
    from monocular_slam_tpu_torch.ops import launches
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession
    from monocular_slam_tpu_torch.utils.device import resolve_device
    from monocular_slam_tpu_torch.utils.profiling import chrome_base_ns, device_trace

    dev = resolve_device(args.device)
    cfg = SlamConfig(
        max_frames=args.max_frames,
        max_points=args.max_points,
        frontend=FrontendConfig(n_features=args.features),
    )

    lc = None
    if args.loop_closure:
        from monocular_slam_tpu_torch.retrieval import vocabulary as vocab_mod

        if args.vocab == "default":
            voc = vocab_mod.load_default(device=dev)
        elif args.vocab:
            voc = vocab_mod.load(args.vocab, device=dev)
        else:
            print("[run] no --vocab given; training a small vocabulary on the fly")
            voc = None  # trained after the first frames below
        lc = ("pending", voc)

    sess = SlamSession(cfg, seed=args.seed, run_ba=not args.no_ba, device=dev,
                       trace=bool(args.profile))

    # --- dataset ------------------------------------------------------------
    gt_poses = None
    dist = None
    if args.dataset == "synthetic":
        from monocular_slam_tpu_torch.datasets import synthetic
        from monocular_slam_tpu_torch.utils import prng

        seq = synthetic.feature_sequence(
            prng.PRNGKey(args.seed),
            n_frames=min(args.max_frames, (args.end - args.start) // max(args.step, 1)),
            n_features=args.features,
            device=dev,
        )
        frames = [("features", f, seq.k, seq.timestamps[i]) for i, f in enumerate(seq.frames)]
        gt_poses = np.asarray(seq.poses_gt)
    elif os.path.isdir(os.path.join(args.dataset, "sequences")):
        from monocular_slam_tpu_torch.datasets import kitti

        seq = kitti.load(args.dataset, args.kitti_seq, args.start, args.end, args.step)
        frames = [
            ("image", i, seq.k, seq.timestamps[i]) for i in range(len(seq.image_paths))
        ]
        loader = seq.load_image
        gt_poses = seq.poses_gt
    else:
        from monocular_slam_tpu_torch.datasets import tum

        seq = tum.load(args.dataset, args.start, args.end, args.step)
        frames = [
            ("image", i, seq.k, fr.timestamp) for i, fr in enumerate(seq.frames)
        ]
        loader = seq.load_image
        dist = seq.dist
        if all(fr.pose_gt is not None for fr in seq.frames):
            gt_poses = np.stack([fr.pose_gt for fr in seq.frames])

    # --- loop-closure vocabulary on the fly ---------------------------------
    def maybe_attach_loop_closer(i):
        nonlocal lc
        if lc is None or not isinstance(lc, tuple):
            return
        kind, voc = lc
        if voc is None and i == 10:
            from monocular_slam_tpu_torch.retrieval import vocabulary as vocab_mod

            st = sess.state
            slots = [int(st.slot_of[j]) for j in range(min(10, i))]
            desc = np.concatenate(
                [
                    st.desc_pm1[s].cpu().numpy()[st.kp_valid[s].cpu().numpy()]
                    for s in slots
                    if s >= 0
                ]
            )
            voc = vocab_mod.train(desc, k=8, L=3, seed=args.seed, device=dev)
        if voc is not None:
            from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser

            closer = LoopCloser(voc=voc, cfg=cfg, device=dev)
            # replay BoW history for already-ingested KEYFRAMES only — the
            # database discipline the session maintains afterwards
            for j in sess.keyframes:
                if j <= i:
                    closer.add_frame(sess.state, j)
            sess.loop_closer = closer
            lc = closer

    # pay the kernel builds and first-use costs before frame 0
    images = [f for f in frames if f[0] == "image"]
    prewarm_s = sess.prewarm(image=bool(images),
                             image_hw=np.shape(loader(images[0][1]))[:2] if images else None)

    # --- main loop (the reference's per-frame stage loop, main.cpp:48-51) ---
    trace_cm = device_trace(args.profile) if args.profile else contextlib.nullcontext()
    launches.reset()  # the kernels' counts from here on are the frames'
    t0 = time.perf_counter()
    with trace_cm:
        for idx, item in enumerate(frames):
            kind = item[0]
            if kind == "features":
                _, f, k, ts = item
                st = sess.add_frame_features(f, k, ts)
            else:
                _, i_img, k, ts = item
                st = sess.add_frame(loader(i_img), k, ts, dist=dist)
            if args.verbose:
                print(
                    f"[{idx:4d}] tracked={st.tracked} inliers={st.n_inliers} "
                    f"new={st.n_new_points} map={sess.n_map_points}"
                )
            if args.loop_closure and isinstance(lc, tuple):
                maybe_attach_loop_closer(idx)
        sess.flush()
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if args.profile:
        sess.tracer.to_chrome(os.path.join(args.profile, "spans.json"), sess.stats,
                              base_ns=chrome_base_ns(os.path.join(args.profile, "trace.json")))

    # --- outputs ------------------------------------------------------------
    poses, valid, ts = sess.trajectory()
    trajectory.write_tum(os.path.join(args.out, "trajectory.txt"), poses, ts, valid)
    ply.write_ply_points(os.path.join(args.out, "map.ply"), sess.map_points())
    try:
        from monocular_slam_tpu_torch.viz import plots

        plots.plot_trajectory(
            os.path.join(args.out, "trajectory.png"), poses, valid, gt_poses
        )
    except Exception as e:  # viz is best-effort
        print(f"[run] plot skipped: {e}")

    if args.verbose:
        counts, steps = launches.read(), sess.step_launches
        print("[run] kernel launches " + json.dumps({
            "fast_corner_maps_levels": counts["corner_maps"],
            "hamming_top2": counts["hamming_top2"], "small_eigh": counts["small_eigh"],
            "svd3": counts["svd3"], "track_calls": len(steps),
            "k2_per_track_min": min((c["hamming_top2"] for c in steps), default=0),
        }))
    summary = {
        "frames": int(len(frames)),
        "tracked": int(valid.sum()),
        "map_points": int(sess.n_map_points),
        "fps_incl_compile": round(len(frames) / wall, 2),
        "wall_s": round(wall, 1),
        "prewarm_s": round(prewarm_s, 2),
        "device": str(dev),
    }
    if gt_poses is not None:
        r = ate_mod.ate(poses[valid], gt_poses[: len(valid)][valid])
        summary["ate_rmse"] = round(float(r.rmse), 5)
        summary["rpe"] = round(ate_mod.rpe(poses[valid], gt_poses[: len(valid)][valid]), 5)
    if args.loop_closure and not isinstance(lc, tuple) and lc is not None:
        summary["loop_closures"] = getattr(lc, "closures", [])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Stage-by-stage profile of the per-frame hot path on the card (the
counterpart of `benchmarks/step_profile.py`, whose `step_profile_tpu.json`
keys it writes). It separates what one number per program conflates:

  - the per-replay floor: a one-operation captured program (`trivial_*`);
  - chained device time per stage (`*_chained_ms`): the stage captured
    once into a CUDA graph whose last operations copy its output state
    into its static inputs (`Replayed`), replayed n times, one sync at the
    end, the pattern of the flagship bench's fused step;
  - host time alone (`*_dispatch_ms`): n replays with no sync.

The stages, from the reference's warm state (a session over
`synthetic.feature_sequence(PRNGKey(0))`'s 40 frames of 1000 features,
max_frames 64, max_points 20000, seed 1, BA on) at frame i = 39 with the
last keyframe 35 and key `PRNGKey(7)`: extraction of a 640x480 image (K1),
the session step (`track_step`, then the mapping block of the branch its
flags select: one program, as the card's torch has no conditional graph
nodes), `tracker.track` (K2, K3) with and without the local-map search,
the windowed local BA at 10, 5 and 3 LM iterations, fuse, point culling
and a frame's feature ingest; and a pinned host-to-device copy of a
640x480 frame in float32 and uint8 (`img_transfer_*`). On the CPU the
same functions run op by op.

    python -m monocular_slam_tpu_torch.benchmarks.step_profile [--out F] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import warnings

import numpy as np
import torch

from monocular_slam_tpu_torch.benchmarks import Replayed, device_label, sync

TRACK_KEY = 7
IMAGE_KEY = 3


@contextlib.contextmanager
def counted_syncs(device):
    """Host synchronizations inside the block, as `torch.cuda`'s sync debug
    mode reports them (its one-time notice that the mode is a prototype is
    none); yields a list that receives one entry a sync. Nothing on the
    CPU."""
    found: list = []
    if torch.device(device).type != "cuda":
        yield found
        return

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message) and "prototype" not in str(message):
            found.append(f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode("default")


def chained(stage: Replayed, carry0, device, n: int) -> dict:
    """Seconds a link over n chained replays from carry0 with one sync at
    the end (after one first replay, the reference's compiling call, and a
    reset), the kernels' launches in those n replays, the host syncs the
    loop made, and the carry they leave."""
    from monocular_slam_tpu_torch.ops import launches

    dev = torch.device(device)
    stage.step()
    stage.reset(carry0)
    sync(dev)
    cuda = dev.type == "cuda"
    if cuda:
        launches.reset()
    with counted_syncs(dev) as syncs:
        t0 = time.perf_counter()
        for _ in range(n):
            stage.step()
    sync(dev)
    dt = (time.perf_counter() - t0) / n
    return {"s": dt, "replays": n, "launches": launches.read() if cuda else None,
            "syncs": len(syncs), "carry": stage.current()}


def dispatch_only(stage: Replayed, device, n: int) -> float:
    """Host seconds a replay over n replays issued with no sync."""
    stage.step()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        stage.step()
    dt = (time.perf_counter() - t0) / n
    sync(device)
    return dt


def warm_session_state(cfg, n_frames: int, n_feat: int, device, world_points: int = 2500):
    """(state, seq): the reference's warm state, a BA-on session (seed 1)
    over `feature_sequence(PRNGKey(0))`'s frames; the state is a copy."""
    from monocular_slam_tpu_torch.datasets import synthetic
    from monocular_slam_tpu_torch.slam.session import SlamSession
    from monocular_slam_tpu_torch.utils import graph, prng

    seq = synthetic.feature_sequence(prng.PRNGKey(0), n_frames=n_frames,
                                     n_world_points=world_points, n_features=n_feat,
                                     pix_noise=0.3, drop_prob=0.08, device=device)
    sess = SlamSession(cfg, seed=1, run_ba=True, device=device)
    for i, f in enumerate(seq.frames):
        sess.add_frame_features(f, seq.k, seq.timestamps[i])
    sess.flush()
    return graph.cloned(sess.state), seq


def session_step_fn(cfg, state, i, last_kf, pnp_key):
    """The reference's `_session_step` at frame i as ONE capturable
    function of the state: `track_step`, then the mapping block of the
    branch that `track_step`'s flags select on `state` (read here, before
    any capture; on the CPU the block decides for itself, as the
    reference's `lax.cond`s do). Returns (fn, the branch: fuse, BA, cull)."""
    from monocular_slam_tpu_torch.slam import session as sess_mod

    dev = state.poses.device
    if dev.type != "cuda":
        def fn_cpu(st):
            return sess_mod.session_step(st, i, last_kf, pnp_key, cfg, True)[0]

        return fn_cpu, None
    with torch.inference_mode():
        t = sess_mod.track_step(state, i, last_kf, pnp_key, cfg)
        preds = sess_mod.mapping_predicates(int(i), bool(t.ok), bool(t.is_keyframe),
                                            bool(t.run_map), cfg, True)

    def fn(st):
        t = sess_mod.track_step(st, i, last_kf, pnp_key, cfg)
        return sess_mod.mapping_block(t.state, i, preds, cfg)[0]

    return fn, preds


def run(device="cuda", n_feat: int = 1000, max_frames: int = 64, max_points: int = 20000,
        n_frames: int = 40, cfg=None, n: int = 30, n_short: int = 20, n_trivial: int = 50,
        wh=(640, 480), details: dict | None = None) -> dict:
    """The profile under the reference driver's keys. `details`, when
    given, receives per stage the replays, the kernels' launches in them,
    the host syncs of the chained loop and the carry they left (and the
    warm state and the session step's branch)."""
    from monocular_slam_tpu_torch.ops import features as features_mod
    from monocular_slam_tpu_torch.slam import local_ba, mapping, state as state_mod, tracker
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.utils import prng
    from monocular_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    print("device:", label, file=sys.stderr)
    out = {"device": label}
    det = details if details is not None else {}
    cfg = cfg or SlamConfig(max_frames=max_frames, max_points=max_points,
                            frontend=FrontendConfig(n_features=n_feat))
    warm, seq = warm_session_state(cfg, n_frames, cfg.frontend.n_features, dev)
    det["warm_state"] = warm
    key = prng.PRNGKey(TRACK_KEY)
    pnp_key = prng.key_on(prng.split(key)[0], dev)
    i = torch.tensor(n_frames - 1, device=dev)
    lkf = torch.tensor(n_frames - 5, dtype=torch.int32, device=dev)

    def measure(name, fn, carry, reps, dispatch=False):
        stage = Replayed(fn, carry, dev)
        r = chained(stage, carry, dev, reps)
        out[f"{name}_chained_ms"] = r["s"] * 1e3
        if dispatch:
            out[f"{name}_dispatch_ms"] = dispatch_only(stage, dev, reps) * 1e3
        det[name] = r
        return stage

    # 1. the per-replay floor: a one-operation program
    x0 = torch.zeros((), device=dev)
    triv = Replayed(lambda x: x.add_(1.0), x0, dev)
    out["trivial_roundtrip_ms"] = chained(triv, x0, dev, n_trivial)["s"] * 1e3
    out["trivial_dispatch_ms"] = dispatch_only(triv, dev, n_trivial) * 1e3

    # 2. extraction, chained through a negligible function of its output
    W, H = wh
    img = torch.as_tensor(prng.uniform(prng.PRNGKey(IMAGE_KEY), (H, W)), device=dev) * 255.0
    fe = cfg.frontend

    def extract(im):
        f = features_mod.extract(im, n_features=fe.n_features, n_levels=fe.n_levels,
                                 fast_threshold=fe.fast_threshold)
        return im + f.uv[0, 0] * 1e-12

    measure("extract", extract, img, n_short, dispatch=True)

    # 3. a pinned host-to-device copy of one frame
    im_f32 = img.cpu().numpy()
    for name, arr in (("f32", im_f32), ("u8", im_f32.astype(np.uint8))):
        host = torch.from_numpy(arr)
        if dev.type == "cuda":
            host = host.pin_memory()
        dst = torch.empty_like(host, device=dev)
        dst.copy_(host, non_blocking=True)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(n_short):
            dst.copy_(host, non_blocking=True)
            sync(dev)
        out[f"img_transfer_{name}_ms"] = (time.perf_counter() - t0) / n_short * 1e3

    # 4. the session step
    step_fn, det["session_step_branch"] = session_step_fn(cfg, warm, i, lkf, pnp_key)
    measure("session_step", step_fn, warm, n, dispatch=True)

    # 5-6. tracking, with and without the local-map search
    def track_with(c):
        return lambda st: tracker.track(st, i, None, c, pnp_key=pnp_key).state

    measure("track", track_with(cfg), warm, n)
    cfg_nolm = dataclasses.replace(cfg, track=dataclasses.replace(cfg.track,
                                                                  track_local_map=False))
    measure("track_no_localmap", track_with(cfg_nolm), warm, n)

    # 7. the windowed local BA at three iteration counts
    for iters in (10, 5, 3):
        cfg_i = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, local_iters=iters))
        measure(f"local_ba_{iters}it", lambda st, c=cfg_i: local_ba.local_bundle_adjust(
            st, i, c).state, warm, n)

    # 8. the mapping extras
    m = cfg.mapping
    measure("fuse", lambda st: mapping.fuse(st, i, radius_px=m.fuse_radius_px,
                                            max_hamming=m.fuse_max_hamming,
                                            image_wh=cfg.image_wh).state, warm, n_short)
    measure("cull", lambda st: mapping.cull_points(st, i, min_obs=m.cull_min_obs,
                                                   grace=m.cull_grace)[0], warm, n_short)

    # 9. a frame's ingest into the last slot
    f0 = seq.frames[0]
    k = torch.as_tensor(seq.k, dtype=torch.float32, device=dev)  # no host copy in a capture
    last = torch.tensor(cfg.max_frames - 1, device=dev)
    slot = torch.tensor(state_mod.n_slots(cfg) - 1, device=dev)
    measure("add_feats", lambda st: state_mod.add_frame_features(
        st, last, slot, f0.uv, f0.scale, f0.valid, f0.desc, f0.desc_pm1, k), warm, n)

    for k, v in out.items():
        print(f"{k}: {v}", file=sys.stderr)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None, help="write the JSON here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = run(args.device)
    s = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(s + "\n")
    print(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())

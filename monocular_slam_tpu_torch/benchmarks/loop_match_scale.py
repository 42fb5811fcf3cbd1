"""Loop-closure retrieval and verification matching at map scale on the
card (the counterpart of `benchmarks/loop_match_scale.py`, whose
`loop_match_scale_r02.json` keys it writes):

  1. retrieval:    BoW-score one query against a 10,000-frame database
                   (`retrieval/vocabulary.score_against_database`).
  2. verification: ratio-test matching between two 2,000-feature frames
                   (`ops/matching.match`, the Sim3 stage's matcher).
  3. map-scale:    one query frame (2,000 descriptors) against 20,000+ map
                   point descriptors: each query's nearest map point,
                   through K2 (`ops/hamming.hamming_top2`, one launch).
  4. direct index:  ratio-test matching of one query frame against the
                   whole map at max_points 20,000, 30,000 and 65,536
                   (`direct_index_vs_full_<M>`): the dense table
                   (`matching.match(use_kernel=False)`, `full_xla_ms`), K2
                   (`use_kernel=True`, forward and cross-check launches,
                   `full_pallas_ms`), and DBoW2's node-guided match
                   (`matching.guided_match` on `vocabulary.node_words` two
                   levels up) with the nodes precomputed and with their
                   quantization inside the call.

Sections 1-3 draw from numpy seeds (Dirichlet BoW vectors, random +-1
descriptors); section 4 draws the reference's descriptors from its keys
(`utils/prng.py`): the query the sign of a normal from `split(PRNGKey(0),
2)[0]`, the map the sign of a normal from `fold_in(PRNGKey(0), M)`. Each
time is the mean of 20 calls after one warm-up.

    python -m monocular_slam_tpu_torch.benchmarks.loop_match_scale [--out chiprun_out/loop_match_scale_cuda.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from monocular_slam_tpu_torch.benchmarks import device_label, mean_seconds


def _pm1(rng, n: int, device) -> torch.Tensor:
    return torch.as_tensor(np.where(rng.randn(n, 256) >= 0, 1, -1).astype(np.int8), device=device)


DIRECT_INDEX_M = (20000, 30000, 65536)


def threefry_pm1(key, n: int, device) -> torch.Tensor:
    """(n, 256) int8: the sign of a float32 normal draw from `key`."""
    from monocular_slam_tpu_torch.utils import prng

    return torch.as_tensor(np.sign(prng.normal(key, (n, 256))).astype(np.int8), device=device)


def direct_index(n_feat: int = 2000, maps=DIRECT_INDEX_M, device="cuda", n: int = 20,
                 details: dict | None = None) -> dict:
    """Section 4 under the reference driver's keys. `details`, when given,
    receives per map size whether K2's `Matches` equal the dense route's
    and K2's launches in one call."""
    from monocular_slam_tpu_torch.ops import launches, matching
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.utils import prng

    dev = torch.device(device)
    voc = vocabulary.load_default(dev)
    key = prng.PRNGKey(0)
    da = threefry_pm1(prng.split(key, 2)[0], n_feat, dev)
    okq = torch.ones(n_feat, dtype=torch.bool, device=dev)
    out = {}
    for M in maps:
        dmap = threefry_pm1(prng.fold_in(key, M), M, dev)
        okm = torch.ones(M, dtype=torch.bool, device=dev)
        kw = dict(ratio=0.9, max_dist=80)
        with torch.inference_mode():
            nq = vocabulary.node_words(voc, da, okq, levels_up=2)
            nm = vocabulary.node_words(voc, dmap, okm, levels_up=2)
            fns = {
                "full_xla_ms": lambda: matching.match(da, dmap, okq, okm, use_kernel=False, **kw),
                "full_pallas_ms": lambda: matching.match(da, dmap, okq, okm, use_kernel=True,
                                                         **kw),
                "guided_precomputed_nodes_ms": lambda: matching.guided_match(
                    da, dmap, okq, okm, nq, nm, **kw),
                "guided_with_quantization_ms": lambda: matching.guided_match(
                    da, dmap, okq, okm, vocabulary.node_words(voc, da, okq, levels_up=2),
                    vocabulary.node_words(voc, dmap, okm, levels_up=2), **kw),
            }
            row = {"n_query": n_feat, "n_map_points": M}
            row |= {name: mean_seconds(fn, dev, n) * 1e3 for name, fn in fns.items()}
            if details is not None:
                cuda = dev.type == "cuda"
                if cuda:
                    launches.reset()
                got = fns["full_pallas_ms"]()
                counted = launches.read()["hamming_top2"] if cuda else None
                want = fns["full_xla_ms"]()
                details[M] = {"kernel_equals_dense": all(
                    torch.equal(a, b) for a, b in zip(got, want)), "k2_launches_a_call": counted}
        out[f"direct_index_vs_full_{M}"] = row
    return out


def run(db_frames: int = 10000, n_feat: int = 2000, map_points: int = 20000, device="cuda",
        n: int = 20, maps=DIRECT_INDEX_M, details: dict | None = None) -> dict:
    """The four measurements under the reference driver's keys."""
    from monocular_slam_tpu_torch.ops import hamming, matching
    from monocular_slam_tpu_torch.retrieval import vocabulary

    dev = torch.device(device)
    rng = np.random.RandomState(0)
    out = {"device": device_label(dev)}

    voc = vocabulary.load_default(dev)
    V = voc.n_words
    db = torch.as_tensor(rng.dirichlet(np.ones(V), db_frames).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.dirichlet(np.ones(V)).astype(np.float32), device=dev)
    with torch.inference_mode():
        dt = mean_seconds(lambda: vocabulary.score_against_database(q, db, "l1"), dev, n)
    out["retrieval_10k_frames"] = {"db_frames": db_frames, "n_words": int(V), "ms": dt * 1e3}

    da, db2 = _pm1(rng, n_feat, dev), _pm1(rng, n_feat, dev)
    ok = torch.ones(n_feat, dtype=torch.bool, device=dev)
    with torch.inference_mode():
        dt = mean_seconds(lambda: matching.match(da, db2, ok, ok, ratio=0.9, max_dist=80), dev, n)
    out["verification_frame_pair"] = {"n_feat": n_feat, "ms": dt * 1e3}

    dmap = _pm1(rng, map_points, dev)
    mv = torch.ones(map_points, dtype=torch.bool, device=dev)
    with torch.inference_mode():
        dt = mean_seconds(lambda: hamming.hamming_top2(da, dmap, mv), dev, n)
    out["map_scale_match"] = {"n_query": n_feat, "n_map_points": map_points, "ms": dt * 1e3}
    return out | direct_index(n_feat, maps, dev, n, details)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--db-frames", type=int, default=10000)
    p.add_argument("--n-feat", type=int, default=2000)
    p.add_argument("--map-points", type=int, default=20000)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from monocular_slam_tpu_torch.utils.device import resolve_device

    out = run(args.db_frames, args.n_feat, args.map_points, resolve_device(args.device))
    s = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(s + "\n")
    print(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())

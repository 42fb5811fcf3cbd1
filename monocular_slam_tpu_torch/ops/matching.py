"""Descriptor matching: Hamming table + top-2 + ratio test + mutual check
(counterpart of `monocular_slam_tpu/ops/matching.py`).

dist = (256 - a_pm1 . b_pm1) / 2 on the +-1 expansion. The dense route
materializes the (N, M) table: CUDA has no int8 or int32 `torch.matmul`,
so the product runs in float32 (|dot| <= 256, every partial sum is an
integer below 2^24, and with TF32 off it is exact). The kernel route is K2
(`ops/hamming.py`), which keeps only a running top-2 per query row and
returns the same `Matches` on every row. On the card, `match(use_kernel=
None)` takes K2 for a batch of databases (the tracker's back-traverse
window: two launches, forward and cross-check) and, as in the reference,
for a single database of at least PALLAS_MIN_DB rows; the loop-closing
callers (`LoopCloser.compute_sim3`, `tracker.relocalize`) ask for it
explicitly. On the CPU the default is the dense route.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.ops import hamming

FEATURE_MATCH_RATIO_TEST = 0.85
TRACKING_RATIO = 0.8
BIG = hamming.BIG
PALLAS_MIN_DB = 4096  # database rows from which the default route is K2


def hamming_matrix(a_pm1: torch.Tensor, b_pm1: torch.Tensor) -> torch.Tensor:
    """(N, 256) int8, (..., M, 256) int8 -> (..., N, M) int32 distances."""
    dots = a_pm1.to(torch.float32) @ b_pm1.to(torch.float32).transpose(-1, -2)
    return ((256.0 - dots) * 0.5).to(torch.int32)


class Matches(NamedTuple):
    idx: torch.Tensor  # (..., N) best match in B
    dist: torch.Tensor  # (..., N) its distance
    ok: torch.Tensor  # (..., N) passed ratio/validity/cross checks
    n_matches: torch.Tensor


def match(a_pm1, b_pm1, a_valid, b_valid, ratio: float = FEATURE_MATCH_RATIO_TEST,
          max_dist: int = 256, cross_check: bool = True, use_kernel: bool | None = None) -> Matches:
    """Lowe-ratio kNN matching; invalid rows/cols sit at distance 1<<20.
    `b_pm1` (..., M, 256) and `b_valid` (..., M) may carry leading batch
    dims: one query set against several databases at once (K2 takes one
    batch dim). `use_kernel=True` routes to K2, `False` to the dense table;
    both give the same `Matches`."""
    if use_kernel is None:
        use_kernel = b_pm1.is_cuda and (
            b_pm1.dim() == 3 or (b_pm1.dim() == 2 and b_pm1.shape[0] >= PALLAS_MIN_DB))
    if use_kernel:
        return hamming.match_kernel(a_pm1, b_pm1, a_valid, b_valid, ratio=ratio,
                                    max_dist=max_dist, cross_check=cross_check)
    D = hamming_matrix(a_pm1, b_pm1)
    D = torch.where(b_valid[..., None, :], D, BIG)
    D = torch.where(a_valid[:, None], D, BIG)
    return _select_matches(D, a_valid, ratio, max_dist, cross_check)


def _select_matches(D, a_valid, ratio, max_dist, cross_check) -> Matches:
    """Top-2 per row (lowest index on ties) + ratio/absolute gates +
    optional mutual check over a masked (..., N, M) table."""
    best = torch.argmin(D, dim=-1)
    d1 = D.min(dim=-1).values
    cols = torch.arange(D.shape[-1], device=D.device)
    d2 = torch.where(cols == best[..., None], BIG, D).min(dim=-1).values
    ok = (
        a_valid
        & (d1.to(torch.float32) < ratio * d2.to(torch.float32))
        & (d1 <= max_dist)
    )
    if cross_check:
        best_col = torch.argmin(D, dim=-2)
        rows = torch.arange(D.shape[-2], device=D.device)
        ok = ok & (torch.gather(best_col, -1, best) == rows)
    return Matches(best.to(torch.int32), d1, ok, ok.sum(-1))


def guided_match(a_pm1, b_pm1, a_valid, b_valid, nodes_a, nodes_b,
                 ratio: float = FEATURE_MATCH_RATIO_TEST, max_dist: int = 256,
                 cross_check: bool = True) -> Matches:
    """DBoW2 direct-index ("FeatureVector") matching: only pairs quantized
    to the same vocabulary node (`retrieval.vocabulary.node_words`) are
    candidates, as a node-equality mask on the dense table."""
    D = hamming_matrix(a_pm1, b_pm1)
    D = torch.where(nodes_a[:, None] == nodes_b[None, :], D, BIG)
    D = torch.where(b_valid[None, :], D, BIG)
    D = torch.where(a_valid[:, None], D, BIG)
    return _select_matches(D, a_valid, ratio, max_dist, cross_check)

"""Deterministic scatters.

The reference writes with `.at[idx].set(v, mode="drop")`: out-of-range
updates are dropped and, for duplicate indices, the CPU backend keeps the
LAST update in update order. Torch's `index_put_` leaves duplicates to an
arbitrary (on CUDA, run-to-run varying) winner. `set_last` reproduces the
reference's rule exactly: per target, the kept update with the largest
position wins, decided with one `scatter_reduce("amax")` on positions; the
losers and the dropped updates are routed to a dump row that is sliced off.

Float segment sums are deterministic too. A float `index_add_` on the card
adds with atomics, so the last bits of a sum change from run to run.
`segment_sum` sorts the ids once (`segments`, a stable sort: equal ids keep
their order) and reduces each segment's contiguous run of values with
`torch.segment_reduce`, which adds a segment's values one after another in
that order, on the CPU as on the card. That is `index_add_`'s order on the
CPU, so the CPU sums keep their bits. A segment's run is one thread's
serial loop on the card, so a plan drops the rows that add nothing (`keep`):
the solvers' padded edge slots share one id (point 0 of a state's edge
list holds most of its 10^5 slots), and summing them took seconds per
solve. A solver builds the plan once per linearization and reuses it for
every sum over the same ids (a PCG step never sorts). Integer sums are
exact in any order and keep `index_add_`.
No step here syncs with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def set_last(dest: torch.Tensor, idx: torch.Tensor, vals, keep=None) -> torch.Tensor:
    """New tensor: `dest` with dest[idx[m]] = vals[m] along dim 0 for every
    kept, in-range update m; among duplicates the last one wins.
    idx (M,) integer; vals (M, *dest.shape[1:]) or a scalar; keep (M,) bool."""
    n = dest.shape[0]
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    if keep is not None:
        ok = ok & keep
    pos = torch.arange(idx.shape[0], device=idx.device)
    safe = torch.where(ok, idx, n)
    win = torch.full((n + 1,), -1, dtype=torch.long, device=idx.device)
    win = win.scatter_reduce(0, safe, torch.where(ok, pos, -1), "amax")
    sel = ok & (win[safe] == pos)
    tgt = torch.where(sel, idx, n)
    ext = torch.cat([dest, dest[:1]])
    if not torch.is_tensor(vals):
        vals = torch.full((idx.shape[0],) + tuple(dest.shape[1:]), vals,
                          dtype=dest.dtype, device=dest.device)
    ext[tgt] = vals.to(dest.dtype)
    return ext[:n]


def set_last_2d(dest: torch.Tensor, rows, cols, vals, keep=None) -> torch.Tensor:
    """`set_last` on a (R, C, ...) tensor addressed by (row, col) pairs;
    an out-of-range row or col drops the update."""
    R, C = dest.shape[:2]
    rows = rows.long()
    cols = cols.long()
    ok = (rows >= 0) & (rows < R) & (cols >= 0) & (cols < C)
    if keep is not None:
        ok = ok & keep
    flat = dest.reshape((R * C,) + tuple(dest.shape[2:]))
    out = set_last(flat, rows * C + cols, vals, keep=ok)
    return out.reshape(dest.shape)


def segment_min(vals: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """`jax.ops.segment_min`: empty segments hold the dtype's max; segment
    ids outside [0, num) are dropped."""
    big = torch.iinfo(vals.dtype).max if not vals.is_floating_point() else float("inf")
    seg = seg.long()
    ok = (seg >= 0) & (seg < num)
    safe = torch.where(ok, seg, num)
    out = torch.full((num + 1,), big, dtype=vals.dtype, device=vals.device)
    out = out.scatter_reduce(0, safe, vals, "amin")
    return out[:num]


class Segments(NamedTuple):
    """The plan of a deterministic segment sum over one id vector."""

    order: torch.Tensor  # (E,) positions sorted by id, stably; dropped rows last
    offsets: torch.Tensor  # (num + 1,) run starts and the end of the last run


def segments(seg: torch.Tensor, num: int, keep=None) -> Segments:
    """The plan for sums over `num` segments with ids `seg` (E,); rows with
    an id outside [0, num), or not in `keep` (E,) bool, are dropped. Drop
    only rows whose values are zero, or the sums change."""
    seg = seg.long()
    ok = (seg >= 0) & (seg < num)
    safe = torch.where(ok if keep is None else ok & keep, seg, num)
    counts = torch.zeros(num + 1, dtype=torch.long, device=seg.device)
    counts.index_add_(0, safe, torch.ones_like(safe))
    return Segments(torch.argsort(safe, stable=True),
                    torch.cat([counts.new_zeros(1), counts[:num].cumsum(0)]))


def segment_sum(vals: torch.Tensor, seg, num: int | None = None) -> torch.Tensor:
    """`jax.ops.segment_sum` over dim 0 (out-of-range ids dropped). `seg`
    is an id tensor with its segment count `num`, or a `Segments` plan."""
    if isinstance(seg, Segments):
        plan = seg
    elif not vals.is_floating_point():
        seg = seg.long()
        safe = torch.where((seg >= 0) & (seg < num), seg, num)
        out = torch.zeros((num + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                          device=vals.device)
        return out.index_add_(0, safe, vals)[:num]
    else:
        plan = segments(seg, num)
    return torch.segment_reduce(vals[plan.order], "sum", offsets=plan.offsets, unsafe=True)


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last dim with the reference's tie order (lowest index
    first among equal values, as `jax.lax.top_k`). `torch.topk` does not
    promise that order; a stable descending sort does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] along dim 0 for a 0-d device index, without a host sync."""
    return x.index_select(0, i.reshape(1).long())[0]


def put(x: torch.Tensor, i: torch.Tensor, v) -> torch.Tensor:
    """New tensor: x with row i (0-d device index) replaced by v."""
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device).expand(x.shape[1:])
    return x.index_copy(0, i.reshape(1).long(), v[None])


def mark(n: int, idx: torch.Tensor, keep=None) -> torch.Tensor:
    """(n,) bool mask, True at every kept in-range index of `idx`."""
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    if keep is not None:
        ok = ok & keep
    out = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    out.index_fill_(0, torch.where(ok, idx, n), True)
    return out[:n]

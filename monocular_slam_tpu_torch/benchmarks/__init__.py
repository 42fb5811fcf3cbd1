"""The repository's drivers on the card (counterparts of `bench.py` and
`benchmarks/*.py`): each runs on the CUDA card unless given `device="cpu"`,
raises without a card, and writes its reference driver's JSON keys. Nothing
here does work at import."""

from __future__ import annotations

import contextlib
import importlib
import os
import pickle
import shutil
import subprocess
import tempfile
import time

import torch


def sync(device) -> None:
    """Wait for the card (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_label(device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (the
    name alone if nvidia-smi cannot be run), or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={dev.index or 0}"],
                             capture_output=True, text=True, check=True, timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def mean_seconds(fn, device, n: int = 20, warmup: int = 1) -> float:
    """Mean wall seconds of `fn()` over n calls after `warmup` calls, the
    card drained before and after (the reference drivers' `_timeit`)."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / n


def device_ops(fn, device, summarized: bool = False):
    """Device operations (kernels, copies, memsets) one call of fn puts on
    the card, counted by `torch.profiler` from its raw device events
    (building its per-event summaries took minutes for the 10^6 operations
    of a CG correction); None on the CPU. With `summarized`, (raw count,
    the count summed over `key_averages()`), to show that the two agree."""
    if torch.device(device).type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a trace that starts with the call may lose its first device
        # operations, so the host waits first
        time.sleep(0.1)
        fn()
        sync(device)
    cuda = torch.autograd.DeviceType.CUDA
    raw = sum(1 for e in prof.profiler.kineto_results.events() if e.device_type() == cuda)
    if not summarized:
        return raw
    return raw, sum(e.count for e in prof.key_averages() if e.device_type == cuda)


class Replayed:
    """`fn(carry)`, or `fn(carry, key)` when built with a key, as one
    captured program on a card over static copies of the carry's tensors
    (a tensor or a tuple of them). fn returns the new carry, or with
    `extra` (the new carry, extra outputs). With `chain` the program's last
    operations copy the new carry into the statics, so each replay chains
    on the last; `step()` returns the extras (with `extra`) or the
    program's outputs (the static tensors the replay leaves them in). The
    key goes in as the words of the PnP half of its split through
    `graph.Words`, as the session's control words do. On the CPU fn runs
    op by op, with the host key. `step(key)` runs one call, with a new key
    when given."""

    def __init__(self, fn, carry, device, key=None, chain: bool = True, extra: bool = False):
        from monocular_slam_tpu_torch.utils import graph

        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.single = torch.is_tensor(carry)
        self.kind = None if self.single else type(carry)
        with torch.inference_mode(False):
            self.leaves = [x.clone() for x in graph.leaves(carry)]
        self.keyed, self.key = key is not None, key
        self.words = graph.Words(2, self.device) if cuda and self.keyed else None
        self.fn, self.chain, self.extra = fn, chain, extra
        self.program = None
        if cuda:
            self._fill(key)
            with torch.inference_mode():
                self.program = graph.Program(self.body, stream=torch.cuda.Stream(self.device))
            self.reset(carry)  # the capture's warm-up run wrote into the carry

    def body(self):
        """One call of fn on the statics (what the program captures). A
        method, not a closure kept on the object, so that a dropped
        `Replayed` is freed at once and not left to the cyclic collector."""
        from monocular_slam_tpu_torch.utils import graph

        args = (self.current(clone=False),)
        if self.keyed:
            args += (self.key if self.words is None else self.words.dev,)
        out = self.fn(*args)
        if self.chain:
            graph.copy_leaves(self.leaves, out[0] if self.extra else out)
        return out[1] if self.extra else out

    def _fill(self, key) -> None:
        from monocular_slam_tpu_torch.utils import prng

        if key is None:
            return
        if self.words is None:
            self.key = key
        else:
            self.words.fill(prng.split(key)[0])

    def current(self, clone: bool = True):
        leaves = [x.clone() for x in self.leaves] if clone else self.leaves
        if self.single:
            return leaves[0]
        return self.kind(*leaves) if hasattr(self.kind, "_fields") else self.kind(leaves)

    def reset(self, carry) -> None:
        from monocular_slam_tpu_torch.utils import graph

        graph.copy_leaves(self.leaves, carry)

    def step(self, key=None):
        self._fill(key)
        if self.program is not None:
            return self.program.replay()
        with torch.inference_mode():
            return self.body()


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def nccl_world1():
    """A one-rank NCCL process group in this process for the block (the one
    already initialized is used and kept)."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    if made:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    try:
        yield
    finally:
        if made:
            dist.destroy_process_group()


def spawn_world(world: int, target: str, kwargs: dict, device) -> list:
    """`target(rank, **kwargs) -> dict` ("module:function") on `world` gloo
    ranks, each a process of torch.multiprocessing's spawn (one intra-op
    torch thread a rank on the CPU; CUDA tensors on the current card
    otherwise), rendezvous through a file in a fresh temporary directory.
    Returns each rank's dict, in rank order."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="mslam_world_")
    try:
        mp.spawn(_world_rank, args=(world, tmp, target, kwargs, str(device)), nprocs=world,
                 join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _world_rank(rank: int, world: int, tmp: str, target: str, kwargs: dict, device: str) -> None:
    import torch.distributed as dist

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", world_size=world,
                            rank=rank)
    mod, fn = target.split(":")
    out = getattr(importlib.import_module(mod), fn)(rank, **kwargs)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()

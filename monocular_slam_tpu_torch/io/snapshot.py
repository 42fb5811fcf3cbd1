"""SlamState and BAProblem snapshots as `.npz` (counterpart of
`monocular_slam_tpu/io/snapshot.py`).

The file format is the reference's: one array per field, keyed by the
field name, with the reference's dtypes (`desc` as uint32). So the
reference's `load_state` reads a snapshot written here and the other way
round. States go through `state_to_numpy`/`state_from_numpy`; snapshots
serve as golden fixtures and as session checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch

from monocular_slam_tpu_torch.optim.ba import BAProblem
from monocular_slam_tpu_torch.slam.state import SlamState, state_from_numpy, state_to_numpy


def save_state(path: str, state: SlamState) -> None:
    np.savez_compressed(path, **state_to_numpy(state))


def load_state(path: str, device=None) -> SlamState:
    """The snapshot at `path` as a SlamState on `device` (default: the CPU,
    where `np.load` leaves it; pass the session's device)."""
    with np.load(path) as data:
        return state_from_numpy({f: data[f] for f in SlamState._fields}, device=device)


def save_ba_problem(path: str, prob: BAProblem) -> None:
    """Serialize a BAProblem (the golden-fixture format of the optim tests)."""
    np.savez_compressed(path, **{f: getattr(prob, f).detach().cpu().numpy()
                                 for f in BAProblem._fields})


def load_ba_problem(path: str, device=None) -> BAProblem:
    with np.load(path) as data:
        return BAProblem(**{f: torch.as_tensor(data[f], device=device) for f in BAProblem._fields})

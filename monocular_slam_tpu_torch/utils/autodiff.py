"""Forward-mode Jacobians (`torch.func.jacfwd`) that also work when the
caller runs under `torch.inference_mode` (the session's step does):
functorch's dual tensors cannot be made there, so the Jacobian is taken
with inference mode off, on plain copies of the inputs."""

from __future__ import annotations

import torch


def jacfwd(fn, *args, argnums=0, vmap_dims=None):
    """`torch.func.jacfwd(fn, argnums)(*args)`, vmapped over `vmap_dims`
    when given, cast to the first argument's dtype (forward-mode tangents of
    0-d float32 math with Python scalars come back as float64 under vmap)."""
    dt = args[0].dtype
    with torch.inference_mode(False):
        args = [a.clone() if torch.is_tensor(a) else a for a in args]
        jac = torch.func.jacfwd(fn, argnums=argnums)
        if vmap_dims is not None:
            jac = torch.func.vmap(jac, in_dims=vmap_dims)
        out = jac(*args)
    if isinstance(out, tuple):
        return tuple(o.to(dt) for o in out)
    return out.to(dt)

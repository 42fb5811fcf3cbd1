"""Multi-process distribution: process groups, the (data, model) mesh and the
sharded global BA and pose-graph solvers, on `torch.distributed`."""

"""Ms a step in the port's `optimizer` spans (zero_grad, Adam, the quaternions)."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("train_step",), "optimizer")

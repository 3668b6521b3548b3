"""Ms a step in the port's `backward` span (K6 and the scatter of the gradients)."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("train_step",), "backward")

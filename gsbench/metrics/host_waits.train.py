"""The host's blocking waits on the card a step (copies and synchronizes)."""

from gsbench.spans import count_per_root


def read(tr):
    return count_per_root(("train_step",), "host_waits")

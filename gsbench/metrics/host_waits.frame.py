"""The host's blocking waits on the card a frame (copies and synchronizes)."""

from gsbench.spans import count_per_root


def read(tr):
    return count_per_root(("render",), "host_waits")

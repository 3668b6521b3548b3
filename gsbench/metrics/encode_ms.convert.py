"""Ms a conversion or export in the writer's `encode` spans (packing and readbacks)."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("convert", "export"), "encode")

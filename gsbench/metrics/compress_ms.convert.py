"""Ms an export in the .spz writer's `compress` span (its gzip)."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("convert", "export"), "compress")

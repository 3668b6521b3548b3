"""Ms a conversion in the SOG writer's stage sog.encode_threads_join (waiting for the host pool's encodes)."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("convert",), "sog.encode_threads_join")

"""Ms a conversion in the SOG writer's stage sog.morton_order (the splats' Morton order)."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("convert",), "sog.morton_order")

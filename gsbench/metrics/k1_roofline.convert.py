"""K1's share of its roofline over the traced conversions: SOR's window pairs (reference count) over K1's device time."""

from gsbench.trace import roofline_share


def read(tr):
    return roofline_share(tr, "sor_window_md_kernel", "k1", "k1")

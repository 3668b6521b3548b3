"""K5's share of its roofline over the traced frames."""

from gsbench.trace import roofline_share


def read(tr):
    return roofline_share(tr, "composite_fwd_kernel", "composite_fwd", "k5")

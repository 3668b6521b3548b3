"""K5's share of its roofline over the traced steps: the compositing the inputs need (reference count) over K5's device time."""

from gsbench.trace import roofline_share


def read(tr):
    return roofline_share(tr, "composite_fwd_kernel", "composite_fwd", "k5")

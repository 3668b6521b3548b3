"""K2's share of its roofline over the traced conversions: the palette fit's
distance products on the tensor cores (``traffic/sog.py``'s count) over the
device time of K2's labels kernel and its exact re-check, one each a launch."""

from gsbench.trace import roofline_share


def read(tr):
    share = roofline_share(tr, "lloyd_labels_tc_kernel", "k2", "k2")
    labels_s, _ = tr.kernel("lloyd_labels_tc_kernel")
    recheck_s, rechecks = tr.kernel("lloyd_recheck_kernel")
    if share is None or rechecks != tr.launches.get("k2"):
        return None
    return share * labels_s / (labels_s + recheck_s)

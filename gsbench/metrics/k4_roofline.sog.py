"""K4's share of its roofline over the traced conversions: the bytes of the
palette fit's sum stages (``traffic/sog.py``'s count) over the device time of
all K4's kernels, whose launches are counted by the one that starts each
launch's clusters."""

from gsbench.trace import roofline_share

KERNELS = ("radix_hist_kernel", "row_scan_kernel", "radix_scatter_kernel",
           "cluster_starts_kernel", "piece_sums_kernel", "combine_small_kernel",
           "combine_big_kernel")


def read(tr):
    share = roofline_share(tr, "cluster_starts_kernel", "k4", "k4")
    if share is None:
        return None
    return share * tr.kernel("cluster_starts_kernel")[0] / sum(tr.kernel(k)[0] for k in KERNELS)

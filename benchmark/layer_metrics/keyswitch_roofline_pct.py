"""keyswitch_roofline_pct.<op>: the least time the card could take for the
calls' pack merges, trace steps and split levels, over the device time of
the merge, trace and split kernels (and their one-launch trees) in the
traced stretch.  Layer: keyswitch."""

from benchmark import roofline

KERNELS = frozenset(("pack_merge_kernel", "trace_kernel", "split_kernel",
                     "pack_tree_kernel", "split_tree_kernel"))


def read(r):
    if r.trace is None:
        return None
    t = r.trace.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    least = roofline.layer_least_seconds(r.params, r.op, "keyswitch", r.batch) * r.steps
    return 100.0 * least / t

"""fold_roofline_pct.<op>: the least time the card could take for the
calls' folds (external products, their CMux digit chains, the GGSW
inversion's keyswitch and tensor-key products), over the device time of
the fold kernels in the traced stretch.  Layer: fold."""

from benchmark import roofline

KERNELS = frozenset(("fold_kernel", "external_kernel"))


def read(r):
    if r.trace is None:
        return None
    t = r.trace.kernel_seconds(KERNELS)
    if t <= 0:
        return None
    least = roofline.layer_least_seconds(r.params, r.op, "fold", r.batch) * r.steps
    return 100.0 * least / t

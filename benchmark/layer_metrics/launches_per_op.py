"""launches_per_op.<op>: the port's kernel launches a server call, from the
program's launch counters (`ops.ntt_cuda.LAUNCHES`) over the traced
stretch, divided by the calls in it.  Layer: server entry."""


def read(r):
    if not r.is_cuda or r.steps <= 0:
        return None
    return r.launches / r.steps

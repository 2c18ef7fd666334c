"""The fused selective scan's backward kernel, as a share of the
function's own least time (``counting.scan_bwd_bound_s``) at the
training scan's shape, %."""
from perfbench import counting, readers


def read(ctx):
    shape = getattr(ctx, "scan_bwd_shape", None)
    if shape is None:
        return None
    return readers.roofline(ctx, "selective_scan_bwd",
                            counting.scan_bwd_bound_s(*shape))

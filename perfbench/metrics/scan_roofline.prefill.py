"""The fused selective scan's forward kernel, as a share of the
function's own least time (``counting.scan_fwd_bound_s``) at the
prefill's shape, %."""
from perfbench import counting, readers


def read(ctx):
    shape = getattr(ctx, "scan_fwd_shape", None)
    if shape is None:
        return None
    return readers.roofline(ctx, "selective_scan_fwd",
                            counting.scan_fwd_bound_s(*shape))

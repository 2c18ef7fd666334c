"""``cudaMalloc`` calls an arrival: the caching allocator's
``num_device_alloc`` over the port's ``train.arrival`` span; 0 when the
allocator reuses its blocks."""
from perfbench import port_spans


def read(ctx):
    return port_spans.allocator(port_spans.ARRIVAL, "device_allocs")

"""The caching allocator's retries an arrival (``num_alloc_retries``
over the port's ``train.arrival`` span): each is a failed ``cudaMalloc``
that synchronized, freed the cache and allocated again."""
from perfbench import port_spans


def read(ctx):
    return port_spans.allocator(port_spans.ARRIVAL, "alloc_retries")

"""Device ms a prefill call of the Mamba mixer's elementwise passes over
every layer: the port's spans ``mamba.conv`` (the causal conv and its
SiLU, with their casts) and ``mamba.gate`` (``y + D xh`` and the SiLU
gate, before the out-projection)."""
from perfbench import port_spans


def read(ctx):
    return port_spans.device_ms(port_spans.CALL,
                                ["mamba.conv", "mamba.gate"])

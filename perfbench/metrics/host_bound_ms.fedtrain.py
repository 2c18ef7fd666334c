"""Device ms an arrival in which the host reads a value back or builds
the next batch, so the stream's queue runs empty: the port's spans
``train.draw_batch`` (the client's batch and its two pageable copies),
``train.read_loss`` (the loss read to the arrival's end) and
``moe.read_counts`` (the MoE layer's per-expert counts)."""
from perfbench import port_spans


def read(ctx):
    return port_spans.device_ms(
        port_spans.ARRIVAL,
        ["train.draw_batch", "train.read_loss", "moe.read_counts"])

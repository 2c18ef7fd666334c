"""The whole prefill call's model operations (2 a weight a prompt
position, the head on the last position only) over the traced window,
as a share of the H100's bf16 peak (989 TFLOP/s), %."""
from perfbench import readers


def read(ctx):
    return readers.mfu(ctx)

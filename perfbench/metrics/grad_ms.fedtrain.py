"""Device ms an arrival of the local step's loss and gradient, the
ASO-Fed transform not counted (the operations launched inside the
``local_step`` span and outside the transform's)."""
from perfbench import readers


def read(ctx):
    return readers.span_ms(ctx, ["local_step"])

"""The whole arrival's model operations (6 a weight a token that the
forward and backward multiply, the routed experts only, causal
attention's products) over the traced window, as a share of the H100's
fp32 peak (67 TFLOP/s; the training cells run fp32 with TF32 off), %.
It bounds every kernel's share from above."""
from perfbench import readers


def read(ctx):
    return readers.mfu(ctx)

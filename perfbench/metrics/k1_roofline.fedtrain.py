"""Kernel K1's per-row feature pass over the token embedding, as a share
of its roofline: the (vocab, d) table read once and written once at
3.35 TB/s, over the mean time of its launches, %."""
from perfbench import counting, readers


def read(ctx):
    return readers.roofline(ctx, "feature_attention_rows",
                            counting.feature_pass_bound_s(*ctx.k1_shape))

"""The device's idle share of the traced prefill window, % (moves
prefill_tokens_per_s)."""
from perfbench import readers


def read(ctx):
    return readers.idle_share(ctx)

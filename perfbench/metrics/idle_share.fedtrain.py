"""The device's idle share of the traced training window, % (moves
fedtrain_tokens_per_s): the time the host keeps the card waiting."""
from perfbench import readers


def read(ctx):
    return readers.idle_share(ctx)

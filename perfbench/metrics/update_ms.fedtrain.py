"""Device ms an arrival of the ASO-Fed update (Eq. 7-11) and the
server's Eq. (4) fold."""
from perfbench import readers


def read(ctx):
    return readers.span_ms(ctx, ["asofed_transform", "server_fold"])

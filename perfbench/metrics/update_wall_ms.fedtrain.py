"""Device ms an arrival from the ASO-Fed transform's start to its end
and the Eq. (4) fold's: the port's spans ``train.transform`` and
``train.fold``, the scope of ``update_ms.fedtrain``."""
from perfbench import port_spans


def read(ctx):
    return port_spans.device_ms(port_spans.ARRIVAL,
                                ["train.transform", "train.fold"])

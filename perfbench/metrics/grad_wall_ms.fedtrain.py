"""Device ms an arrival from the local step's start to its end, the
ASO-Fed transform not counted: the port's span ``train.local_step`` less
``train.transform``.  The scope of ``grad_ms.fedtrain``, which counts
only the time an operation ran: the difference is the local step's idle
time."""
from perfbench import port_spans


def read(ctx):
    return port_spans.device_ms(port_spans.ARRIVAL, ["train.local_step"],
                                ["train.transform"])

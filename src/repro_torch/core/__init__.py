"""Federated core of the port: client math, feature learning, metrics,
and the algorithm strategies (``repro_torch.core.algorithms``)."""

"""Traffic: the mixes (``<mix>.json``, data that names its driver) and
the one generator of their token streams (``generator.py``)."""

"""PyTorch/CUDA port of the ASO-Fed cohort simulation engine.

A second package beside ``repro`` (the JAX reference): the same layout
and names, plain PyTorch inside, and the JAX package's Pallas kernels as
hand-written CUDA kernels for Hopper (``repro_torch.kernels``).  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
The port imports nothing from ``jax`` or ``repro``.
"""

"""The plain reference: fp32 PyTorch, independent of the port.

Nothing here imports the port (``repro_torch``), ``jax`` or the JAX
package.  It reads the weights the benchmark drew, in the port's layout
(nested dicts of layer-stacked leaves), and works everything else out
again: the models' forward and gradient, the ASO-Fed loop's state, the
served tokens' logits.
"""

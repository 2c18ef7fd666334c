"""Model configuration for the port.

``ModelConfig`` keeps the JAX package's field names
(``repro.configs.base``) for the families the port runs: the paper-scale
LSTM / CNN and the dense transformer trunk.  Architectures register in
``ARCHS`` by name and ``get_arch`` builds a fresh config; ``reduced()``
derives the same family at CPU-test size, exactly as the JAX package's
does for these fields.
"""
from __future__ import annotations

import dataclasses

from repro_torch.common.registry import Registry

ARCHS: Registry["ModelConfig"] = Registry("architecture")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | lstm | cnn
    citation: str = ""

    # transformer trunk
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    rope_theta: float = 10000.0

    # long-context variant for dense archs (0 = full attention)
    sliding_window: int = 0

    # the JAX package's mesh layout ("tp" | "seqp" | ...): stored as given
    # and read by nothing, the port runs on one card.  Every dense config
    # sets it as its JAX config does; the default is JAX's
    parallel_strategy: str = "tp"

    # paper-scale models (LSTM / CNN)
    in_features: int = 0
    out_features: int = 0
    hidden: int = 0  # LSTM hidden width / CNN conv channels

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def with_sliding_window(self, window: int = 8192) -> "ModelConfig":
        return dataclasses.replace(self, sliding_window=window)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        r = dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2) if self.n_layers else 0,
            d_model=min(self.d_model, 256) if self.d_model else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512) if self.vocab_size else 0,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
            hidden=min(self.hidden, 64) if self.hidden else 0,
        )
        # recompute derived head_dim for the reduced trunk
        if r.n_heads:
            object.__setattr__(r, "head_dim", r.d_model // r.n_heads)
        return r


def get_arch(name: str) -> ModelConfig:
    return ARCHS.get(name)()

"""Storage dtypes of the cohort engine's stacked client state.

The port's copy of the storage half of ``repro.common.dtypes``: the same
names, aliases, levels, pool bits and error text, with torch dtypes.
fp32 is the identity codec (master precision stored directly,
bitwise-replayable).  int8 / int4 are fixed-point quantized delta
codecs: masked leaves store ``round((x - anchor) / scale)`` clipped to
``±levels``; int4 keeps the on-device block in int8 (values in
``[-7, 7]``) and lets the host pool pack two codes per byte.
"""
from __future__ import annotations

import dataclasses

import torch

# accepted ``RunConfig.state_dtype`` names (lower case) -> storage dtype
STATE_DTYPES = {
    "fp32": torch.float32, "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp16": torch.float16, "f16": torch.float16, "float16": torch.float16,
    "int8": torch.int8, "int4": torch.int8,
}


def bytes_of(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class StateStorage:
    """How one ``state_dtype`` name is physically stored.

    ``dtype``       on-device storage dtype of masked leaves
    ``levels``      quantization half-range (None for float codecs):
                    codes live in ``[-levels, levels]``
    ``pool_bits``   bits per element in the *host pool* (int4 packs two
                    codes per byte; everything else is ``itemsize * 8``)
    """

    name: str
    dtype: torch.dtype
    levels: int | None
    pool_bits: int

    @property
    def quantized(self) -> bool:
        return self.levels is not None


_STATE_STORAGE = {
    "fp32": StateStorage("fp32", torch.float32, None, 32),
    "bf16": StateStorage("bf16", torch.bfloat16, None, 16),
    "fp16": StateStorage("fp16", torch.float16, None, 16),
    "int8": StateStorage("int8", torch.int8, 127, 8),
    "int4": StateStorage("int4", torch.int8, 7, 4),
}
_STATE_ALIASES = {
    "f32": "fp32", "float32": "fp32", "bfloat16": "bf16",
    "f16": "fp16", "float16": "fp16",
}


def resolve_state_dtype(name):
    """Map a ``state_dtype`` config string to a torch dtype (None ->
    None)."""
    if name is None:
        return None
    key = str(name).lower()
    if key not in STATE_DTYPES:
        raise ValueError(
            f"unknown state dtype {name!r}; expected one of "
            f"{sorted(STATE_DTYPES)}")
    return STATE_DTYPES[key]


def resolve_state_storage(name) -> "StateStorage | None":
    """Full storage description for a ``state_dtype`` name (None ->
    None)."""
    if name is None:
        return None
    key = str(name).lower()
    key = _STATE_ALIASES.get(key, key)
    if key not in _STATE_STORAGE:
        raise ValueError(
            f"unknown state dtype {name!r}; expected one of "
            f"{sorted(STATE_DTYPES)}")
    return _STATE_STORAGE[key]

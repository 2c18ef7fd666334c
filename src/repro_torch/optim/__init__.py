"""Optimizers of the port: ASO-Fed's client update as a transform, and a
minimal optimizer library, over dicts of tensors."""
from repro_torch.optim.asofed import AsoFedSlots, asofed_transform, init_slots
from repro_torch.optim.optimizers import (Optimizer, adam, apply_updates,
                                          clip_by_global_norm,
                                          cosine_schedule, sgd)

__all__ = ["AsoFedSlots", "asofed_transform", "init_slots", "Optimizer",
           "adam", "apply_updates", "clip_by_global_norm", "cosine_schedule",
           "sgd"]

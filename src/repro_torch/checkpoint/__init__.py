"""Checkpoints and crash-resume run snapshots, in the JAX package's
on-disk format (``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.checkpoint.runstate import load_run_state, save_run_state

__all__ = ["load_checkpoint", "save_checkpoint",
           "load_run_state", "save_run_state"]

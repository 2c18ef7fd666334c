"""Model facade: the paper-scale families (``lstm``, ``cnn``), the dense
transformer trunk (``dense``), the VLM (``vlm``: M-RoPE and a patch
prefix), the MoE family (``moe``: GQA or MLA attention), the Mamba-1 SSM
(``ssm``), the RG-LRU hybrid (``hybrid``) and the audio encoder-decoder
(``audio``).

Mirrors ``repro.models.model.Model``: ``init`` / ``loss`` / ``predict``
over plain parameter dicts in the JAX layouts (``loss`` for every
family, the transformer's the training loss), plus ``prefill`` /
``decode_step`` / ``init_cache`` for serving every transformer family.
The paper
models' ``loss`` and ``predict`` accept single or client-stacked
parameters (see ``paper_nets``); a stacked loss is one value per client.
Entry points run on the CUDA card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as dec
from repro_torch.models import paper_nets as pn
from repro_torch.models import transformer as tf
from repro_torch.models.spec import init_params

PAPER_FAMILIES = ("lstm", "cnn")


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    spec: Any  # pn.Spec (paper models) | ParamDef tree (transformer)

    def init(self, generator: torch.Generator, device=None,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """Draw parameters with the JAX package's rules
        (``models/spec.py``) on ``device`` (``None``: the CUDA card).

        Paper models: ``fan_in`` leaves are N(0, 1) / sqrt(shape[-2])
        (shape[-1] for vectors), ``zeros`` leaves are zero, drawn in
        sorted key order from a CPU ``generator``, in fp32.  Transformer:
        ``repro_torch.models.spec.init_params`` (drawn on the generator's
        device, in ``dtype``).  One seed gives the same weights on every
        device; the values differ from ``jax.random``'s (to start from
        the JAX package's weights use
        ``repro_torch.models.convert.params_from_numpy``)."""
        dev = resolve_device(device)
        if self.cfg.family not in PAPER_FAMILIES:
            return init_params(self.spec, generator, dtype, dev)
        out = {}
        for name in sorted(self.spec):
            shape, init = self.spec[name]
            if init == "zeros":
                v = torch.zeros(shape, dtype=torch.float32)
            elif init == "fan_in":
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                v = torch.randn(shape, generator=generator,
                                dtype=torch.float32) / math.sqrt(
                                    max(fan_in, 1))
            else:
                raise ValueError(f"unknown init {init!r}")
            out[name] = v.to(dev)
        return out

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """(loss, metrics).  A transformer's is ``transformer.loss_fn``:
        the chunked cross-entropy plus 0.01 x the MoE load-balance term,
        metrics ``{"ce", "aux"}``, on the plain ``blocked_attention``
        (differentiable on every device).  Its Mamba and RG-LRU
        recurrences go through ``linear_scan``'s autograd Function: on
        the card K2 forward and K2's backward kernel, one launch each a
        recurrent layer, so every family trains on the card."""
        if self.cfg.family not in PAPER_FAMILIES:
            return tf.loss_fn(params, self.cfg, batch)
        pred = self.predict(params, batch)
        task = batch.get("task", "regression")
        if self.cfg.family == "cnn" or task == "classification":
            l = pn.classification_loss(pred, batch["y"])
        elif task == "multilabel":
            l = pn.multilabel_loss(pred, batch["y"])
        else:
            l = pn.regression_loss(pred, batch["y"])
        return l, {"loss": l}

    def predict(self, params, batch) -> torch.Tensor:
        if self.cfg.family == "lstm":
            return pn.lstm_forward(params, batch["x"])
        if self.cfg.family == "cnn":
            return pn.cnn_forward(params, batch["x"])
        return tf.logits_fn(params, self.cfg, batch)

    # -- serving (every transformer family) ------------------------------
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """(last-token logits (B, V), cache); ``batch`` holds ``tokens``
        and the family's stub, ``frames`` (audio, in the weights' dtype)
        or ``patches`` (vlm).  On the card one K3 launch (dense, vlm, GQA
        MoE), one K2 launch (ssm) per layer, none (MLA), (hybrid) one K2
        launch per RG-LRU layer and one K3 launch per attention layer, or
        (audio) one K3 launch per encoder and per decoder layer."""
        return dec.prefill(params, self.cfg, batch, max_len)

    def decode_step(self, params, cache, tokens, cur_index):
        """(logits (B, V), cache); writes the new K/V (dense, vlm,
        hybrid, moe, audio), latent (MLA) or recurrent state (ssm,
        hybrid) into ``cache``."""
        return dec.decode_step(params, self.cfg, cache, tokens, cur_index)

    def init_cache(self, batch_size: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
        """Dense, vlm, GQA MoE: K/V slots for ``max_len`` positions (the
        window's for the sliding-window variant); MLA: latent slots;
        ssm: the recurrent state, whose size
        does not depend on ``max_len``; hybrid: the RG-LRU layers' state
        and the attention layers' rings of ``min(max_len,
        local_window)`` slots; audio: the decoder's self K/V in
        ``max_len`` slots and the cross K/V of ``encoder_frames``
        encoder states a layer."""
        return dec.init_cache(self.cfg, batch_size, max_len, dtype,
                              resolve_device(device))


def build_spec(cfg: ModelConfig):
    if cfg.family == "lstm":
        return pn.lstm_spec(cfg)
    if cfg.family == "cnn":
        return pn.cnn_spec(cfg)
    return tf.build_spec(cfg)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, spec=build_spec(cfg))


def make_batch(cfg: ModelConfig, B: int, S: int, seed: int = 0,
               device=None, dtype: torch.dtype = torch.float32
               ) -> Dict[str, torch.Tensor]:
    """Random batch drawn with numpy from ``seed``, on ``device``
    (``None``: the card): tokens and labels, (B, S) int32 in [0, vocab),
    then the family's stub as standard normals in ``dtype``, ``frames``
    (B, encoder_frames, d) for audio or ``patches`` (B, n_patches, d)
    for vlm.  Tests hand the same numpy draws to both packages."""
    tf.check_family(cfg)
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    out = {name: torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              dtype=torch.int32, device=dev)
           for name in ("tokens", "labels")}
    stub = {"audio": ("frames", cfg.encoder_frames),
            "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if stub:
        x = rng.standard_normal((B, stub[1], cfg.d_model), dtype=np.float32)
        out[stub[0]] = torch.from_numpy(x).to(device=dev, dtype=dtype)
    return out

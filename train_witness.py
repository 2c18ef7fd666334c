"""Readings behind two choices of ``chip_smoke.py``'s SSM-training phases.

    python3 train_witness.py > train_witness.log

Needs one CUDA card with ~40 GB free and ~70 GB of host memory (a few
minutes on an H100).  Prints one JSON object a reading:

* ``fractions``: along client 0's first ASO-Fed step from the seed-0
  weights, the central difference of its batch's loss over 1/8 ...
  1/2048 of the step per unit of the gradient's prediction (what
  ``_first_step_check`` and ``_central_along_gradient`` gate at one
  fraction): Falcon-Mamba-7B at ``train_path_mamba``'s cut, as drawn,
  and RecurrentGemma-9B at ``train_step_rgemma``'s, as drawn and with
  every wq and wk scaled by ``TRAIN_COOL``.  Why the SSM family gates at
  ``TRAIN_FO_FRAC_SSM``.
* ``precision``: RecurrentGemma-9B's loss and gradient at
  ``train_card_vs_cpu``'s shape (3 layers, batch 1 x 32) from the same
  weights, as drawn and cooled, three ways: on the card in fp32, on the
  CPU in fp32, and on the CPU in fp64 with every fp32 the model asks
  for promoted to fp64 (``Promote64``).  Each leaf's gap per unit, as
  ``_grad_gaps`` measures it, for card vs CPU, card vs fp64 and CPU vs
  fp64.  Why its phases cool the attention.

* ``mla``: DeepSeek-V2-Lite-16B at ``train_path_deepseek``'s cut with
  its attention as drawn, with ``wq`` scaled by ``TRAIN_COOL`` (what
  scaling every attention's wq and wk does to MLA, which has no wk) and
  with its key up-projection ``w_uk`` scaled too: the layer-0 attention
  scores' spread, the first step's fractions as above, and the card's
  gradient against the CPU's under forced routing at
  ``train_card_vs_cpu``'s shape.  Which leaves its phases cool.
* ``families``: the fractions along the first ASO-Fed step of
  ``train_step_families``' Kimi-K2, Whisper-small and Qwen2-VL-72B cuts
  (cooled).  Which fraction each gates at.

    python3 train_witness.py --readings mla,families

runs only the readings named.  Imports ``chip_smoke`` from this
checkout for the phases' own helpers.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time

import torch
from torch.overrides import TorchFunctionMode

import chip_smoke as cs

FRACTIONS = (1 / 8, 1 / 32, 1 / 128, 1 / 512, 1 / 2048)


class Promote64(TorchFunctionMode):
    """Every torch call under it that asks for float32 gets float64
    instead (``x.to(torch.float32)``, ``dtype=torch.float32``); counts
    the float32 tensors that come out all the same in ``fp32_outputs``."""

    def __init__(self):
        super().__init__()
        self.fp32_outputs = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        def up(x):
            return torch.float64 if x is torch.float32 else x

        out = func(*(up(a) for a in args),
                   **{k: up(v) for k, v in (kwargs or {}).items()})
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.fp32_outputs += 1
        return out


def grad_fp64(model, params, batch):
    """(loss, [gradient of each leaf], float32 tensors seen) of the
    model on the CPU in fp64: ``params`` (CPU tensors) widened, the
    forward and backward under :class:`Promote64` with float64 as the
    default type.  The attention's checkpointed blocks run without the
    checkpoint: autograd recomputes a body outside the mode, and the
    checkpoint changes no value.  (The Mamba scan's autograd Function
    recomputes its chunks inside its own backward, in the inputs' fp64.)"""
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import attention

    wide = tree_map(lambda t: t.to(torch.float64), params)
    mode = Promote64()
    default = torch.get_default_dtype()
    kept = attention.checkpoint
    torch.set_default_dtype(torch.float64)
    attention.checkpoint = _no_checkpoint
    try:
        with mode:
            loss, g = cs._grad(model, wide, batch)
    finally:
        torch.set_default_dtype(default)
        attention.checkpoint = kept
    return loss, g, mode.fp32_outputs


def _no_checkpoint(fn, *args, **kwargs):
    """``torch.utils.checkpoint.checkpoint``'s call without the
    recompute."""
    return fn(*args)


def fractions():
    """The central difference per unit of its prediction at each of
    FRACTIONS (see the module docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, make_batch

    cfg = dataclasses.replace(get_arch(cs.MAMBA_ARCH), **cs.MAMBA_TRAIN_CUT)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cs.DEV).manual_seed(0),
                        device=cs.DEV)
    streams = cs._train_streams(cs.TRAIN_CLIENTS, cfg.vocab_size,
                                cs.TRAIN_TOKENS)
    ratios = {}
    for t in FRACTIONS:
        r = cs._first_step_check(model, params, streams, t)
        ratios[str(t)] = r["ratio"]
    cs.emit({"reading": "fractions", "arch": cfg.name,
             "n_layers": cfg.n_layers, "attention_wq_wk_scale": None,
             "batch": cs.TRAIN_B, "seq": cs.TRAIN_S,
             "whole_step_change": r["change"],
             "whole_step_predicted": r["predicted"],
             "ratio_by_fraction": ratios})
    del params, model
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_arch(cs.RGEMMA_ARCH), **cs.RGEMMA_TRAIN_CUT)
    model = build_model(cfg)
    batch = make_batch(cfg, cs.TRAIN_B, cs.TRAIN_S, seed=0, device=cs.DEV)
    step_eps = cs._first_asofed_step_eps(cs.TRAIN_CLIENTS)
    for cool in (False, True):
        params = model.init(torch.Generator(device=cs.DEV).manual_seed(0),
                            device=cs.DEV)
        if cool:
            params = cs._cool_attention(params)
        _, g = cs._grad(model, params, batch)
        ratios = {}
        for t in FRACTIONS:
            central, predicted = cs._central_along_gradient(
                model, params, g, batch, t, step_eps)
            ratios[str(t)] = central / predicted if predicted else math.nan
        cs.emit({"reading": "fractions", "arch": cfg.name,
                 "n_layers": cfg.n_layers,
                 "attention_wq_wk_scale": cs.TRAIN_COOL if cool else 1.0,
                 "batch": cs.TRAIN_B, "seq": cs.TRAIN_S,
                 "step_eps": step_eps, "ratio_by_fraction": ratios})
        del params, g
        torch.cuda.empty_cache()


def precision():
    """RecurrentGemma's gradient on the card, the CPU and the CPU in fp64
    (see the module docstring)."""
    from repro_torch.common.pytree import tree_flatten_with_path, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, make_batch

    cfg = dataclasses.replace(get_arch(cs.RGEMMA_ARCH), **cs.RGEMMA_TRAIN_CUT)
    model = build_model(cfg)
    batch = make_batch(cfg, cs.RGEMMA_CMP_B, cs.RGEMMA_CMP_S, seed=0,
                       device="cpu")
    for cool in (False, True):
        card_params = model.init(
            torch.Generator(device=cs.DEV).manual_seed(0), device=cs.DEV)
        if cool:
            card_params = cs._cool_attention(card_params)
        params = tree_map(lambda t: t.cpu(), card_params)
        paths = ["/".join(p) for p, _ in tree_flatten_with_path(params)]
        card_loss, card_g = cs._grad(
            model, card_params, {k: v.to(cs.DEV) for k, v in batch.items()})
        del card_params
        t0 = time.perf_counter()
        cpu_loss, cpu_g = cs._grad(model, params, batch)
        cpu_s = time.perf_counter() - t0
        card_cpu = cs._grad_gaps(paths, card_g, cpu_g)
        params = tree_map(lambda t: t.to(torch.float64), params)
        t0 = time.perf_counter()
        wide_loss, wide_g, fp32_seen = grad_fp64(model, params, batch)
        wide_s = time.perf_counter() - t0
        del params
        card_wide = cs._grad_gaps(paths, card_g, wide_g)
        cpu_wide = cs._grad_gaps(paths, cpu_g, wide_g)
        worst = {name: max(gaps, key=gaps.get) for name, gaps in (
            ("card_vs_cpu", card_cpu), ("card_vs_fp64", card_wide),
            ("cpu_vs_fp64", cpu_wide))}
        cs.emit({"reading": "precision", "arch": cfg.name,
                 "n_layers": cfg.n_layers, "batch": cs.RGEMMA_CMP_B,
                 "seq": cs.RGEMMA_CMP_S,
                 "attention_wq_wk_scale": cs.TRAIN_COOL if cool else 1.0,
                 "card_loss": float(card_loss), "cpu_loss": float(cpu_loss),
                 "fp64_loss": float(wide_loss),
                 "fp64_float32_tensors_seen": fp32_seen,
                 "card_vs_cpu": max(card_cpu.values()),
                 "card_vs_fp64": max(card_wide.values()),
                 "cpu_vs_fp64": max(cpu_wide.values()),
                 "worst_leaf": worst, "grad_floor_share": cs.GRAD_FLOOR,
                 "cpu_s": cpu_s, "fp64_s": wide_s,
                 "card_vs_cpu_by_leaf": card_cpu,
                 "card_vs_fp64_by_leaf": card_wide,
                 "cpu_vs_fp64_by_leaf": cpu_wide})
        del card_g, cpu_g, wide_g
        torch.cuda.empty_cache()


# the MLA coolings compared: the query and key leaves scaled by TRAIN_COOL
MLA_COOLINGS = ((), ("wq", "wk"), ("wq", "wk", "w_uk"))


def _score_spread(model, params, batch):
    """(std, max |score|) of the first attention's scores on ``batch``:
    ``blocked_attention``'s q . k times its scale, over every pair."""
    from repro_torch.models import attention

    inner, seen = attention.blocked_attention, []

    def spy(q, k, v, **kw):
        if not seen:
            scale = kw.get("scale") or 1.0 / math.sqrt(q.shape[-1])
            s = torch.einsum("bqkgd,btkd->bqkgt", q.float(), k.float()) * scale
            seen.append((float(s.std()), float(s.abs().max())))
        return inner(q, k, v, **kw)

    attention.blocked_attention = spy
    try:
        with torch.no_grad():
            model.loss(params, batch)
    finally:
        attention.blocked_attention = inner
    return seen[0]


def mla():
    """DeepSeek's coolings (see the module docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, make_batch

    cfg = dataclasses.replace(get_arch(cs.DEEPSEEK_ARCH),
                              **cs.DEEPSEEK_TRAIN_CUT)
    model = build_model(cfg)
    streams = cs._train_streams(cs.TRAIN_CLIENTS, cfg.vocab_size,
                                cs.TRAIN_TOKENS)
    _, _, _, B, S = cs.FAMILY_CMP[0]
    for leaves in MLA_COOLINGS:
        params = cs._cool_attention(model.init(
            torch.Generator(device=cs.DEV).manual_seed(0), device=cs.DEV),
            leaves)
        spread = _score_spread(model, params, make_batch(
            cfg, cs.TRAIN_B, cs.TRAIN_S, seed=0, device=cs.DEV))
        ratios = {str(t): cs._first_step_check(model, params, streams,
                                               t)["ratio"]
                  for t in FRACTIONS}
        rec, _ = cs._grad_card_vs_cpu(cfg, params, B, S)
        del params
        torch.cuda.empty_cache()
        cs.emit({"reading": "mla", "arch": cfg.name,
                 "n_layers": cfg.n_layers, "scaled_leaves": list(leaves),
                 "scale": cs.TRAIN_COOL, "score_std": spread[0],
                 "score_max_abs": spread[1],
                 "ratio_by_fraction": ratios,
                 "card_vs_cpu": {k: rec[k] for k in (
                     "batch", "seq", "loss_err_per_unit",
                     "grad_err_per_unit", "route_flips_by_layer",
                     "cpu_s")},
                 "card_vs_cpu_worst_leaf": max(
                     rec["grad_err_by_leaf"],
                     key=rec["grad_err_by_leaf"].get)})


def families():
    """The fractions of train_step_families' cuts (see the module
    docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, make_batch

    step_eps = cs._first_asofed_step_eps(cs.TRAIN_CLIENTS)
    for case, arch, cut, B, S in cs.TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_arch(arch), **cut)
        model = build_model(cfg)
        params = cs._cool_attention(model.init(
            torch.Generator(device=cs.DEV).manual_seed(0), device=cs.DEV))
        batch = make_batch(cfg, B, S, seed=0, device=cs.DEV)
        _, g = cs._grad(model, params, batch)
        ratios = {}
        for t in FRACTIONS:
            central, predicted = cs._central_along_gradient(
                model, params, g, batch, t, step_eps)
            ratios[str(t)] = central / predicted if predicted else math.nan
        cs.emit({"reading": "families", "case": case, "arch": cfg.name,
                 "n_layers": cfg.n_layers, "batch": B, "seq": S,
                 "scaled_leaves": list(cs.TRAIN_COOL_LEAVES),
                 "scale": cs.TRAIN_COOL, "step_eps": step_eps,
                 "ratio_by_fraction": ratios})
        del params, g, batch
        torch.cuda.empty_cache()


READINGS = {"fractions": fractions, "precision": precision, "mla": mla,
            "families": families}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--readings", default="fractions,precision",
                    help="comma-separated readings of " + ", ".join(READINGS))
    names = [r for r in ap.parse_args(argv).readings.split(",") if r]
    bad = sorted(set(names) - set(READINGS))
    if bad:
        ap.error(f"--readings takes {', '.join(READINGS)}; got {bad}")
    if not torch.cuda.is_available():
        print("train_witness: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(cs.card_line(), flush=True)
    cs.phase_build()
    for name in names:
        READINGS[name]()
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

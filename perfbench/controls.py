"""The controls and planted faults that the correctness limits are set
against (not run by the benchmark's own runs).

A control is the plain reference put in the program's place, computed in
the precision next below what the configuration states (training: fp32
with TF32 off, so TF32; serving: bf16, so fp8 e4m3), and read by the
same numbers as the program.  On the card, at a cell's own size::

    python3 perfbench/controls.py --workload fm7b.fedtrain --seeds 1 2 3 \
        --variants tf32 half_batch token slots
    python3 perfbench/controls.py --workload fm7b.prefill --seeds 1 2 3

prints one JSON line a seed with the numbers the cell compares.  The
program's own readings are those of ``perfbench/run.py``'s runs, which
print each number beside its limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

if __name__ == "__main__":
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0:1] = [_root, os.path.join(_root, "src")]

from perfbench import checks, harness, weights  # noqa: E402
from perfbench.drivers import common  # noqa: E402
from perfbench.reference import loop  # noqa: E402
from perfbench.traffic.generator import client_streams  # noqa: E402


def _inputs(cell, path: str, seed: int, device):
    from repro_torch.models import build_model

    held = cell.config["held"][path]
    pcfg = harness.port_config(cell, path)
    w = weights.draw(build_model(pcfg).spec, seed,
                     getattr(torch, held["dtype"]), device,
                     held.get("cooled"))
    return w, client_streams(pcfg.vocab_size, cell.traffic, seed), \
        held["num_hidden_layers"]


def gaps(ctl: dict, ref: dict) -> dict:
    """The training cell's numbers (``checks.train_numbers``) of ``ctl``
    against ``ref``, with the worst leaf's change and each arrival's gaps
    beside them."""
    got, seen = checks.train_numbers(ctl["losses"], ctl["changes"],
                                     ctl["slots"], ref)
    return {**got, "worst_change": seen["worst_change_leaf"][1],
            "loss_gaps": seen["loss_gaps"],
            "change_gaps": seen["change_gaps"]}


def train_gaps(cell, seed: int, device, variants=("tf32",)) -> dict:
    """The training cell's numbers for each of ``variants`` in the
    program's place, against one run of the fp32 reference: a precision
    (the reference in it) or a fault (``reference.loop.FAULTS``, planted
    in the fp32 reference).  ``{variant: numbers}``."""
    common.fp32_highest()
    w, streams, layers = _inputs(cell, "train", seed, device)
    mix, n = cell.traffic, cell.traffic["checked_arrivals"]
    ref = loop.run(w, streams, cell.config, layers, mix, seed, n)
    out = {"clients": ref["clients"]}
    for v in variants:
        common.release(device)
        fault = v if v in loop.FAULTS else None
        ctl = loop.run(w, streams, cell.config, layers, mix, seed, n,
                       "fp32" if fault else v, fault)
        out[v] = gaps(ctl, ref)
    return out


def prefill_gap(cell, seed: int, device, precision: str = "fp8") -> dict:
    """The prefill cell's numbers with the reference in ``precision`` in
    the program's place: the widest gap, in the fp32 reference's logits,
    of the token the lower precision puts first after each prompt, and
    the lower precision's logits against the fp32 reference's."""
    from perfbench.drivers.prefill import _Prompts, reference_gaps
    from perfbench.reference import models
    from perfbench.reference.precision import Precision

    common.fp32_highest()
    w, streams, layers = _inputs(cell, "serve", seed, device)
    mix = cell.traffic
    draw = _Prompts(streams, mix["batch"], mix["prompt_len"], seed)
    prompts = np.concatenate([draw() for _ in range(
        -(-mix["check_prompts"] // mix["batch"]))])[:mix["check_prompts"]]
    low = []
    with torch.no_grad():
        for s in range(0, len(prompts), mix["check_block"]):
            toks = torch.from_numpy(prompts[s:s + mix["check_block"]])
            low.append(models.last_logits(Precision(precision), w,
                                          toks.to(device), cell.config,
                                          layers).cpu())
    low = torch.cat(low)
    served_gap, logit_gap = reference_gaps(
        w, cell.config, layers, prompts, low.argmax(-1).numpy(), low,
        mix["check_block"], device)
    return {"served_gap": served_gap, "logit_gap": logit_gap}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a cell's control readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=None,
                    help="precisions and faults (training; default tf32) "
                         "or the precision (prefill; default fp8)")
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    harness.check_card(cell.chips)
    kind = cell.traffic["driver"]
    for seed in args.seeds:
        if kind == "fedtrain":
            got = train_gaps(cell, seed, "cuda", args.variants or ["tf32"])
        else:
            prec = (args.variants or ["fp8"])[0]
            got = {prec: prefill_gap(cell, seed, "cuda", prec)}
        print(json.dumps({"workload": cell.name, "seed": seed, **got}),
              flush=True)
        common.release("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving prefill, ``repro_torch.launch.serve.serve(..., gen=0)``:
prefill and the first greedy token (time to first token), closed loop,
one call after another.

Set-up draws the weights in the served type and the clients' streams
from the seed, and runs one warm call at the window's shape.  The window
sends calls of ``batch`` prompts of ``prompt_len`` tokens, each prompt a
window of a client's stream drawn from the seed, until ``seconds`` have
passed; it ends when the last call returns.  ``prefill_tokens_per_s``
is every call's prompt tokens over the window's wall time.  Traced, the
window is ``traced_calls`` calls under the profiler.

Checked once the window has closed: a sample of ``check_prompts`` of the
window's prompts, drawn from the seed, and the reference's logits after
each whole prompt, ``check_block`` prompts at a time.  Two numbers: the
widest gap by which the served token's logit lies below the reference's
best (``served_gap``), and the program's own last-position logits (a
host copy of each call's, taken as the prefill returns them) against the
reference's: the largest difference over the prompt's largest reference
logit, the widest over the sample (``logit_gap``).
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import checks, counting, peaks, tracing, weights
from perfbench.drivers import common
from perfbench.harness import Outcome, port_config
from perfbench.reference import models
from perfbench.reference.precision import Precision
from perfbench.traffic.generator import client_streams


class _Prompts:
    """Batches of prompts, each a window of a client's stream."""

    def __init__(self, streams, batch: int, length: int, seed: int):
        self.streams, self.batch, self.length = streams, batch, length
        self.rng = np.random.default_rng([seed, 1])

    def __call__(self) -> np.ndarray:
        c = self.rng.integers(0, len(self.streams), size=self.batch)
        out = []
        for ci in c:
            s = self.streams[ci]
            start = self.rng.integers(0, len(s) - self.length + 1)
            out.append(s[start:start + self.length])
        return np.stack(out).astype(np.int32)


class _Logits:
    """The model's ``prefill``, keeping a host copy of the last-position
    logits of every call."""

    def __init__(self, fn):
        self.fn, self.rows = fn, []

    def __call__(self, params, batch, max_len=None):
        logits, cache = self.fn(params, batch, max_len=max_len)
        self.rows.append(logits.detach().cpu())
        return logits, cache


def reference_gaps(w, sz, layers, prompts: np.ndarray, served: np.ndarray,
                   logits, block: int, device, precision: str = "fp32"):
    """The reference run ``block`` prompts at a time:  (the widest gap
    of a served token below the reference's best logit, the widest of
    ``|logits - reference|`` over each prompt's largest ``|reference|``).
    ``logits`` (prompts, V) may be None: the second number is then
    None."""
    P = Precision(precision)
    served_gap, logit_gap = [], []
    with torch.no_grad():
        for s in range(0, len(prompts), block):
            toks = torch.from_numpy(prompts[s:s + block]).to(device)
            lg = models.last_logits(P, w, toks, sz, layers)
            got = torch.from_numpy(served[s:s + block]).to(device).long()
            served_gap += (lg.max(-1).values
                           - lg.gather(1, got[:, None])[:, 0]).tolist()
            if logits is not None:
                prog = logits[s:s + block].to(device, torch.float32)
                logit_gap += ((prog - lg).abs().amax(-1)
                              / lg.abs().amax(-1)).tolist()
    return max(served_gap), (max(logit_gap) if logit_gap else None)


def run(cell, *, seed: int, seconds: float, trace: bool, device) -> Outcome:
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    mix, cfg = cell.traffic, cell.config
    dev = torch.device(device)
    common.fp32_highest()
    held = cfg["held"]["serve"]
    layers = held["num_hidden_layers"]
    pcfg = port_config(cell, "serve")
    model = build_model(pcfg)
    w = weights.draw(model.spec, seed, getattr(torch, held["dtype"]), dev,
                     held.get("cooled"))
    streams = client_streams(pcfg.vocab_size, mix, seed)
    B, L = mix["batch"], mix["prompt_len"]
    prompts = _Prompts(streams, B, L, seed)

    t_inputs = time.perf_counter()
    serve(model, w, prompts(), mix["gen"], device=dev)  # warm call
    common.sync(dev)
    print(f"set-up: inputs {t_inputs - cell.t0:.2f} s, warm call "
          f"{time.perf_counter() - t_inputs:.2f} s", file=sys.stderr)

    tr = tracing.Trace(dev) if trace else None
    sent, served, finite = [], [], []
    model.prefill = kept = _Logits(model.prefill)
    if tr is not None:
        tr.start()
    t0 = time.perf_counter()
    while True:
        toks = prompts()
        out, stats = serve(model, w, toks, mix["gen"], device=dev)
        sent.append(toks)
        served.append(out[:, 0].numpy())
        finite.append(stats["finite_logits"])
        if (len(sent) >= mix["traced_calls"] if trace
                else time.perf_counter() - t0 >= seconds):
            break
    common.sync(dev)
    t_end = time.perf_counter()
    if tr is not None:
        tr.stop()
    del model.prefill
    window_s = t_end - t0
    peak = common.memory_peak(dev)
    calls = len(sent)
    values = {"prefill_tokens_per_s": calls * B * L / window_s,
              "peak_device_gib": peak / 2 ** 30}
    ctx = None
    if trace:
        params, _ = counting.model_matmul(cfg, layers, L)
        head = cfg["hidden_size"] * cfg["vocab_size"]
        # the head multiplies only the last position of each prompt
        ctx = SimpleNamespace(
            trace=tr.summary(), units=calls,
            flops_per_unit=2.0 * ((params - head) * B * L + head * B),
            peak_flops=peaks.flops(held["dtype"]),
            scan_fwd_shape=(B, L, pcfg.d_inner, pcfg.ssm_state,
                            w["embed"]["table"].element_size()))
    common.release(dev)

    rng = np.random.default_rng([seed, 2])
    n = min(mix["check_prompts"], calls * B)
    pick = np.sort(rng.choice(calls * B, size=n, replace=False))
    t_ref = time.perf_counter()
    served_gap, logit_gap = reference_gaps(
        w, cfg, layers, np.concatenate(sent)[pick],
        np.concatenate(served)[pick], torch.cat(kept.rows)[pick],
        mix["check_block"], dev)
    print(f"reference: {n} prompts {time.perf_counter() - t_ref:.2f} s",
          file=sys.stderr)
    return Outcome(
        values=values, attempted=calls,
        failed=int(sum(not f for f in finite)),
        checks={"served_gap": checks.entry(served_gap,
                                           cell.limits["served_gap"]),
                "logit_gap": checks.entry(logit_gap,
                                          cell.limits["logit_gap"])},
        memory_peak_bytes=peak, window_start=t0, ctx=ctx)

"""ASO-Fed's federated training loop, ``repro_torch.launch.train.train``,
closed loop: one arrival after another.

Set-up draws the weights and the clients' streams from the seed, runs a
short warm call of the loop (every kernel built, every shape seen; its
arrival time sets the window's arrival count), then starts the one call
that the window measures.  That call's first ``setup_arrivals`` arrivals
are set-up too: the first ``checked_arrivals`` of them are what the
reference follows (their losses, the first arrival's gradient as the
optimizer took it, the server model's change over them), and the
window opens when the loop reports the end of arrival
``setup_arrivals``.  The window is the rest of the call, to its return.

End-to-end: ``fedtrain_tokens_per_s``, every window arrival's batch x
seq tokens over the window's wall time; ``arrival_ms_p90``, the 90th
percentile (linear) of the window's arrival times (the loop's
``step_s``: local step, fold, feature pass, ended by reading the loss);
``peak_device_gib``.  Traced (``--trace 1``), the window is
``traced_arrivals`` arrivals under the profiler, with spans around the
loop's local step, ASO-Fed transform, fold and feature pass.
"""
from __future__ import annotations

import json
import math
import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import checks, counting, peaks, tracing, weights
from perfbench.drivers import common
from perfbench.harness import Outcome, RunError, port_config
from perfbench.reference import loop
from perfbench.traffic.generator import client_streams

SPANS = ("local_step", "asofed_transform", "server_fold",
         "apply_feature_learning")


class _Capture:
    """Wrappers of the loop's functions that read, during set-up, what
    the reference is compared with: after each of the first ``checked``
    arrivals, each leaf's norm of the arriving client's new ``h`` and
    ``v`` slots and of the server model's change."""

    def __init__(self, w0_flat, checked: int):
        self.w0 = w0_flat
        self.checked = checked
        self.slots = []
        self.changes = []

    def local_step(self, fn):
        def inner(*args, **kwargs):
            out = fn(*args, **kwargs)
            if len(self.slots) < self.checked:
                self.slots.append({k: checks.leaf_norms(
                    weights.flat(getattr(out[1], k))) for k in ("h", "v")})
            return out
        return inner

    def fold(self, fn):
        def inner(*args, **kwargs):
            out = fn(*args, **kwargs)
            if len(self.changes) < self.checked:
                self.changes.append(
                    checks.leaf_norms(weights.flat(out), self.w0))
            return out
        return inner


class _WindowStart:
    """The loop's ``log``: called at the end of arrival 1 and of every
    tenth, after the arrival's loss was read.  At ``at`` it opens the
    window (and starts the trace)."""

    def __init__(self, at: int, trace=None):
        self.at, self.trace, self.t = at, trace, None

    def __call__(self, msg: str):
        if int(msg.split()[1]) == self.at:
            if self.trace is not None:
                self.trace.start()
            self.t = time.perf_counter()


def _inputs(cell, seed: int, device):
    """The port's model, the weights from the seed, the clients' streams
    and the loop's keyword arguments."""
    from repro_torch.models import build_model

    mix = cell.traffic
    held = cell.config["held"]["train"]
    pcfg = port_config(cell, "train")
    model = build_model(pcfg)
    w0 = weights.draw(model.spec, seed, getattr(torch, held["dtype"]),
                      device, held.get("cooled"))
    streams = client_streams(pcfg.vocab_size, mix, seed)
    kw = dict(batch=mix["batch"], seq=mix["seq"], eta=mix["eta"],
              lam=mix["lam"], beta=mix["beta"],
              feature_learning=mix["feature_learning"], seed=seed,
              device=device, log=None)
    return pcfg, model, w0, streams, kw


def _wrappers(cap: _Capture, mix: dict, trace: bool):
    wrappers = {"local_step": cap.local_step,
                ("apply_feature_learning" if mix["feature_learning"]
                 else "server_fold"): cap.fold}
    if not trace:
        return wrappers
    return {name: (lambda fn, name=name, w=wrappers.get(name):
                   tracing.span(name)(w(fn) if w else fn))
            for name in SPANS}


def numbers(cell, losses, cap: _Capture, w0, streams, seed: int) -> dict:
    """The numbers compared, each beside its limit: the program's first
    arrivals against the reference's (``checks.train_numbers``), up to
    the first returning client.  ``checked_arrivals`` is one more than
    the clients, so some client returns: its step takes its ``h`` and
    ``v`` slots, its mean delay and the server model it pulled."""
    mix, cfg = cell.traffic, cell.config
    n = mix["checked_arrivals"]
    if n <= mix["clients"]:
        raise RunError(f"checked_arrivals {n} must exceed the clients "
                       f"{mix['clients']}, so that a client returns")
    t_ref = time.perf_counter()
    on_card = w0["embed"]["table"].is_cuda
    if on_card:  # the run's peak was read before: this reads the reference's
        torch.cuda.reset_peak_memory_stats()
    ref = loop.run(w0, streams, cfg, cfg["held"]["train"]["num_hidden_layers"],
                   mix, seed, n)
    ref_peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"reference: {n} arrivals in {time.perf_counter() - t_ref:.2f} s, "
          f"peak {ref_peak / 2 ** 30:.2f} GiB", file=sys.stderr)
    got, seen = checks.train_numbers(losses[:n], cap.changes, cap.slots, ref)
    print(f"per arrival: {json.dumps(seen)}", file=sys.stderr)
    return {k: checks.entry(v, cell.limits[k]) for k, v in got.items()}


def run(cell, *, seed: int, seconds: float, trace: bool, device) -> Outcome:
    from repro_torch.launch import train as T

    mix, cfg = cell.traffic, cell.config
    dev = torch.device(device)
    common.fp32_highest()
    layers = cfg["held"]["train"]["num_hidden_layers"]
    pcfg, model, w0, streams, kw = _inputs(cell, seed, dev)
    B, S = mix["batch"], mix["seq"]

    t_inputs = time.perf_counter()
    warm = T.train(model, w0, streams, steps=mix["warm_arrivals"], **kw)
    arrival_s = statistics.median(warm["step_s"][1:])
    del warm
    common.sync(dev)
    t_warm = time.perf_counter()

    n_setup = mix["setup_arrivals"]
    n_window = (mix["traced_arrivals"] if trace else
                max(mix["min_window_arrivals"],
                    math.ceil(seconds / arrival_s)))
    tr = tracing.Trace(dev) if trace else None
    cap = _Capture(weights.flat(w0), mix["checked_arrivals"])
    start = _WindowStart(n_setup, tr)
    with tracing.patched(T, _wrappers(cap, mix, trace)):
        res = T.train(model, w0, streams, steps=n_setup + n_window,
                      **{**kw, "log": start})
        common.sync(dev)
        t_end = time.perf_counter()
        if tr is not None:
            tr.stop()
    if start.t is None:
        raise RunError("the loop never reported the window's start")
    print(f"set-up: inputs {t_inputs - cell.t0:.2f} s, warm call "
          f"{t_warm - t_inputs:.2f} s, {n_setup} set-up arrivals "
          f"{start.t - t_warm:.2f} s; window {n_window} arrivals",
          file=sys.stderr)
    window_s = t_end - start.t
    peak = common.memory_peak(dev)
    step_s = res["step_s"][n_setup:]
    losses = res["losses"]
    failed = int(sum(not math.isfinite(x) for x in losses[n_setup:]))
    values = {"fedtrain_tokens_per_s": n_window * B * S / window_s,
              "arrival_ms_p90": float(np.percentile(step_s, 90)) * 1e3,
              "peak_device_gib": peak / 2 ** 30}
    ctx = None
    if trace:
        params, attn = counting.model_matmul(cfg, layers, S)
        emb = w0["embed"]["table"]
        ctx = SimpleNamespace(
            trace=tr.summary(), units=n_window,
            flops_per_unit=(counting.train_flops_per_token(params) * B * S
                            + 3 * attn * B),
            peak_flops=peaks.flops(cfg["held"]["train"]["dtype"]),
            k1_shape=(emb.shape[0], emb.shape[1], emb.element_size()),
            scan_bwd_shape=((B, S, pcfg.d_inner, pcfg.ssm_state,
                             counting.scan_chunk(S))
                            if cfg["family"] == "ssm" else None))
    del res
    common.release(dev)
    return Outcome(values=values, attempted=n_window, failed=failed,
                   checks=numbers(cell, losses, cap, w0, streams, seed),
                   memory_peak_bytes=peak, window_start=start.t, ctx=ctx)

"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in this
checkout, holds each against its plain PyTorch version on the card, and
drives the port's paths through its entry points:

* ``main_path``: ASO-Fed with the sequential fold on ``lstm_regression``
  at the paper LSTM's registered width (hidden 64), which runs the fused
  fold kernel (``feature_fold``: K1's feature pass redesigned as the
  whole tick's sequential fold) once per tick;
* ``assoc_path``: FedAsync with the associative fold on the same
  workload, which runs the linear-recurrence kernel (K2) once per
  carrier leaf per tick;
* ``serve_path``: ``repro_torch.launch.serve.serve`` on TinyLlama-1.1B
  at its full width and depth (random weights from seed 0), batch 8,
  prompt 2016, 32 greedy tokens, which runs the flash-attention kernel
  (K3) once per layer of the prefill: fp32 (K3's CUDA-core design);
* ``serve_path_bf16``: the same serve with the seed-0 weights drawn in
  bf16 (``Model.init(..., dtype=torch.bfloat16)``), which runs K3's
  tensor-core (wgmma) design once per layer of the prefill;
* ``oracle_path``: the port's per-arrival oracles
  (``repro_torch.sim.reference``) at main_path's shape, each held
  against the engine on the card; ASO-Fed's folds through
  ``core.server.aggregate``, one per-row K1 launch a fold;
* ``sweep_path``: Local-S and Global (the sweep schedule) at main_path's
  fleet, 16 rounds, and one profiled run each;
* ``paper_rows``: the eight rows of the paper's Table 5.1 on the
  Air-Quality-like data through ``repro_torch.core.run``, at
  ``benchmarks/paper_tables.py``'s default (quick-mode) settings;
* ``residency_path``: the JAX bench's K-sweep shape at main_path's
  width, 64 real clients padded to 10,000 registered ones, with the
  client state stored in fp32, bf16, int8 and int4 on the card or in
  the host pool (``state_residency="host"``): asofed's sequential fold
  (``feature_fold`` once a tick) and fedasync's associative one (K2),
  host and device bit for bit, pool bytes from the leaf table, and the
  int8 host engine against the port's oracle on the card;
* ``resume_path``: crash-resume at main_path's shape: asofed (sequential
  fold), fedasync (associative) and asofed under chaos_path's faults,
  each run plain, checkpointing every 128 iterations (bit for bit the
  plain run) and resumed from the last snapshot (the plain run's final
  weights bit for bit, ``feature_fold`` or K2 launched on every resumed
  tick); then residency_path's int8 host pool at K=10,000 the same way;
* ``serve_path_phi4``: ``serve`` on phi4-mini-3.8B at full width and
  depth in bf16 (head dim 128, 24 heads over 8 KV heads), which runs
  K3's bf16 hd-128 instance once per layer of the prefill;
* ``chaos_path``: main_path's shape under the chaos layer
  (``tests/test_faults.py``'s mixed faults at rate 0.15 and its guards,
  ``max_staleness`` 8 and ``max_delta_norm`` 0.5): asofed with the
  ``random_mask`` upload codec (``feature_fold`` once a tick, with each
  slot's fold count read on the card), fedasync associative under noise
  corruption, the downweight policy and ``quantized_delta`` (K2 five
  times a tick), fedbuff sequential; host and device residency bit for
  bit, the port's asofed oracle against the engine (one per-row K1
  launch a server fold, two for a duplicate), the card against the CPU,
  and the synchronizing calls of a chaos window against main_path's.

Before the paths, ``fold_vs_plain`` holds ``feature_fold`` against its
plain version (the per-arrival loop) and times it beside the per-arrival
chain it replaced (the loop with K1 in it), with and without a per-slot
fold count (``reps``: 0, 1 or 2 folds a slot).  Each path is driven with
the launch counts set to 0 just before it and read just after.  Then
the card's trajectories are held against the CPU's for every ported
strategy, the associative fold against the sequential one on the card,
and the card's prefill and teacher-forced decode logits against the
CPU's.  Prints one JSON line per phase, then a
``{"kernels": [...]}`` line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before that line; without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# fp32 operations per element of the feature pass: |w|, max, sub, exp,
# sum, w*w + sum, divide, scale by w, out*out + sum, rescale
FEATURE_OPS_PER_ELEM = 12
FEATURE_SHAPES = [(8, 256), (32, 32), (9, 32), (8, 32), (100, 33), (9, 129),
                  (257, 64), (3, 3, 1, 16), (2, 64, 128), (4096, 1024)]
# kernel vs plain version: max abs error per unit of the output's largest
# magnitude.  The two sum each row in a different order, and normalized
# rows reach |out| of 8-32, where one fp32 ulp is already 1e-6 to 4e-6:
# an absolute 1e-6 would demand bitwise-equal reductions.
TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
# linear recurrence (K2) cases: (shape, a broadcast over C).  The main
# path's carrier leaves at its S=64 bucket (paper LSTM at hidden 64:
# w_x, w_h, b, fc_w, fc_b), tests/test_kernels.py's grid, S=1 and a
# prime S, the CNN's fc_w at S=256, and a long Mamba-like scan.
SCAN_MAIN = [(1, 64, 2048), (1, 64, 16384), (1, 64, 256), (1, 64, 64),
             (1, 64, 1)]
SCAN_CASES = ([(s, True) for s in SCAN_MAIN]
              + [(s, False) for s in [(2, 64, 32), (1, 128, 16), (2, 100, 8),
                                      (1, 256, 128), (2, 32, 4)]]
              + [((1, 1, 2048), True), ((1, 13, 2048), True),
                 ((1, 256, 62720), True), ((4, 4096, 1024), False)])
# per unit of the output's largest magnitude (at least 1): with a up to
# 0.999 the state reaches |h| of 10-30
SCAN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# identical main-path runs, each with its own launch count check: the
# spread of iters/s within one call on one card
MAIN_PATH_REPEATS = 5
ASSOC_PATH_REPEATS = 3
# the main path's shape (see _main_path_run)
MAIN_CLIENTS, MAIN_HIDDEN, MAIN_T = 256, 64, 512
# feature_fold cases: (name, workload, hidden, S, n_real, a client twice).
# The main path's tick (S = 64 bucket, 51.2 arrivals a tick on average),
# one arrival, a full bucket, a repeated client, the CNN's conv1_w (9, C)
# at C = 12 and 32, lstm_multilabel's (32, 4H), and a first layer wider
# than 1024 columns (4H = 1500: the shared-memory row)
FOLD_CASES = [("main_tick", "lstm_regression", MAIN_HIDDEN, 64, 51, False),
              ("one", "lstm_regression", MAIN_HIDDEN, 64, 1, False),
              ("full", "lstm_regression", MAIN_HIDDEN, 64, 64, False),
              ("repeat", "lstm_regression", MAIN_HIDDEN, 64, 51, True),
              ("cnn_c12", "cnn_classification", 12, 32, 25, False),
              ("cnn_c32", "cnn_classification", 32, 32, 25, False),
              ("multilabel", "lstm_multilabel", MAIN_HIDDEN, 64, 51, False),
              ("wide", "lstm_regression", 375, 16, 11, False)]
# the fused fold's first layer against its plain version: per arrival
# K1's fp32 bound (1e-6 per unit of the largest magnitude), compounded
# over the tick's arrivals (each starts from the previous one's result)
FOLD_TOL_PER_ARRIVAL = 1e-6
# feature_fold with a per-slot fold count at the main path's tick: (name,
# pattern of the 51 real slots' counts).  The gate is sum(reps) x 1e-6
# per unit: one FOLD_TOL_PER_ARRIVAL a fold
FOLD_REPS_CASES = [("main_tick_reps", "mixed"), ("main_tick_dup", "dup_all"),
                   ("main_tick_skip", "skip_half")]
# carrier leaves of the paper LSTM (w_x, w_h, b, fc_w, fc_b): K2 launches
# per associative tick
LSTM_LEAVES = 5
# engine-vs-oracle tolerance of the repo's tests (tests/test_sim_engine.py)
TRAJ_ATOL, TRAJ_RTOL = 3e-4, 3e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _median_event_ms(run, reps: int, trials: int = 7) -> float:
    per = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return statistics.median(per)


def call_ms(fn, reps: int = 100) -> float:
    """Per-call time of ``reps`` eager back-to-back calls (CUDA events,
    median of 7 after a warm-up): what a caller pays, host work
    included — at small shapes the host's launch cost, not the card."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return _median_event_ms(run, reps)


def device_ms(fn, reps: int = 100) -> float:
    """Per-call device time: ``reps`` calls captured into one CUDA graph
    and replayed between CUDA events (median of 7 after a warm-up), so
    the host's launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, reps)


def feature_bound(rows: int, cols: int, itemsize: int):
    """(bound_ms, bound_by): bytes read once + written once over HBM
    bandwidth, against the fp32 operations over the fp32 peak."""
    bytes_ms = 2 * rows * cols * itemsize / HBM_BYTES_PER_S * 1e3
    ops_ms = FEATURE_OPS_PER_ELEM * rows * cols / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def scan_bound(a: torch.Tensor, b: torch.Tensor):
    """(bound_ms, bound_by) of the recurrence: a and b read once, h and
    h_last written once, over HBM bandwidth, against one multiply and one
    add per element of b in fp32 (bf16 inputs are computed in fp32)."""
    B, S, C = b.shape
    nbytes = (a.numel() + 2 * b.numel() + B * C) * b.element_size()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * b.numel() / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, (_, log) in build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": seconds,
          "libraries": {n: os.path.relpath(p, HERE)
                        for n, p in paths.items()},
          "ptxas": ptxas})


def phase_kernel_vs_plain():
    from repro_torch.kernels.feature_attention.kernel import (
        feature_attention_kernel)
    from repro_torch.kernels.feature_attention.ref import (
        feature_attention_ref)

    rng = np.random.default_rng(0)
    rows_out = {}
    for shape in FEATURE_SHAPES:
        x = rng.standard_normal(shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            w = torch.tensor(x, device="cuda").to(dtype)
            w2 = w.reshape(-1, shape[-1]).contiguous()
            for normalize in (True, False):
                got = feature_attention_kernel(w2, normalize)
                want = feature_attention_ref(w2, normalize)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                tol = TOL[dtype] * max(1.0, float(want.float().abs().max()))
                if not (got.dtype == dtype and err < tol):
                    raise AssertionError(
                        f"feature_attention kernel disagrees with its plain "
                        f"version at {shape} {dtype} normalize={normalize}: "
                        f"max abs err {err} (tolerance {tol})")
                kern = lambda: feature_attention_kernel(  # noqa: E731
                    w2, normalize)
                plain = lambda: feature_attention_ref(  # noqa: E731
                    w2, normalize)
                bound_ms, bound_by = feature_bound(
                    w2.shape[0], w2.shape[1], w2.element_size())
                rec = {"phase": "kernel_vs_plain",
                       "kernel": "feature_attention",
                       "shape": list(shape), "dtype": str(dtype),
                       "normalize": normalize, "max_abs_err": err,
                       "tolerance": tol, "ms": device_ms(kern),
                       "plain_ms": device_ms(plain),
                       "call_ms": call_ms(kern),
                       "plain_call_ms": call_ms(plain),
                       "bound_ms": bound_ms, "bound_by": bound_by}
                emit(rec)
                rows_out[(tuple(shape), dtype, normalize)] = rec
    return rows_out


def _scan_case(a, b, check_tol: float):
    """Kernel vs plain version on (a, b); returns the case record."""
    from repro_torch.kernels.linear_scan.kernel import linear_scan_kernel
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref

    h, h_last = linear_scan_kernel(a, b)
    want, want_last = linear_scan_ref(a, b)
    torch.cuda.synchronize()
    err = max(float((h.float() - want.float()).abs().max()),
              float((h_last.float() - want_last.float()).abs().max()))
    tol = check_tol * max(1.0, float(want.float().abs().max()))
    if not (h.dtype == b.dtype and err < tol):
        raise AssertionError(
            f"linear_scan kernel disagrees with its plain version at "
            f"{tuple(b.shape)} {b.dtype} (a {tuple(a.shape)}): max abs "
            f"err {err} (tolerance {tol})")
    kern = lambda: linear_scan_kernel(a, b)  # noqa: E731
    plain = lambda: linear_scan_ref(a, b)  # noqa: E731
    S = b.shape[1]
    bound_ms, bound_by = scan_bound(a, b)
    return {"phase": "kernel_vs_plain", "kernel": "linear_scan",
            "shape": list(b.shape), "a_shape": list(a.shape),
            "dtype": str(b.dtype), "max_abs_err": err, "tolerance": tol,
            "ms": device_ms(kern), "call_ms": call_ms(kern),
            # the plain loop issues 2 S + 1 ops a call: fewer per graph
            "plain_ms": device_ms(plain, reps=max(1, min(100, 1000 // S))),
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_scan_vs_plain():
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref

    rng = np.random.default_rng(0)
    rows_out = {}
    for shape, bcast in SCAN_CASES:
        B, S, C = shape
        a_np = rng.uniform(0.5, 0.999, (B, S, 1 if bcast else C))
        b_np = rng.standard_normal(shape)
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.tensor(a_np, dtype=torch.float32,
                             device="cuda").to(dtype)
            b = torch.tensor(b_np, dtype=torch.float32,
                             device="cuda").to(dtype)
            rec = _scan_case(a, b, SCAN_TOL[dtype])
            emit(rec)
            rows_out[(shape, dtype, "uniform")] = rec
    # a = 1, what the fedbuff, fedavg and ASO-Fed(-F) folds feed it: the
    # recurrence is then a prefix sum, and torch.cumsum along S is the
    # library yardstick (timed here, used nowhere in the port)
    for shape in SCAN_MAIN:
        B, S, C = shape
        a = torch.ones((B, S, 1), dtype=torch.float32, device="cuda")
        b = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device="cuda")
        rec = _scan_case(a, b, SCAN_TOL[torch.float32])
        lib = lambda: torch.cumsum(b, dim=1)  # noqa: E731
        lib_err = float((lib() - linear_scan_ref(a, b)[0]).abs().max())
        rec.update(case="a=1", library="torch.cumsum along S",
                   library_ms=device_ms(lib), library_max_abs_err=lib_err)
        emit(rec)
        rows_out[(shape, torch.float32, "ones")] = rec
    return rows_out


def fold_bound(w, S: int, n_real: int, rows: int, cols: int, n_len: int,
               folds=None):
    """(bound_ms, bound_by) of one tick's fused fold on these inputs:
    every leaf read once and written once, the real slots' uploads, idx
    (int64), n_vis (and reps, int32, when given) read, all S received
    models written, n read and written, over HBM bandwidth; against the
    axpy's multiply and add on every element and the feature pass on the
    first layer, per fold (``folds``: sum(reps); None: one a real
    arrival), over the fp32 peak."""
    numel = sum(x.numel() for x in w.values())
    nbytes = 4 * ((2 + n_real + S) * numel + 2 * n_len) + 12 * n_real \
        + (0 if folds is None else 4 * n_real)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops = (n_real if folds is None else folds) * (
        2 * numel + FEATURE_OPS_PER_ELEM * rows * cols)
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def _fold_inputs(name: str, hidden: int, S: int, n_real: int,
                 repeat: bool, seed: int):
    """One tick of ASO-Fed's fold on the card: the workload's model at
    ``hidden`` (seeded init) as the server, uploads at the scale of real
    deltas and whole-number counts for MAIN_CLIENTS clients from a seeded
    numpy generator; padded slots on the scratch row."""
    from repro_torch.sim.workloads import get_workload

    wl = get_workload(name)
    cfg_model, model = wl.build(hidden=hidden)
    w = model.init(torch.Generator().manual_seed(seed), device=DEV)
    rng = np.random.default_rng(seed)
    d = {k: torch.tensor(1e-2 * rng.standard_normal((S,) + tuple(v.shape)),
                         dtype=torch.float32, device=DEV)
         for k, v in w.items()}
    n = np.zeros(MAIN_CLIENTS + 1, np.float32)
    n[:MAIN_CLIENTS] = rng.integers(1, 40, MAIN_CLIENTS)
    idx = np.full(S, MAIN_CLIENTS, np.int64)
    idx[:n_real] = rng.permutation(MAIN_CLIENTS)[:n_real]
    if repeat:
        idx[n_real - 1] = idx[0]
    n_vis = n[idx] + rng.integers(0, 6, S)
    n_vis[n_real:] = 0.0
    as_t = lambda a: torch.tensor(a, device=DEV)  # noqa: E731
    return (wl, cfg_model, model, w, d, as_t(n), as_t(idx),
            as_t(n_vis.astype(np.float32)))


def _fold_check(tag, got, want, first, n_real, gate):
    """Raises unless leaves other than ``first`` and n are bitwise equal
    and ``first`` is within ``gate`` per unit of its largest magnitude;
    returns (max abs error, per unit) of the first layer."""
    (w_a, n_a, rec_a), (w_b, n_b, rec_b) = got, want
    if not torch.equal(n_a, n_b):
        raise AssertionError(f"{tag}: post-tick counts differ")
    err = per_unit = 0.0
    for part_a, part_b in ((w_a, w_b), (rec_a, rec_b)):
        for k, b in part_b.items():
            a = part_a[k]
            if k != first:
                if not torch.equal(a, b):
                    raise AssertionError(f"{tag}: leaf {k} not bitwise "
                                         "equal")
                continue
            e = float((a - b).abs().max())
            err = max(err, e)
            per_unit = max(per_unit, e / max(1.0, float(b.abs().max())))
    if not per_unit <= gate:
        raise AssertionError(f"{tag}: first layer {first} off by {per_unit} "
                             f"per unit (gate {gate})")
    return err, per_unit


def phase_fold_vs_plain():
    """The fused fold (``feature_fold``) against its plain version (the
    per-arrival loop in plain PyTorch) at FOLD_CASES, and the chain it
    replaced on the main path (the same loop with K1 per arrival: the
    parent's fold) checked and timed beside it."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.core.algorithms.asofed import AsoFedStrategy
    from repro_torch.core.feature_learning import first_layer_path
    from repro_torch.kernels.feature_attention.kernel import (
        feature_attention_kernel)
    from repro_torch.kernels.feature_attention.ops import feature_fold
    from repro_torch.kernels.feature_attention.ref import feature_fold_ref

    out = {}
    for seed, (name, wl_name, hidden, S, n_real, repeat) in enumerate(
            FOLD_CASES):
        wl, cfg_model, model, w, d, n, idx, n_vis = _fold_inputs(
            wl_name, hidden, S, n_real, repeat, seed)
        first = first_layer_path(cfg_model)
        fold = AsoFedStrategy().build_fold(model, cfg_model,
                                           wl.run_config())
        t_arr = torch.zeros(S, device=DEV)

        def kern():
            return feature_fold(w, d, first, n, idx, n_vis, n_real)

        def plain():
            return feature_fold_ref(w, d, first, n, idx, n_vis, n_real)

        def chain():  # the engine's per-arrival loop, K1 in each fold
            server, received = {"w": w, "n": n}, []
            for s in range(n_real):
                server, rec = fold(server, tree_map(lambda u: u[s], d),
                                   idx[s], n_vis[s], t_arr[s])
                received.append(rec)
            pad = (received[-1],) * (S - n_real)
            return server["w"], server["n"], tree_map(
                lambda *rs: torch.stack(rs), *received, *pad)

        gate = n_real * FOLD_TOL_PER_ARRIVAL
        want = plain()
        err, per_unit = _fold_check(f"feature_fold {name}", kern(), want,
                                    first, n_real, gate)
        k1_before = feature_attention_kernel.launches
        chain_err, chain_per_unit = _fold_check(
            f"per-arrival chain {name}", chain(), want, first, n_real, gate)
        k1 = feature_attention_kernel.launches - k1_before
        if k1 != n_real:
            raise AssertionError(f"{name}: the chain launched K1 {k1} times "
                                 f"for {n_real} arrivals")
        rows = w[first].numel() // w[first].shape[-1]
        cols = w[first].shape[-1]
        bound_ms, bound_by = fold_bound(w, S, n_real, rows, cols,
                                        n.numel())
        ms = device_ms(kern)
        rec = {"phase": "fold_vs_plain", "kernel": "feature_fold",
               "case": name, "workload": wl_name, "hidden": hidden,
               "first_layer": first, "first_shape": [rows, cols],
               "leaves": {k: list(v.shape) for k, v in w.items()},
               "S": S, "n_real": n_real, "repeated_client": repeat,
               "max_abs_err": err, "err_per_unit": per_unit,
               "tolerance_per_unit": gate,
               "other_leaves_and_n": "bitwise",
               "chain_max_abs_err": chain_err,
               "chain_err_per_unit": chain_per_unit,
               "ms": ms, "call_ms": call_ms(kern),
               "plain_ms": device_ms(plain, reps=2),
               "plain_call_ms": call_ms(plain, reps=5),
               "chain_ms": device_ms(chain, reps=2),
               "chain_call_ms": call_ms(chain, reps=5),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms}
        emit(rec)
        out[name] = rec
        del w, d
    # the chaos layer's fold counts: admitted slots fold once, duplicated
    # ones twice, rejected ones not at all, read by the kernel on the card
    _, name, hidden, S, n_real, _ = FOLD_CASES[0]
    for tag, pattern in FOLD_REPS_CASES:
        wl, cfg_model, model, w, d, n, idx, n_vis = _fold_inputs(
            name, hidden, S, n_real, False, 0)
        first = first_layer_path(cfg_model)
        reps = torch.tensor(_fold_reps(pattern, S, n_real), device=DEV)
        folds = int(reps.sum())

        def kern():
            return feature_fold(w, d, first, n, idx, n_vis, n_real,
                                reps=reps)

        def kern_none():
            return feature_fold(w, d, first, n, idx, n_vis, n_real)

        def plain():
            return feature_fold_ref(w, d, first, n, idx, n_vis, n_real,
                                    reps=reps)

        gate = max(folds, 1) * FOLD_TOL_PER_ARRIVAL
        err, per_unit = _fold_check(f"feature_fold {tag}", kern(), plain(),
                                    first, n_real, gate)
        rows = w[first].numel() // w[first].shape[-1]
        cols = w[first].shape[-1]
        bound_ms, bound_by = fold_bound(w, S, n_real, rows, cols,
                                        n.numel(), folds)
        ms = device_ms(kern)
        rec = {"phase": "fold_vs_plain", "kernel": "feature_fold",
               "case": tag, "reps_pattern": pattern, "workload": name,
               "hidden": hidden, "first_layer": first,
               "first_shape": [rows, cols], "S": S, "n_real": n_real,
               "folds": folds, "reps": reps.tolist(),
               "max_abs_err": err, "err_per_unit": per_unit,
               "tolerance_per_unit": gate,
               "other_leaves_and_n": "bitwise",
               "ms": ms, "call_ms": call_ms(kern),
               "none_ms": device_ms(kern_none),
               # the plain version reads reps on the host (a branch a
               # slot), which a CUDA graph cannot capture: eager time
               "plain_ms": call_ms(plain, reps=5),
               "plain_timing": "eager, CUDA events",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms}
        emit(rec)
        out[tag] = rec
        del w, d
    return out


def _fold_reps(pattern: str, S: int, n_real: int):
    """(S,) int32 fold counts of the real slots (padded slots 0): a
    seeded draw over {0, 1, 2}, every slot twice, or every other slot
    skipped."""
    reps = np.zeros(S, np.int32)
    if pattern == "mixed":
        reps[:n_real] = np.random.default_rng(7).integers(0, 3, n_real)
    elif pattern == "dup_all":
        reps[:n_real] = 2
    else:
        reps[:n_real] = np.arange(n_real) % 2
    return reps


def _main_setup(T: int, **cfg_kw):
    """(model, cfg_model, clients, cfg) at the main path's shape:
    lstm_regression at hidden MAIN_HIDDEN, MAIN_CLIENTS clients, batch
    32, E=2, window 32, seed 0."""
    from repro_torch.sim.workloads import get_workload

    wl = get_workload("lstm_regression")
    cfg_model, model = wl.build(hidden=MAIN_HIDDEN)
    clients = wl.make_clients(MAIN_CLIENTS, seed=0)
    cfg = wl.run_config(**{"T": T, "batch_size": 32, "local_epochs": 2,
                           "eval_every": 256, "window": 32, "seed": 0,
                           **cfg_kw})
    return model, cfg_model, clients, cfg


def _main_path_run(T: int, stats: dict, alg: str = "asofed",
                   trace=None, **cfg_kw):
    """One run through the engine at the main path's shape."""
    from repro_torch.core.algorithms import get_strategy
    from repro_torch.sim.engine import run_strategy

    model, cfg_model, clients, cfg = _main_setup(T, **cfg_kw)
    t0 = time.perf_counter()
    hist = run_strategy(get_strategy(alg), model, cfg_model, clients,
                        cfg, stats=stats, trace=trace)
    return hist, time.perf_counter() - t0, cfg_model


def _fold_kernel():
    """The fused fold's wrapper, or None in an older checkout's package
    (``--only main_path`` copied into the parent's tree for an A/B)."""
    from repro_torch.kernels.feature_attention import kernel

    return getattr(kernel, "feature_fold_kernel", None)


def _reset_launches():
    from repro_torch.kernels.feature_attention.kernel import (
        feature_attention_kernel)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel)
    from repro_torch.kernels.linear_scan.kernel import linear_scan_kernel

    feature_attention_kernel.launches = 0
    linear_scan_kernel.launches = 0
    flash_attention_kernel.launches = 0
    if _fold_kernel() is not None:
        _fold_kernel().launches = 0


def _launches():
    """(K1, K2) launches since the last reset."""
    from repro_torch.kernels.feature_attention.kernel import (
        feature_attention_kernel)
    from repro_torch.kernels.linear_scan.kernel import linear_scan_kernel

    return feature_attention_kernel.launches, linear_scan_kernel.launches


def _fold_launches() -> int:
    """feature_fold launches since the last reset (0 in a package without
    the fused fold)."""
    fk = _fold_kernel()
    return 0 if fk is None else fk.launches


def _flash_launches() -> int:
    """K3 launches since the last reset."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel)

    return flash_attention_kernel.launches


def _finite(hist):
    if not all(math.isfinite(v) for h in hist for v in h.metrics.values()):
        raise AssertionError(f"non-finite eval metrics: {hist}")


def phase_main_path():
    _main_path_run(64, {})  # warm-up: cuBLAS / cuDNN handles, allocator
    rates = []
    for _ in range(MAIN_PATH_REPEATS):
        stats = {}
        _reset_launches()
        hist, wall, cfg_model = _main_path_run(MAIN_T, stats)
        k1, scan_launches = _launches()
        launches = _fold_launches()
        # one fused launch a tick (every tick folds), no per-row K1, no K2;
        # an older package: one K1 launch a folded arrival
        ok = (launches == stats["ticks"] and k1 == 0) \
            if _fold_kernel() is not None else k1 == stats["iters"]
        if not ok or stats["iters"] != MAIN_T or scan_launches != 0:
            raise AssertionError(
                f"main path: {launches} feature_fold launches for "
                f"{stats['ticks']} ticks (expected one a tick), {k1} per-row "
                f"feature-kernel launches for {stats['iters']} folded "
                f"arrivals (expected 0) and {scan_launches} linear-scan "
                "launches (expected 0 on the sequential fold)")
        _finite(hist)
        rates.append(stats["iters"] / wall)
        final = hist[-1].metrics
        emit({"phase": "main_path", "workload": "lstm_regression",
              "hidden": cfg_model.hidden,
              "in_features": cfg_model.in_features, "clients": MAIN_CLIENTS,
              "T": MAIN_T, "batch_size": 32, "local_epochs": 2, "window": 32,
              "iters": stats["iters"], "ticks": stats["ticks"],
              "windows": stats["windows"], "wall_s": wall,
              "iters_per_s": rates[-1], "device_s": stats["device_s"],
              "host_build_s": stats["host_build_s"],
              "eval_s": stats["eval_s"],
              "peak_device_bytes": stats["peak_device_bytes"],
              "participation_mean": stats.get("participation_mean"),
              "feature_fold_launches": launches,
              "feature_kernel_launches": k1,
              "smape": final["smape"], "mae": final["mae"]})
    q1, med, q3 = np.percentile(rates, [25, 50, 75])
    emit({"phase": "main_path_spread", "runs": len(rates),
          "iters_per_s": rates, "median": med, "iqr": q3 - q1})
    return launches


def phase_assoc_path():
    """FedAsync with the associative fold at the main path's shape: K2
    once per carrier leaf per tick, K1 never.  Then the same run with the
    sequential fold, both traced, for the rates side by side and the
    largest weight difference along the trace."""
    _main_path_run(64, {}, "fedasync", fold_mode="associative")  # warm-up
    rates = []
    for _ in range(ASSOC_PATH_REPEATS):
        stats = {}
        _reset_launches()
        hist, wall, cfg_model = _main_path_run(MAIN_T, stats, "fedasync",
                                               fold_mode="associative")
        k1, launches = _launches()
        k1 += _fold_launches()
        if stats["fold_mode"] != "associative" or k1 != 0 \
                or launches != stats["ticks"] * LSTM_LEAVES \
                or stats["iters"] != MAIN_T:
            raise AssertionError(
                f"assoc path: {launches} linear-scan launches for "
                f"{stats['ticks']} ticks (expected {LSTM_LEAVES} a tick) "
                f"and {k1} feature-kernel and feature_fold launches "
                "(expected 0); "
                f"fold_mode={stats['fold_mode']}, iters={stats['iters']}")
        _finite(hist)
        rates.append(stats["iters"] / wall)
        emit({"phase": "assoc_path", "strategy": "fedasync",
              "fold_mode": "associative", "workload": "lstm_regression",
              "hidden": cfg_model.hidden, "clients": MAIN_CLIENTS, "T": MAIN_T,
              "batch_size": 32, "local_epochs": 2, "window": 32,
              "iters": stats["iters"], "ticks": stats["ticks"],
              "wall_s": wall, "iters_per_s": rates[-1],
              "device_s": stats["device_s"],
              "host_build_s": stats["host_build_s"],
              "peak_device_bytes": stats["peak_device_bytes"],
              "scan_kernel_launches": launches,
              "feature_kernel_launches": k1,
              "smape": hist[-1].metrics["smape"]})
    traces, finals, seq_rate = {}, {}, None
    for mode in ("sequential", "associative"):
        stats, tr = {}, []
        hist, wall, _ = _main_path_run(MAIN_T, stats, "fedasync", trace=tr,
                                       fold_mode=mode)
        _finite(hist)
        traces[mode], finals[mode] = tr, hist[-1].metrics["smape"]
        if mode == "sequential":
            seq_rate = stats["iters"] / wall
            seq_device_s = stats["device_s"]
    seq = dict(traces["sequential"])
    diff = max(float(np.abs(w[k] - seq[t][k]).max())
               for t, w in traces["associative"] if t in seq for k in w)
    rel = abs(finals["associative"] - finals["sequential"]) / abs(
        finals["sequential"])
    if not (math.isfinite(diff) and rel < 1e-2):
        raise AssertionError(
            f"assoc path: final smape {finals['associative']} vs "
            f"sequential {finals['sequential']} (relative {rel}), largest "
            f"weight difference {diff}")
    q1, med, q3 = np.percentile(rates, [25, 50, 75])
    emit({"phase": "assoc_vs_seq", "strategy": "fedasync",
          "assoc_iters_per_s": rates, "assoc_median": med,
          "assoc_iqr": q3 - q1, "seq_iters_per_s": seq_rate,
          "seq_device_s": seq_device_s,
          "max_abs_weight_diff": diff, "smape_assoc": finals["associative"],
          "smape_seq": finals["sequential"], "smape_rel_diff": rel})
    return launches


def _device_profile(run):
    """Run ``run()`` under torch.profiler: (its result, wall seconds,
    [(kernel, device ms, launches)] by device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    key = "self_device_time_total" if events and hasattr(
        events[0], "self_device_time_total") else "self_cuda_time_total"
    per = sorted(((e.key, getattr(e, key, 0.0) / 1e3, e.count)
                  for e in events), key=lambda r: -r[1])
    return out, wall, per


def _profile_record(per, wall: float, names) -> dict:
    dev_ms = sum(r[1] for r in per)
    return {"device_busy_ms": dev_ms if per else "not measured",
            "device_idle_share": (1.0 - dev_ms / 1e3 / wall) if per
            else "not measured",
            "top_kernels_ms": [[k, ms, n] for k, ms, n in per[:12]],
            # the port's own kernels, wherever they rank
            "port_kernels_ms": [[k, ms, n] for k, ms, n in per
                                if any(name in k for name in names)]}


def phase_profile(alg: str = "asofed", **cfg_kw):
    """Device time by kernel over one main-path run (torch.profiler)."""
    stats = {}
    (_, wall, _), _, per = _device_profile(
        lambda: _main_path_run(MAIN_T, stats, alg, **cfg_kw))
    emit({"phase": "profile", "strategy": alg, **cfg_kw, "wall_s": wall,
          **_profile_record(per, wall, ("feature_attention_rows",
                                        "feature_fold_tick",
                                        "linear_scan_channels"))})


# ---------------------------------------------------------------------------
# The per-arrival oracles, the sweep baselines and the paper's table rows
# ---------------------------------------------------------------------------

# oracle_path at main_path's shape, depth cut per strategy: (strategy,
# oracle, T, oracle kwargs).  ASO-Fed folds 128 arrivals; FedAvg's T
# counts rounds of ~51 participants, one eager local round each (32
# rounds took 136 s on one H100 host)
ORACLE_RUNS = [("asofed", "asofed", 128, {}),
               ("fedasync", "fedasync", 32, {}),
               ("fedbuff", "fedbuff", 32, {}),
               ("fedavg", "fedavg", 2, {"prox_mu": 0.0})]
# sweep_path: Local-S and Global at main_path's fleet for SWEEP_T rounds;
# the profiled run takes SWEEP_PROFILE_T (profiling 16 rounds made the
# phase 65 s on one H100 host, of which the runs took 9 s)
SWEEP_T, SWEEP_PROFILE_T = 16, 4
# paper_rows: benchmarks/paper_tables.py's Table 5.1 on the
# Air-Quality-like data in its default (quick) mode (copied here: this
# script imports nothing of benchmarks/): _data_for, _model_for, _run_cfg
# and _dispatch.  Full mode (n_per 300, 6000 simulated s, eval every
# 100) took 152 s of this script on one H100 host.
PAPER_ALGS = ["asofed", "asofed_d", "asofed_f", "fedavg", "fedprox",
              "fedasync", "local", "global"]
PAPER_SYNC = ("fedavg", "fedprox", "local", "global")
PAPER_N_PER = 150
PAPER_CFG = dict(T=100000, sim_time_budget=1600.0, batch_size=16,
                 local_epochs=2, eta=0.03, lam=1.0, beta=0.001,
                 task="regression", eval_every=200, seed=0,
                 participation=0.2)


def _compare_to_oracle(trace, traj, tag: str) -> float:
    """An engine trace against an oracle's {t: weights} at every tick
    boundary the engine recorded (the last one the oracle's last)."""
    if not trace or trace[-1][0] != max(traj) or any(
            t not in traj for t, _ in trace):
        raise AssertionError(f"{tag}: engine boundaries "
                             f"{[t for t, _ in trace]} not all in the "
                             f"oracle's 1..{max(traj)}")
    return _compare(trace, [(t, traj[t]) for t, _ in trace], tag)


def phase_oracle_path():
    """The port's per-arrival oracles on the card, each held against the
    engine on the card at the same settings.  ASO-Fed's oracle folds
    through ``core.server.aggregate``: one per-row K1 launch a fold;
    the engine's run launches ``feature_fold`` once a tick and the
    per-row K1 never."""
    from repro_torch.core.algorithms import get_strategy
    from repro_torch.sim import reference
    from repro_torch.sim.engine import run_strategy

    phase_t0 = time.perf_counter()
    k1_oracle = 0
    for alg, name, T, kw in ORACLE_RUNS:
        model, cfg_model, clients, cfg = _main_setup(T)
        ostats = {}
        _reset_launches()
        t0 = time.perf_counter()
        traj = getattr(reference, f"run_{name}_reference")(
            model, cfg_model, clients, cfg, stats=ostats, device=DEV, **kw)
        torch.cuda.synchronize()
        o_wall = time.perf_counter() - t0
        k1, k2 = _launches()
        fold = _fold_launches()
        model, cfg_model, clients, cfg = _main_setup(T)
        estats, trace = {}, []
        _reset_launches()
        t0 = time.perf_counter()
        hist = run_strategy(get_strategy(alg), model, cfg_model, clients,
                            cfg, stats=estats, trace=trace, device=DEV)
        e_wall = time.perf_counter() - t0
        ek1, ek2 = _launches()
        efold = _fold_launches()
        _finite(hist)
        folds = ostats["iters"]
        want_k1 = folds if alg == "asofed" else 0
        want_efold = estats["ticks"] if alg == "asofed" else 0
        if (k1, k2, fold, ek1, ek2, efold) != (want_k1, 0, 0, 0, 0,
                                               want_efold) \
                or folds != T or estats["iters"] != T:
            raise AssertionError(
                f"oracle path {alg}: the oracle made {folds} folds with "
                f"{k1} per-row K1 launches (expected {want_k1}), K2 {k2}, "
                f"feature_fold {fold}; the engine ({estats['iters']} iters, "
                f"{estats['ticks']} ticks) made K1 {ek1}, K2 {ek2}, "
                f"feature_fold {efold} (expected {want_efold})")
        worst = _compare_to_oracle(trace, traj, f"{alg} engine vs oracle")
        if alg == "asofed":
            k1_oracle = k1
        emit({"phase": "oracle_path", "strategy": alg,
              "workload": "lstm_regression", "hidden": MAIN_HIDDEN,
              "clients": MAIN_CLIENTS, "T": T, "batch_size": 32,
              "local_epochs": 2, "oracle_iters": folds,
              "oracle_wall_s": o_wall, "oracle_iters_per_s": folds / o_wall,
              "engine_iters": estats["iters"],
              "engine_ticks": estats["ticks"], "engine_wall_s": e_wall,
              "engine_iters_per_s": estats["iters"] / e_wall,
              "engine_over_oracle": o_wall / e_wall,
              "engine_traced": True, "engine_device_s": estats["device_s"],
              "oracle_feature_kernel_launches": k1,
              "engine_feature_kernel_launches": ek1,
              "engine_feature_fold_launches": efold,
              "shared_boundaries": len(trace), "max_abs_diff": worst,
              "atol": TRAJ_ATOL, "rtol": TRAJ_RTOL,
              "oracle_staleness_mean": ostats.get("staleness_mean")})
    emit({"phase": "oracle_path_total",
          "wall_s": time.perf_counter() - phase_t0})
    return k1_oracle


def phase_sweep_path():
    """Local-S and Global on the sweep schedule at main_path's fleet:
    rounds/s, device and host time, peak memory, then one shorter
    profiled run each.  Neither has a server fold, so no kernel of the port runs."""
    phase_t0 = time.perf_counter()
    for alg in ("local", "global"):
        _main_path_run(2, {}, alg)  # warm-up at this strategy's shapes
        stats = {}
        _reset_launches()
        hist, wall, cfg_model = _main_path_run(SWEEP_T, stats, alg,
                                               eval_every=SWEEP_T // 2)
        k1, k2 = _launches()
        k1 += _fold_launches()
        _finite(hist)
        if stats["iters"] != SWEEP_T or (k1, k2) != (0, 0) \
                or len(hist) != 2:
            raise AssertionError(
                f"sweep path {alg}: {stats['iters']} rounds of {SWEEP_T}, "
                f"{len(hist)} evals, K1 {k1}, K2 {k2} (expected 0, 0)")
        final = hist[-1].metrics
        emit({"phase": "sweep_path", "strategy": alg,
              "workload": "lstm_regression", "hidden": cfg_model.hidden,
              "clients": MAIN_CLIENTS, "rounds": stats["iters"],
              "batch_size": 32, "local_epochs": 2, "wall_s": wall,
              "rounds_per_s": stats["iters"] / wall,
              "device_s": stats["device_s"],
              "host_build_s": stats["host_build_s"],
              "eval_s": stats["eval_s"],
              "peak_device_bytes": stats["peak_device_bytes"],
              "stacked_state_bytes": stats["stacked_state_bytes"],
              "folds_per_tick_mean": stats.get("folds_per_tick_mean"),
              "smape": final["smape"], "mae": final["mae"]})
        pstats = {}
        (_, pwall, _), _, per = _device_profile(
            lambda: _main_path_run(SWEEP_PROFILE_T, pstats, alg,
                                   eval_every=SWEEP_PROFILE_T // 2))
        emit({"phase": "sweep_profile", "strategy": alg,
              "rounds": SWEEP_PROFILE_T, "wall_s": pwall,
              **_profile_record(per, pwall, ())})
    emit({"phase": "sweep_path_total",
          "wall_s": time.perf_counter() - phase_t0})


def phase_paper_rows():
    """The eight rows of the paper's Table 5.1 on the Air-Quality-like
    data through ``repro_torch.core.run``, as
    ``benchmarks/paper_tables.py`` runs them in its default mode."""
    from repro_torch.configs import get_arch
    from repro_torch.core import RunConfig, make_sim_clients, run
    from repro_torch.data import airquality_like
    from repro_torch.models import build_model

    cfg_model = dataclasses.replace(get_arch("paper-lstm"), in_features=8,
                                    out_features=1, hidden=32)
    model = build_model(cfg_model)
    base_cfg = RunConfig(**PAPER_CFG)
    phase_t0 = time.perf_counter()
    per_iter = {}
    for alg in PAPER_ALGS:
        cfg, base = base_cfg, alg
        if alg == "asofed_d":
            cfg, base = dataclasses.replace(cfg, dynamic_lr=False), "asofed"
        elif alg == "asofed_f":
            cfg = dataclasses.replace(cfg, feature_learning=False)
            base = "asofed"
        if base in PAPER_SYNC:
            cfg = dataclasses.replace(cfg, T=150, eval_every=20)
        clients = make_sim_clients(
            airquality_like(n_clients=9, n_per=PAPER_N_PER), seed=0)
        stats = {}
        _reset_launches()
        t0 = time.perf_counter()
        hist = run(base, model, cfg_model, clients, cfg, stats=stats)
        wall = time.perf_counter() - t0
        k1, k2 = _launches()
        _finite(hist)
        if not hist:
            raise AssertionError(f"paper rows: {alg} evaluated no point")
        last = hist[-1]  # the row's Table 5.1 entry, as paper_tables.py
        per_iter[alg] = stats["sim_time"] / stats["iters"]
        emit({"phase": "paper_rows", "row": alg, "strategy": base,
              "dataset": f"airquality_like(n_clients=9, "
                         f"n_per={PAPER_N_PER})",
              "hidden": 32, "T": cfg.T, "sim_time_budget":
              cfg.sim_time_budget, "iters": stats["iters"],
              "sim_time": stats["sim_time"], "ticks": stats["ticks"],
              "last_eval_iter": last.global_iter,
              "last_eval_sim_time": last.sim_time,
              "sim_s_per_iter": per_iter[alg], "wall_s": wall,
              "iters_per_s": stats["iters"] / wall,
              "device_s": stats["device_s"], "evals": len(hist),
              "mae": last.metrics["mae"], "smape": last.metrics["smape"],
              "feature_fold_launches": _fold_launches(),
              "feature_kernel_launches": k1, "scan_kernel_launches": k2})
    emit({"phase": "paper_rows_total",
          "wall_s": time.perf_counter() - phase_t0})
    if not per_iter["asofed"] < per_iter["fedavg"]:
        raise AssertionError(
            f"paper rows: asofed's simulated time per iteration "
            f"{per_iter['asofed']} is not below fedavg's "
            f"{per_iter['fedavg']}")


# ---------------------------------------------------------------------------
# Reduced-precision and host-resident client state at a large fleet
# ---------------------------------------------------------------------------

# residency_path: the JAX bench's K-sweep run shape
# (benchmarks/sim_bench.py:536-560, copied: this script imports nothing
# of benchmarks/) at the main path's width: RES_REAL real clients do all
# the arriving, padded to RES_K registered clients with permanently
# dropped stubs (two training samples each) that hold state rows and
# never enter the scheduler
RES_REAL, RES_K, RES_T, RES_ORACLE_T = 64, 10_000, 256, 64
# (strategy, residency, state dtype): asofed on the sequential fold
# (feature_fold), fedasync on the associative fold (K2)
RES_RUNS = [("asofed", "device", None), ("asofed", "host", None),
            ("asofed", "device", "bf16"), ("asofed", "host", "bf16"),
            ("asofed", "host", "int8"), ("asofed", "host", "int4"),
            ("fedasync", "device", "int8"), ("fedasync", "host", "int8")]
# the pairs that must agree bit for bit across residencies
RES_PAIRS = [("asofed", None), ("asofed", "bf16"), ("fedasync", "int8")]
# asofed's host_pool_bytes at RES_K and hidden 64 (75,015 elements a
# row: 4 x 18,753 parameters and 3 fp32 scalars; int4 packs each leaf
# to ceil(n / 2) bytes)
RES_POOL_BYTES = {None: 3_000_600_000, "bf16": 1_500_360_000,
                  "int8": 750_240_000, "int4": 375_200_000}
# a window's block: 64 distinct clients and the scratch row, bucketed to
# the next power of two
RES_BLOCK_ROWS = 128


def _res_setup(T: int, hidden: int, K: int, **cfg_kw):
    """(model, cfg_model, clients, cfg) at residency_path's shape."""
    from repro_torch.sim.profiles import make_sim_clients
    from repro_torch.sim.workloads import get_workload

    wl = get_workload("lstm_regression")
    cfg_model, model = wl.build(hidden=hidden)
    data = wl.make_data(RES_REAL)
    xtr, ytr, xte, yte = data[0]
    stub = (xtr[:2], ytr[:2], xte[:1], yte[:1])
    clients = make_sim_clients(data + [stub] * (K - RES_REAL), seed=0)
    for c in clients[RES_REAL:]:
        c.dropped = True
    cfg = wl.run_config(T=T, batch_size=8, local_epochs=2, eta=0.02,
                        lam=1.0, beta=0.001, eval_every=0, seed=0,
                        window=32, **cfg_kw)
    return model, cfg_model, clients, cfg


def _res_row_bytes(alg: str, model, cfg, device) -> tuple:
    """(pool bytes, block bytes) of one encoded state row, from its leaf
    table: the pool packs int4 codes two to a byte, the block does not."""
    from repro_torch.common.dtypes import resolve_state_storage
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.core.algorithms import get_strategy

    strat = get_strategy(alg)
    w0 = model.init(torch.Generator().manual_seed(0), device=device)
    row = strat.build_init_client(model, cfg)(
        w0, torch.zeros(1, device=device))
    codec = strat.state_codec(model, cfg, w0)
    if codec is not None:
        row = codec.encode(row)
    storage = resolve_state_storage(cfg.state_dtype)
    packed = storage is not None and storage.pool_bits == 4
    pool = block = 0
    for x in tree_leaves(row):
        n = x[0].numel()
        block += n * x.element_size()
        pool += (n + 1) // 2 if packed and x.dtype == torch.int8 \
            else n * x.element_size()
    return pool, block


def _res_check_launches(alg: str, stats: dict, k1: int, k2: int,
                        fold: int, tag: str) -> None:
    """asofed: one feature_fold launch a tick, no per-row K1, no K2;
    fedasync (associative): K2 once a carrier leaf a tick, no K1."""
    want = ((stats["ticks"], 0, 0) if alg == "asofed"
            else (0, 0, stats["ticks"] * LSTM_LEAVES))
    if (fold, k1, k2) != want:
        raise AssertionError(
            f"{tag}: feature_fold {fold}, per-row K1 {k1}, K2 {k2} for "
            f"{stats['ticks']} ticks; expected {want}")


def phase_residency_path(K: int = RES_K, T: int = RES_T,
                         hidden: int = MAIN_HIDDEN,
                         oracle_T: int = RES_ORACLE_T, device="cuda"):
    """asofed (sequential fold) and fedasync (associative fold) with the
    client state stored in fp32, bf16, int8 and int4, on the card or in
    the host pool, at K registered clients: checks 1-7 of the slice
    (bitwise residency pairs, pool bytes from the leaf table, the block
    bound, the peak, the launches, finite metrics, the int8 host engine
    against the port's oracle on the card).  Returns (feature_fold
    launches, K2 launches, per-row K1 launches) over the phase."""
    from repro_torch.core.algorithms import get_strategy
    from repro_torch.sim import reference
    from repro_torch.sim.engine import run_strategy

    phase_t0 = time.perf_counter()
    # warm-up at the real clients alone: cuBLAS / cuDNN handles and the
    # allocator, so the first cell does not pay them
    for alg, kw in (("asofed", {}), ("fedasync",
                                     {"fold_mode": "associative"})):
        model, cfg_model, clients, cfg = _res_setup(32, hidden, RES_REAL,
                                                    **kw)
        run_strategy(get_strategy(alg), model, cfg_model, clients, cfg,
                     device=device)
    traces, runs = {}, {}
    fold_total = k2_total = 0
    for alg, res, dt in RES_RUNS:
        tag = f"residency_path {alg} {res} {dt or 'fp32'}"
        fold_kw = {"fold_mode": "associative"} if alg == "fedasync" else {}
        model, cfg_model, clients, cfg = _res_setup(
            T, hidden, K, state_residency=res, state_dtype=dt, **fold_kw)
        stats, trace = {}, []
        _reset_launches()
        t0 = time.perf_counter()
        run_strategy(get_strategy(alg), model, cfg_model, clients, cfg,
                     stats=stats, trace=trace, device=device)
        wall = time.perf_counter() - t0
        k1, k2 = _launches()
        fold = _fold_launches()
        _res_check_launches(alg, stats, k1, k2, fold, tag)
        fold_total += fold
        k2_total += k2
        numbers = {k: v for k, v in stats.items()
                   if isinstance(v, (int, float))}
        if stats["iters"] != T or not all(
                math.isfinite(v) for v in numbers.values()) or not all(
                np.all(np.isfinite(w[k])) for _, w in trace for k in w):
            raise AssertionError(f"{tag}: {stats['iters']} of {T} iters, "
                                 f"or a non-finite metric or weight")
        row_pool, row_block = _res_row_bytes(alg, model, cfg, device)
        if res == "host":
            want = K * row_pool
            if (alg, K, hidden) == ("asofed", RES_K, MAIN_HIDDEN) \
                    and want != RES_POOL_BYTES[dt]:
                raise AssertionError(f"{tag}: the leaf table gives {want} "
                                     f"pool bytes, not {RES_POOL_BYTES[dt]}")
            if stats["host_pool_bytes"] != want:
                raise AssertionError(f"{tag}: host_pool_bytes "
                                     f"{stats['host_pool_bytes']} != {want}")
            if not 0 < stats["stacked_state_bytes"] \
                    <= RES_BLOCK_ROWS * row_block:
                raise AssertionError(
                    f"{tag}: stacked_state_bytes "
                    f"{stats['stacked_state_bytes']} beyond "
                    f"{RES_BLOCK_ROWS} rows of {row_block} bytes")
        traces[(alg, res, dt)], runs[(alg, res, dt)] = trace, stats
        emit({"phase": "residency_path", "strategy": alg,
              "fold_mode": stats["fold_mode"], "state_residency": res,
              "state_dtype": stats["state_dtype"], "clients": K,
              "real_clients": RES_REAL, "hidden": hidden, "T": T,
              "batch_size": 8, "local_epochs": 2, "window": 32,
              "iters": stats["iters"], "ticks": stats["ticks"],
              "windows": stats["windows"], "wall_s": wall,
              "iters_per_s": stats["iters"] / wall,
              "setup_s": stats["setup_s"], "device_s": stats["device_s"],
              "host_build_s": stats["host_build_s"],
              "stacked_state_bytes": stats["stacked_state_bytes"],
              "host_pool_bytes": stats["host_pool_bytes"],
              "peak_device_bytes": stats["peak_device_bytes"],
              "gathered_rows": stats["gathered_rows"],
              "scattered_rows": stats["scattered_rows"],
              "gather_s": stats["gather_s"], "scatter_s": stats["scatter_s"],
              "row_bytes_pool": row_pool, "row_bytes_block": row_block,
              "feature_fold_launches": fold, "feature_kernel_launches": k1,
              "scan_kernel_launches": k2})
    for alg, dt in RES_PAIRS:
        tag = f"residency_path {alg} {dt or 'fp32'} host vs device"
        tr_d, tr_h = traces[(alg, "device", dt)], traces[(alg, "host", dt)]
        if [t for t, _ in tr_d] != [t for t, _ in tr_h] or not all(
                np.array_equal(w[k], v[k]) for (_, w), (_, v) in
                zip(tr_d, tr_h) for k in w):
            raise AssertionError(f"{tag}: trajectories differ")
        dev, host = runs[(alg, "device", dt)], runs[(alg, "host", dt)]
        saved = dev["peak_device_bytes"] - host["peak_device_bytes"]
        if saved < 0.9 * dev["stacked_state_bytes"]:
            raise AssertionError(
                f"{tag}: peak {host['peak_device_bytes']} on the host "
                f"pool against {dev['peak_device_bytes']} with the stack "
                f"of {dev['stacked_state_bytes']} bytes on the card")
        emit({"phase": "residency_pair", "strategy": alg,
              "state_dtype": dt or "fp32", "bitwise": True,
              "windows": len(tr_d), "peak_saved_bytes": saved,
              "device_stacked_state_bytes": dev["stacked_state_bytes"]})
    # the int8 host engine against the port's oracle on the card
    model, cfg_model, clients, cfg = _res_setup(
        oracle_T, hidden, K, state_residency="host", state_dtype="int8")
    trace, estats = [], {}
    _reset_launches()
    run_strategy(get_strategy("asofed"), model, cfg_model, clients, cfg,
                 stats=estats, trace=trace, device=device)
    k1, k2 = _launches()
    fold = _fold_launches()
    _res_check_launches("asofed", estats, k1, k2, fold,
                        "residency_path oracle check's engine")
    fold_total += fold
    model, cfg_model, clients, cfg = _res_setup(oracle_T, hidden, K,
                                                state_dtype="int8")
    _reset_launches()
    t0 = time.perf_counter()
    traj = reference.run_asofed_reference(model, cfg_model, clients, cfg,
                                          device=device)
    o_wall = time.perf_counter() - t0
    k1_oracle, _ = _launches()
    if k1_oracle != oracle_T:
        raise AssertionError(
            f"residency_path oracle: {k1_oracle} per-row K1 launches for "
            f"{oracle_T} folds (expected one a fold)")
    worst = _compare_to_oracle(trace, traj,
                               "residency_path asofed int8 host vs oracle")
    emit({"phase": "residency_oracle", "strategy": "asofed",
          "state_dtype": "int8", "state_residency": "host", "clients": K,
          "T": oracle_T, "engine_ticks": estats["ticks"],
          "oracle_wall_s": o_wall, "oracle_feature_kernel_launches":
          k1_oracle, "shared_boundaries": len(trace), "max_abs_diff": worst,
          "atol": TRAJ_ATOL, "rtol": TRAJ_RTOL})
    emit({"phase": "residency_path_total",
          "wall_s": time.perf_counter() - phase_t0})
    return fold_total, k2_total, k1_oracle


# the affine strategies at small width: (strategy, config overrides, T)
# ---------------------------------------------------------------------------
# The chaos layer at the main path's shape
# ---------------------------------------------------------------------------

# tests/test_faults.py's mixed spec and guards; (name, strategy, fault
# kind, RunConfig overrides): (a) asofed, the sequential fold through
# feature_fold with reps, random_mask uploads; (b) fedasync, the
# associative fold (K2), noise corruption, the downweight policy,
# quantized_delta uploads; (c) fedbuff, the sequential per-arrival fold
CHAOS_GUARDS = {"max_staleness": 8.0, "max_delta_norm": 0.5}
CHAOS_RUNS = [
    ("a", "asofed", "nan", {**CHAOS_GUARDS, "upload_codec": "random_mask",
                            "upload_frac": 0.1}),
    ("b", "fedasync", "noise", {"max_staleness": 8.0,
                                "staleness_policy": "downweight",
                                "upload_codec": "quantized_delta",
                                "fold_mode": "associative"}),
    ("c", "fedbuff", "nan", dict(CHAOS_GUARDS)),
]
CHAOS_FAULT_RATE = 0.15
# depth of the oracle check (e) and of the card-vs-CPU runs (f)
CHAOS_ORACLE_T, CHAOS_CPU_T = 128, 128
CHAOS_COUNTERS = ("rejected_uploads", "clipped_uploads", "lost_uploads",
                  "retried_uploads", "crashed_clients",
                  "duplicated_arrivals", "corrupted_arrivals")


def _chaos_run(T: int, alg: str, kind: str, cfg_kw: dict, device="cuda",
               trace=None, **run_kw):
    """(history, wall seconds, stats) of one run at the main path's shape
    with every client under FaultSpec.uniform(CHAOS_FAULT_RATE, seed=42,
    corrupt_kind=kind)."""
    from repro_torch.core.algorithms import get_strategy
    from repro_torch.sim.engine import run_strategy
    from repro_torch.sim.faults import FaultSpec, with_faults

    model, cfg_model, clients, cfg = _main_setup(T, **cfg_kw)
    clients = with_faults(clients, [FaultSpec.uniform(
        CHAOS_FAULT_RATE, seed=42, corrupt_kind=kind)] * len(clients))
    stats = {}
    t0 = time.perf_counter()
    hist = run_strategy(get_strategy(alg), model, cfg_model, clients, cfg,
                        stats=stats, trace=trace, device=device, **run_kw)
    if device == "cuda":
        torch.cuda.synchronize()
    return hist, time.perf_counter() - t0, stats


# the port's compute code (the tick, the strategies, the kernels' wrappers,
# the PRNG): a synchronizing call made there on every tick would stall it
COMPUTE_SOURCES = ("repro_torch/sim/compile.py", "repro_torch/core/",
                   "repro_torch/kernels/", "repro_torch/common/")


def _sync_calls(run):
    """(run's result, {"file:line": count} of the synchronizing CUDA calls
    it made): the calls ``torch.cuda.set_sync_debug_mode("warn")``
    reports, over every thread of the run (the prefetch thread's copies
    included), by the Python line that made them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return out, where


def phase_chaos_path():
    """The chaos layer at main_path's shape: (a)-(c) driven with the
    launch counts set to 0 just before each, (d) host vs device bit for
    bit, (e) the asofed oracle on the card against the engine, (f) the
    card against the CPU, the synchronizing calls of (a) against
    main_path's at the same depth, and one profiled run of (a).  Returns
    (a)'s feature_fold launches,
    (b)'s K2 launches and the oracle check's per-row K1 launches."""
    from repro_torch.sim import reference

    phase_t0 = time.perf_counter()
    _chaos_run(64, *CHAOS_RUNS[0][1:])  # warm-up at (a)'s shapes
    fold_a = scan_b = 0
    for tag, alg, kind, kw in CHAOS_RUNS:
        _reset_launches()
        hist, wall, stats = _chaos_run(MAIN_T, alg, kind, kw)
        k1, k2 = _launches()
        fold = _fold_launches()
        ticks = stats["ticks"]
        want = {"asofed": (ticks, 0, 0), "fedasync": (0, 0, 5 * ticks),
                "fedbuff": (0, 0, 0)}[alg]
        if (fold, k1, k2) != want or stats["iters"] != MAIN_T:
            raise AssertionError(
                f"chaos path ({tag}) {alg}: feature_fold {fold}, per-row K1 "
                f"{k1}, K2 {k2} for {ticks} ticks (expected {want}); "
                f"iters {stats['iters']}")
        _finite(hist)
        # every fault kind fires; the guards reject (NaN payloads) or, under
        # the downweight policy, rescale
        guard = "clipped_uploads" if kw.get("staleness_policy") == \
            "downweight" else "rejected_uploads"
        if not all(stats[c] for c in (
                guard, "crashed_clients", "duplicated_arrivals",
                "corrupted_arrivals", "retried_uploads")):
            raise AssertionError(f"chaos path ({tag}): a fault kind or the "
                                 f"guard never fired: "
                                 f"{ {c: stats[c] for c in CHAOS_COUNTERS} }")
        fold_a, scan_b = (fold if tag == "a" else fold_a,
                          k2 if tag == "b" else scan_b)
        emit({"phase": "chaos_path", "run": tag, "strategy": alg,
              "fault_rate": CHAOS_FAULT_RATE, "corrupt_kind": kind, **kw,
              "workload": "lstm_regression", "hidden": MAIN_HIDDEN,
              "clients": MAIN_CLIENTS, "T": MAIN_T, "batch_size": 32,
              "local_epochs": 2, "window": 32, "iters": stats["iters"],
              "ticks": ticks, "windows": stats["windows"], "wall_s": wall,
              "iters_per_s": stats["iters"] / wall,
              "device_s": stats["device_s"],
              "host_build_s": stats["host_build_s"],
              "upload_bytes": stats["upload_bytes"],
              **{c: stats[c] for c in CHAOS_COUNTERS},
              "feature_fold_launches": fold, "feature_kernel_launches": k1,
              "scan_kernel_launches": k2,
              "smape": hist[-1].metrics["smape"]})
    # (d) host vs device residency, bit for bit
    tag, alg, kind, kw = CHAOS_RUNS[0]
    traces = {}
    for residency in ("device", "host"):
        traces[residency] = []
        _, _, stats = _chaos_run(MAIN_T, alg, kind,
                                 {**kw, "state_residency": residency},
                                 trace=traces[residency])
    worst = _compare(traces["host"], traces["device"], "chaos host vs device",
                     atol=0.0)
    if worst != 0.0:
        raise AssertionError(f"chaos path: host and device residency differ "
                             f"by {worst}")
    emit({"phase": "chaos_residency", "strategy": alg, "T": MAIN_T,
          "boundaries": len(traces["host"]), "max_abs_diff": worst,
          "host_pool_bytes": stats["host_pool_bytes"]})
    # (e) the port's asofed oracle on the card against the engine
    model, cfg_model, clients, cfg = _main_setup(CHAOS_ORACLE_T, **kw)
    from repro_torch.sim.faults import FaultSpec, with_faults

    clients = with_faults(clients, [FaultSpec.uniform(
        CHAOS_FAULT_RATE, seed=42, corrupt_kind=kind)] * len(clients))
    ostats = {}
    _reset_launches()
    t0 = time.perf_counter()
    traj = reference.run_asofed_reference(model, cfg_model, clients, cfg,
                                          stats=ostats, device=DEV)
    torch.cuda.synchronize()
    o_wall = time.perf_counter() - t0
    k1, k2 = _launches()
    k1_oracle = k1
    trace = []
    _reset_launches()
    _, e_wall, estats = _chaos_run(CHAOS_ORACLE_T, alg, kind, kw,
                                   trace=trace)
    ek1, _ = _launches()
    efold = _fold_launches()
    if k1 != ostats["folds"] or k2 != 0 or ek1 != 0 \
            or efold != estats["ticks"] \
            or any(ostats[c] != estats[c] for c in ("rejected_uploads",
                                                    "clipped_uploads")):
        raise AssertionError(
            f"chaos oracle: {k1} per-row K1 launches for {ostats['folds']} "
            f"server folds, K2 {k2}; the engine K1 {ek1}, feature_fold "
            f"{efold} for {estats['ticks']} ticks; rejected / clipped "
            f"{ostats['rejected_uploads']} / {ostats['clipped_uploads']} "
            f"(oracle) vs {estats['rejected_uploads']} / "
            f"{estats['clipped_uploads']} (engine)")
    worst = _compare_to_oracle(trace, traj, "chaos asofed engine vs oracle")
    emit({"phase": "chaos_oracle", "strategy": alg, "T": CHAOS_ORACLE_T,
          "oracle_iters": ostats["iters"], "oracle_folds": ostats["folds"],
          "oracle_wall_s": o_wall,
          "oracle_iters_per_s": ostats["iters"] / o_wall,
          "engine_wall_s": e_wall, "oracle_feature_kernel_launches": k1,
          "engine_feature_fold_launches": efold,
          "rejected_uploads": ostats["rejected_uploads"],
          "clipped_uploads": ostats["clipped_uploads"],
          "shared_boundaries": len(trace), "max_abs_diff": worst,
          "atol": TRAJ_ATOL, "rtol": TRAJ_RTOL})
    # (f) the card against the CPU
    for tag, alg, kind, kw in CHAOS_RUNS:
        tr_gpu, tr_cpu = [], []
        _chaos_run(CHAOS_CPU_T, alg, kind, kw, trace=tr_gpu)
        _, cpu_wall, _ = _chaos_run(CHAOS_CPU_T, alg, kind, kw,
                                    device="cpu", trace=tr_cpu)
        worst = _compare(tr_gpu, tr_cpu, f"chaos ({tag}) {alg} card vs CPU")
        emit({"phase": "chaos_card_vs_cpu", "run": tag, "strategy": alg,
              "T": CHAOS_CPU_T, "boundaries": len(tr_gpu),
              "max_abs_diff": worst, "atol": TRAJ_ATOL, "rtol": TRAJ_RTOL,
              "cpu_wall_s": cpu_wall})
    # the guards add no host read: synchronizing calls of (a) against
    # main_path's at the same depth, those of the compute code apart
    tag, alg, kind, kw = CHAOS_RUNS[0]
    (_, _, cstats), c_where = _sync_calls(
        lambda: _chaos_run(MAIN_T, alg, kind, kw))
    mstats = {}
    _, m_where = _sync_calls(lambda: _main_path_run(MAIN_T, mstats))

    def in_compute(where):
        return sum(n for k, n in where.items()
                   if any(src in k for src in COMPUTE_SOURCES))

    c_comp, m_comp = in_compute(c_where), in_compute(m_where)
    if c_comp > m_comp:
        raise AssertionError(
            f"chaos path: {c_comp} synchronizing calls in the compute code "
            f"against main_path's {m_comp}: {c_where}")
    emit({"phase": "chaos_sync_calls",
          "chaos_sync_calls": sum(c_where.values()),
          "chaos_windows": cstats["windows"], "chaos_ticks": cstats["ticks"],
          "main_sync_calls": sum(m_where.values()),
          "main_windows": mstats["windows"], "main_ticks": mstats["ticks"],
          "chaos_in_compute_code": c_comp, "main_in_compute_code": m_comp,
          "chaos_by_line": c_where, "main_by_line": m_where})
    # where (a)'s device time goes (torch.profiler)
    (_, wall, _), _, per = _device_profile(
        lambda: _chaos_run(MAIN_T, alg, kind, kw))
    emit({"phase": "chaos_profile", "run": tag, "strategy": alg,
          "wall_s": wall, **_profile_record(per, wall, (
              "feature_attention_rows", "feature_fold_tick",
              "linear_scan_channels"))})
    emit({"phase": "chaos_path_total",
          "wall_s": time.perf_counter() - phase_t0})
    return fold_a, scan_b, k1_oracle


# ---------------------------------------------------------------------------
# Crash-resume snapshots (repro_torch.checkpoint) at the main path's shape
# ---------------------------------------------------------------------------

# (name, strategy, RunConfig overrides, under chaos_path (a)'s faults):
# (a) asofed, the sequential fold (feature_fold once a tick); (b)
# fedasync, the associative fold (K2 once a carrier leaf a tick); (c)
# asofed under chaos_path (a)'s faults, codec and guards (feature_fold
# with reps)
RESUME_RUNS = [("a", "asofed", {}, False),
               ("b", "fedasync", {"fold_mode": "associative"}, False),
               ("c", "asofed", dict(CHAOS_RUNS[0][3]), True)]
# snapshot interval of the checkpointing runs (iterations), and their
# window: the engine takes a snapshot where a window starts (before its
# peek), and at window 32 each of these runs is one window (main_path: 10
# ticks of ~51 arrivals), so they run 4 ticks a window (the trajectory is
# the same at any window, bit for bit)
RESUME_EVERY, RESUME_WINDOW = 128, 4


def _resume_run(T: int, alg: str, cfg_kw: dict, faulty: bool,
                device="cuda", setup=None, **run_kw):
    """(trace, wall seconds, stats) of one engine run at the main path's
    shape (``setup``: another shape's setup function, called with T and
    ``cfg_kw``), with chaos_path (a)'s faults when ``faulty``."""
    from repro_torch.core.algorithms import get_strategy
    from repro_torch.sim.engine import run_strategy
    from repro_torch.sim.faults import FaultSpec, with_faults

    model, cfg_model, clients, cfg = (setup or _main_setup)(T, **cfg_kw)
    if faulty:
        clients = with_faults(clients, [FaultSpec.uniform(
            CHAOS_FAULT_RATE, seed=42, corrupt_kind="nan")] * len(clients))
    trace, stats = [], {}
    t0 = time.perf_counter()
    run_strategy(get_strategy(alg), model, cfg_model, clients, cfg,
                 stats=stats, trace=trace, device=device,
                 window=RESUME_WINDOW, **run_kw)
    if device == "cuda":
        torch.cuda.synchronize()
    return trace, time.perf_counter() - t0, stats


def _bitwise(tr_a, tr_b) -> bool:
    return [t for t, _ in tr_a] == [t for t, _ in tr_b] and all(
        np.array_equal(wa[k], wb[k])
        for (_, wa), (_, wb) in zip(tr_a, tr_b) for k in wa)


def _resume_triple(tag: str, T: int, alg: str, cfg_kw: dict, faulty: bool,
                   snap: str, device="cuda", setup=None):
    """The plain run, the checkpointing run (bit for bit the plain one)
    and the resumed run (the plain run's final weights bit for bit),
    with the launches of each counted from 0.  Returns the record."""
    runs = {}
    for kind, run_kw in (("plain", {}),
                         ("checkpointing", dict(checkpoint_path=snap,
                                                checkpoint_every=RESUME_EVERY)),
                         ("resumed", dict(resume_from=snap))):
        _reset_launches()
        trace, wall, stats = _resume_run(T, alg, cfg_kw, faulty, device,
                                         setup, **run_kw)
        k1, k2 = _launches()
        runs[kind] = (trace, wall, stats, (_fold_launches(), k1, k2))
    (tr_p, wall_p, st_p, _), (tr_c, wall_c, st_c, _) = (runs["plain"],
                                                         runs["checkpointing"])
    tr_r, wall_r, st_r, (fold, k1, k2) = runs["resumed"]
    if not _bitwise(tr_c, tr_p):
        raise AssertionError(f"resume path ({tag}): the checkpointing run's "
                             "trajectory differs from the plain run's")
    if not (0 < st_r["resumed_from_t"] < T and st_r["iters"] == T
            and st_c["ckpt_writes"] >= 1 and tr_r
            and _bitwise(tr_r[-1:], tr_p[-1:])):
        raise AssertionError(
            f"resume path ({tag}): resumed from t="
            f"{st_r.get('resumed_from_t')} to {st_r['iters']} of {T} after "
            f"{st_c['ckpt_writes']} snapshots; final weights equal: "
            f"{bool(tr_r) and _bitwise(tr_r[-1:], tr_p[-1:])}")
    ticks = st_r["ticks"]
    want = ((0, 0, LSTM_LEAVES * ticks) if cfg_kw.get("fold_mode")
            == "associative" else (ticks, 0, 0))
    if (fold, k1, k2) != want:
        raise AssertionError(
            f"resume path ({tag}): the resumed run launched feature_fold "
            f"{fold}, per-row K1 {k1}, K2 {k2} in {ticks} ticks; expected "
            f"{want}")
    return {"phase": "resume_path", "run": tag, "strategy": alg,
            "faults": faulty, **cfg_kw, "T": T, "bitwise": True,
            "checkpoint_every": RESUME_EVERY, "window": RESUME_WINDOW,
            "resumed_from_t": st_r["resumed_from_t"],
            "resumed_ticks": ticks, "ckpt_writes": st_c["ckpt_writes"],
            "ckpt_write_s": st_c["ckpt_write_s"],
            "ckpt_bytes": st_c["ckpt_bytes"],
            "host_pool_bytes": st_c["host_pool_bytes"],
            "plain_iters_per_s": T / wall_p,
            "checkpointing_iters_per_s": T / wall_c,
            "checkpointing_over_plain": wall_p / wall_c,
            "resumed_wall_s": wall_r, "resumed_setup_s": st_r["setup_s"],
            "plain_setup_s": st_p["setup_s"],
            "resumed_feature_fold_launches": fold,
            "resumed_feature_kernel_launches": k1,
            "resumed_scan_kernel_launches": k2}


def phase_resume_path(device="cuda"):
    """Crash-resume at the main path's shape: runs (a)-(c) of
    RESUME_RUNS, each plain, checkpointing every RESUME_EVERY iterations
    (bit for bit the plain run) and resumed from the last snapshot (the
    plain run's final weights bit for bit, the kernels launched on the
    resumed ticks); then residency_path's host shape with the int8 pool
    at K=10,000.  Snapshots go to a temporary directory, removed at the
    end.  Returns (feature_fold launches of every resumed run, of (c)'s
    alone, K2 launches of the resumed run (b))."""
    import functools
    import shutil
    import tempfile

    phase_t0 = time.perf_counter()
    _resume_run(64, "asofed", {}, False, device)  # warm-up
    root = tempfile.mkdtemp(prefix="resume_path_")
    fold_resumed = fold_c = scan_b = 0
    try:
        for tag, alg, kw, faulty in RESUME_RUNS:
            rec = _resume_triple(tag, MAIN_T, alg, kw, faulty,
                                 os.path.join(root, tag), device)
            emit({**rec, "workload": "lstm_regression",
                  "hidden": MAIN_HIDDEN, "clients": MAIN_CLIENTS,
                  "batch_size": 32, "local_epochs": 2})
            fold_resumed += rec["resumed_feature_fold_launches"]
            if tag == "c":
                fold_c = rec["resumed_feature_fold_launches"]
            if tag == "b":
                scan_b = rec["resumed_scan_kernel_launches"]
        # the host pool: residency_path's int8 cell at K=10,000 registered
        # clients (a 0.75 GB pool on disk per snapshot)
        setup = functools.partial(_res_setup, hidden=MAIN_HIDDEN, K=RES_K)
        rec = _resume_triple(
            "host_int8", RES_T, "asofed",
            {"state_residency": "host", "state_dtype": "int8"}, False,
            os.path.join(root, "host_int8"), device, setup)
        if rec["ckpt_bytes"] < rec["host_pool_bytes"] \
                or rec["host_pool_bytes"] != RES_POOL_BYTES["int8"]:
            raise AssertionError(
                f"resume path (host_int8): {rec['ckpt_bytes']} snapshot "
                f"bytes on disk for a pool of {rec['host_pool_bytes']} "
                f"bytes (expected {RES_POOL_BYTES['int8']})")
        fold_resumed += rec["resumed_feature_fold_launches"]
        emit({**rec, "workload": "lstm_regression", "hidden": MAIN_HIDDEN,
              "clients": RES_K, "real_clients": RES_REAL, "batch_size": 8,
              "local_epochs": 2})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "resume_path_total",
          "wall_s": time.perf_counter() - phase_t0})
    return fold_resumed, fold_c, scan_b


AFFINE = [("fedasync", {}, 60), ("fedbuff", {"buffer_size": 3}, 60),
          ("asofed", {"feature_learning": False}, 60),
          ("fedavg", {"participation": 0.6}, 10),
          ("fedprox", {"participation": 0.6}, 10)]


def _small_run(name: str, T: int, device: str, alg: str = "asofed",
               **cfg_kw):
    from repro_torch.core.algorithms import get_strategy
    from repro_torch.sim.engine import run_strategy
    from repro_torch.sim.workloads import get_workload

    wl = get_workload(name)
    cfg_model, model = wl.build(hidden=12)
    cfg = wl.run_config(T=T, batch_size=8, local_epochs=2, eta=0.02,
                        eval_every=30, seed=0, **cfg_kw)
    trace = []
    hist = run_strategy(get_strategy(alg), model, cfg_model,
                        wl.make_clients(5, n_per=60, seed=0), cfg,
                        device=device, trace=trace)
    return hist, trace


def _compare(tr_a, tr_b, tag: str, atol: float = TRAJ_ATOL) -> float:
    """Max abs difference of two traces with the same tick boundaries;
    raises beyond the engine tolerance (against ``tr_b``)."""
    if [t for t, _ in tr_a] != [t for t, _ in tr_b] or not tr_a:
        raise AssertionError(f"{tag}: tick boundaries differ")
    worst = 0.0
    for (t, wa), (_, wb) in zip(tr_a, tr_b):
        for k in wa:
            d = np.abs(wa[k] - wb[k])
            worst = max(worst, float(d.max()))
            excess = d - (atol + TRAJ_RTOL * np.abs(wb[k]))
            if not np.all(np.isfinite(wa[k])) or excess.max() > 0:
                raise AssertionError(
                    f"{tag}: trajectories differ at t={t} in {k}: max abs "
                    f"diff {float(d.max())}")
    return worst


def phase_card_vs_cpu():
    from repro_torch.common.dtypes import resolve_state_storage
    from repro_torch.sim.engine import RunConfig

    runs = [("lstm_regression", 60, "asofed", {}),
            ("cnn_classification", 30, "asofed", {}),
            ("lstm_multilabel", 60, "asofed", {})]
    runs += [("lstm_regression", T, alg, {**over,
                                          "fold_mode": "associative"})
             for alg, over, T in AFFINE]
    runs += [("cnn_classification", 30, "fedasync",
              {"fold_mode": "associative"})]
    # the sweep baselines (T counts rounds)
    runs += [("lstm_regression", 10, alg, {}) for alg in ("local", "global")]
    # stored client state through a codec, on the card and in the pool
    runs += [("lstm_regression", 60, "asofed", {"state_dtype": "bf16"}),
             ("lstm_regression", 60, "asofed",
              {"state_residency": "host", "state_dtype": "int4"})]
    for name, T, alg, kw in runs:
        _, tr_gpu = _small_run(name, T, "cuda", alg, **kw)
        _, tr_cpu = _small_run(name, T, "cpu", alg, **kw)
        # a quantized code may land one step apart where the two devices'
        # fp32 states differ by an ulp at a rounding boundary: one step
        # (state_qclip / levels) on top of the trajectory tolerance
        storage = resolve_state_storage(kw.get("state_dtype"))
        atol = TRAJ_ATOL + (RunConfig.state_qclip / storage.levels
                            if storage is not None and storage.quantized
                            else 0.0)
        worst = _compare(tr_gpu, tr_cpu, f"{alg} {name} card vs CPU", atol)
        emit({"phase": "card_vs_cpu", "workload": name, "strategy": alg,
              **kw, "T": T, "ticks": len(tr_gpu), "max_abs_diff": worst,
              "atol": atol, "rtol": TRAJ_RTOL})
    # the associative fold (K2) against the sequential one, on the card
    for alg, over, T in AFFINE:
        _, tr_par = _small_run("lstm_regression", T, "cuda", alg,
                               fold_mode="associative", **over)
        _, tr_seq = _small_run("lstm_regression", T, "cuda", alg,
                               fold_mode="sequential", **over)
        worst = _compare(tr_par, tr_seq, f"{alg} associative vs sequential")
        emit({"phase": "assoc_vs_seq_small", "workload": "lstm_regression",
              "strategy": alg, **over, "T": T, "ticks": len(tr_par),
              "max_abs_diff": worst, "atol": TRAJ_ATOL, "rtol": TRAJ_RTOL})


# ---------------------------------------------------------------------------
# The dense transformer's serve path (K3)
# ---------------------------------------------------------------------------

# the card every phase below runs on
DEV = "cuda"
SERVE_ARCH = "tinyllama-1.1b"
# prompt + generated = 2048, TinyLlama's whole context
SERVE_B, SERVE_PROMPT, SERVE_GEN = 8, 2016, 32
SERVE_REPEATS = 3
# serve_path_phi4's architecture (head dim 128) and its flash_vs_plain case
PHI4_ARCH, PHI4_CASE = "phi4-mini-3.8b", "phi4_layer0"
# K3 vs its plain version: max abs error per unit of the output's largest
# magnitude (at least 1), tests/test_kernels.py's bounds.  The online and
# the dense softmax sum in different orders; bf16 outputs round once.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# and per (b, s, kv, g) output row: max abs error over hd per unit of that
# row's largest |want|.  Causal rows past the first few hundred keys are
# ~20x smaller than row 0 (v[0] itself), so a fault confined to late rows
# or tiles hides under FLASH_TOL; this gate sees it.  bf16 outputs differ
# by up to one ulp, 2^-7 of a row's largest |value|
ROW_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (name, B, Sq, Skv, KV, G, hd, causal, window), positions arange; the
# first five are tests/test_kernels.py's CASES.  Then, at every head dim,
# the edges of both designs: a ragged length (the last 64-key tile and
# 128-row q tile partly past the sequence) at 100 and at the serve
# prompt's 2016, a window, and Sq != Skv.
FLASH_CASES = [
    ("grid0", 2, 128, 128, 2, 2, 64, True, 0),
    ("grid1", 1, 256, 256, 1, 4, 32, True, 64),
    ("grid2", 2, 64, 64, 4, 1, 64, False, 0),
    ("grid3", 1, 128, 128, 2, 4, 128, True, 32),
    ("grid4", 1, 512, 512, 1, 1, 64, True, 128),
    ("main", SERVE_B, SERVE_PROMPT, SERVE_PROMPT, 4, 8, 64, True, 0),
    ("ragged", 2, 100, 100, 4, 8, 64, True, 0),
    ("window", 2, SERVE_PROMPT, SERVE_PROMPT, 4, 8, 64, True, 512),
    ("hd128", 2, 512, 512, 4, 8, 128, True, 0),
    # phi4-mini-3.8B's prefill attention (24 heads over 8 KV heads, head
    # dim 128): the bf16 hd-128 instance serve_path_phi4 launches
    (PHI4_CASE, SERVE_B, SERVE_PROMPT, SERVE_PROMPT, 8, 3, 128, True, 0),
] + [case for hd in (32, 64, 128) for case in (
    (f"ragged100_hd{hd}", 2, 100, 100, 2, 2, hd, True, 0),
    (f"ragged2016_hd{hd}", 1, SERVE_PROMPT, SERVE_PROMPT, 2, 2, hd, True,
     0),
    (f"window48_hd{hd}", 1, 300, 300, 2, 2, hd, True, 48),
    (f"sq_ne_skv_hd{hd}", 1, 100, 300, 2, 2, hd, True, 0))]
# card vs CPU under teacher forcing: 5e-3 per unit of max |logits|, the
# JAX package's own prefill-vs-forward bound
# (tests/test_decode_consistency.py)
SERVE_TOL = 5e-3
FORCED_PROMPT, FORCED_STEPS = 64, 4


def flash_bound(q, k, q_pos, k_pos, causal: bool, window: int):
    """(bound_ms, bound_by) of one attention call on these inputs: the
    unmasked (query, key) pairs of this data at 4 hd FLOPs each (QK and
    PV) over the peak rate of the input type, against q, k, v and the
    output read or written once over HBM bandwidth."""
    B, Sq, KV, G, hd = q.shape
    qp = q_pos.to(torch.int64)[:, :, None]
    kp = k_pos.to(torch.int64)[:, None, :]
    mask = torch.ones((1, 1, 1), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    pairs = int(mask.expand(B, Sq, k.shape[1]).sum()) * KV * G
    peak = FP32_OPS_PER_S if q.dtype == torch.float32 else BF16_OPS_PER_S
    ops_ms = 4 * hd * pairs / peak * 1e3
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + (q_pos.numel() + k_pos.numel()) * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                             "bytes")


def _flash_case(name, q, k, v, q_pos, k_pos, causal, window, contiguous,
                timed: bool = False):
    """K3 against its plain version on the card; returns the record."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ops import flash_attention

    kw = dict(q_positions=q_pos, k_positions=k_pos, causal=causal,
              window=window, contiguous=contiguous)
    B, Sq, KV, G, hd = q.shape

    def plain():  # the ref through the kernel layout, as on the CPU
        from repro_torch.kernels.flash_attention.ref import (
            flash_attention_ref)
        o = flash_attention_ref(
            q.permute(0, 2, 3, 1, 4).reshape(B, KV * G, Sq, hd),
            k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), q_pos, k_pos,
            causal=causal, window=window)
        return o.reshape(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4)

    got = flash_attention(q, k, v, **kw)
    want = plain()
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    tol = FLASH_TOL[q.dtype] * max(1.0, float(want.float().abs().max()))
    row_err = float((diff.amax(-1) / want.float().abs().amax(-1).clamp_min(
        1e-6)).max())
    if not (got.dtype == q.dtype and got.shape == q.shape and err <= tol):
        raise AssertionError(
            f"flash_attention kernel disagrees with its plain version in "
            f"case {name} {q.dtype}: max abs err {err} (tolerance {tol})")
    if not row_err <= ROW_TOL[q.dtype]:
        raise AssertionError(
            f"flash_attention kernel disagrees with its plain version in "
            f"case {name} {q.dtype}: a row's max abs err is {row_err} of "
            f"its largest |value| (tolerance {ROW_TOL[q.dtype]})")
    bound_ms, bound_by = flash_bound(q, k, q_pos, k_pos, causal, window)
    rec = {"phase": "flash_vs_plain", "kernel": "flash_attention",
           "case": name, "B": B, "Sq": Sq, "Skv": k.shape[1], "KV": KV,
           "G": G, "hd": hd, "causal": causal, "window": window,
           "contiguous": contiguous, "dtype": str(q.dtype),
           "max_abs_err": err, "tolerance": tol,
           "row_err_per_unit": row_err,
           "row_tolerance": ROW_TOL[q.dtype],
           "bound_ms": bound_ms, "bound_by": bound_by}
    if timed:
        kern = lambda: flash_attention_kernel(  # noqa: E731
            q, k, v, q_pos, k_pos, causal=causal, window=window,
            contiguous=contiguous)
        qs = q.permute(0, 2, 3, 1, 4).reshape(B, KV * G, Sq, hd).contiguous()
        ks = k.permute(0, 2, 1, 3).contiguous()
        vs = v.permute(0, 2, 1, 3).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = lambda: sdpa(qs, ks, vs, is_causal=True,  # noqa: E731
                           enable_gqa=True)
        try:  # a yardstick only: the port never calls it
            lib_out = lib().reshape(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4)
            lib_ms = device_ms(lib, reps=10)
            lib_err = float((lib_out.float() - want.float()).abs().max())
        except RuntimeError as e:
            lib_ms, lib_err = None, f"not measured: {e}"[:300]
        ms = device_ms(kern, reps=10)
        rec.update(
            ms=ms, call_ms=call_ms(kern, reps=10),
            plain_ms=device_ms(plain, reps=2), library_ms=lib_ms,
            library="torch.nn.functional.scaled_dot_product_attention "
                    "(enable_gqa, is_causal)",
            library_max_abs_err=lib_err, bound_share=bound_ms / ms,
            ptxas=[ln.strip() for ln in build.BUILD_LOG.get(
                "flash_attention", (0.0, ""))[1].splitlines()
                if "registers" in ln or "spill" in ln or "smem" in ln])
    emit(rec)
    return rec


def _arange_pos(B: int, S: int) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32,
                        device=DEV).expand(B, S).contiguous()


def phase_flash_vs_plain(layer0_qkv):
    """K3 against its plain version, fp32 and bf16: the JAX grid, the
    main-path shape with N(0, 1) inputs and with the serve run's own
    layer-0 q/k/v (both timed), and at every head dim ragged lengths, a
    window, Sq != Skv, decode-like non-contiguous queries over a padded
    cache, fully masked rows and queries at the end of the prompt."""
    from repro_torch.models.decode import INT_SENTINEL

    gen = torch.Generator(device=DEV).manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, Sq, Skv, KV, G, hd, causal, window in FLASH_CASES:
            def draw(*shape):
                return torch.randn(shape, generator=gen, device=DEV,
                                   dtype=torch.float32).to(dtype)
            q, k, v = draw(B, Sq, KV, G, hd), draw(B, Skv, KV, hd), draw(
                B, Skv, KV, hd)
            out[(name, dtype)] = _flash_case(
                name, q, k, v, _arange_pos(B, Sq), _arange_pos(B, Skv),
                causal, window, True, timed=name == "main" or (
                    name == PHI4_CASE and dtype == torch.bfloat16))
            del q, k, v
        q, k, v = (t.to(dtype) for t in layer0_qkv)
        out[("main_model", dtype)] = _flash_case(
            "main_model_qkv", q, k, v, _arange_pos(SERVE_B, SERVE_PROMPT),
            _arange_pos(SERVE_B, SERVE_PROMPT), True, 0, True, timed=True)
        del q, k, v
        for hd in (32, 64, 128):
            # 64 queries at positions 1000..1063 over a 2048-slot cache
            # whose slots past 1063 are unwritten (INT_SENTINEL), not
            # contiguous; the same queries with 5 of them at position -3,
            # before every key (fully masked rows: the mean of v over all
            # keys, as every tile is visited); and 64 queries at the end
            # of a 2016-key prompt
            B, Sq, Skv, KV, G = 2, 64, 2048, 4, 8
            q = torch.randn((B, Sq, KV, G, hd), generator=gen, device=DEV
                            ).to(dtype)
            k = torch.randn((B, Skv, KV, hd), generator=gen, device=DEV
                            ).to(dtype)
            v = torch.randn((B, Skv, KV, hd), generator=gen, device=DEV
                            ).to(dtype)
            q_pos = (1000 + torch.arange(Sq, device=DEV, dtype=torch.int32)
                     ).expand(B, Sq).contiguous()
            k_pos = torch.arange(Skv, device=DEV, dtype=torch.int32)
            k_pos = torch.where(k_pos < 1000 + Sq, k_pos,
                                torch.full_like(k_pos, INT_SENTINEL)
                                ).expand(B, Skv).contiguous()
            sfx = "" if hd == 64 else f"_hd{hd}"
            for window in (0, 256):
                name = f"padded_cache_w{window}{sfx}"
                out[(name, dtype)] = _flash_case(
                    name, q, k, v, q_pos, k_pos, True, window, False)
            masked_pos = q_pos.clone()
            masked_pos[:, :5] = -3
            out[(f"fully_masked_hd{hd}", dtype)] = _flash_case(
                f"fully_masked_hd{hd}", q, k, v, masked_pos,
                _arange_pos(B, Skv), True, 0, False)
            out[(f"tail_queries_hd{hd}", dtype)] = _flash_case(
                f"tail_queries_hd{hd}", q, k[:, :SERVE_PROMPT].contiguous(),
                v[:, :SERVE_PROMPT].contiguous(),
                _arange_pos(B, Sq) + (SERVE_PROMPT - Sq),
                _arange_pos(B, SERVE_PROMPT), True, 0, False)
            del q, k, v
    return out


def _serve_setup(dtype=torch.float32, arch: str = SERVE_ARCH):
    """``arch`` (TinyLlama-1.1B) at full width and depth, random weights
    from seed 0 on the card in ``dtype``, and the serve batch's prompt
    tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, make_batch

    cfg = get_arch(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0),
                        device=DEV, dtype=dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = make_batch(cfg, SERVE_B, SERVE_PROMPT, seed=0,
                        device=DEV)["tokens"]
    return cfg, model, params, tokens, init_s


def _layer0_qkv(cfg, params, tokens):
    """Layer 0's rotated q (B, S, KV, G, hd), k and v for the prompt."""
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import layer

    B, S = tokens.shape
    with torch.no_grad():
        p = layer(params["blocks"], 0)
        h = L.apply_norm(cfg.norm, p["ln1"], L.embed(params["embed"],
                                                     tokens))
        q, k, v = attn._project_qkv(p["attn"], h, cfg)
        pos = _arange_pos(B, S)
        q, k = attn._apply_rope(cfg, q, k, pos, pos)
    KV = cfg.n_kv_heads
    return (q.reshape(B, S, KV, cfg.n_heads // KV, cfg.head_dim).contiguous(),
            k.contiguous(), v.contiguous())


def _serve_once(model, params, tokens):
    from repro_torch.launch.serve import serve

    with torch.no_grad():
        return serve(model, params, tokens, SERVE_GEN, temperature=0.0,
                     device=DEV)


def phase_serve_path(cfg, model, params, tokens, init_s: float,
                     dtype=torch.float32, sfx=None):
    """serve() at full width and depth in the weights' ``dtype``: K3 once
    per layer of the prefill, never in decode; the rates of
    SERVE_REPEATS runs; then one profiled run.  Phases ``serve_path``,
    ``serve_path_spread``, ``serve_profile`` (fp32) or the same names
    with the suffix ``sfx`` (default ``_bf16`` for bf16 weights)."""
    from repro_torch.common.pytree import tree_leaves

    if sfx is None:
        sfx = "" if dtype == torch.float32 else "_bf16"
    _serve_once(model, params, tokens)  # warm-up: cuBLAS, allocator
    runs = []
    for _ in range(SERVE_REPEATS):
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        gen, stats = _serve_once(model, params, tokens)
        k1, k2 = _launches()
        k1 += _fold_launches()
        k3 = _flash_launches()
        if not (k3 == cfg.n_layers and stats["k3_launches"] == cfg.n_layers
                and stats["k3_decode_launches"] == 0 and k1 == 0
                and k2 == 0):
            raise AssertionError(
                f"serve path{sfx}: {k3} flash-attention launches ("
                f"{stats['k3_launches']} in the prefill, "
                f"{stats['k3_decode_launches']} in decode; expected "
                f"{cfg.n_layers} and 0), K1 {k1}, K2 {k2}")
        if not stats["finite_logits"] or tuple(gen.shape) != (
                SERVE_B, SERVE_GEN + 1):
            raise AssertionError(f"serve path{sfx}: non-finite logits or "
                                 f"tokens of shape {tuple(gen.shape)}")
        rec = {"phase": "serve_path" + sfx, "arch": cfg.name,
               "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
               "batch": SERVE_B, "prompt_len": SERVE_PROMPT,
               "gen": SERVE_GEN, "max_len": SERVE_PROMPT + SERVE_GEN,
               "temperature": 0.0, "dtype": str(dtype).split(".")[-1],
               **stats,
               "prefill_tokens_per_s": SERVE_B * SERVE_PROMPT
               / stats["prefill_s"],
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "weight_bytes": sum(t.numel() * t.element_size()
                                   for t in tree_leaves(params)),
               "flash_attention_launches": k3, "init_s": init_s,
               "first_request_tokens": gen[0, :8].tolist()}
        emit(rec)
        runs.append(rec)

    def spread(key):
        vals = [r[key] for r in runs]
        q1, med, q3 = np.percentile(vals, [25, 50, 75])
        return {key: vals, f"{key}_median": med, f"{key}_iqr": q3 - q1}

    emit({"phase": f"serve_path{sfx}_spread", "runs": len(runs),
          **spread("prefill_s"), **spread("ttft_s"),
          **spread("tokens_per_s")})
    (_, stats), wall, per = _device_profile(
        lambda: _serve_once(model, params, tokens))
    emit({"phase": "serve_profile" + sfx, "arch": cfg.name, "wall_s": wall,
          "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
          **_profile_record(per, wall, ("fa_fwd_f32", "fa_fwd_bf16"))})
    return runs[-1]["flash_attention_launches"]


def _teacher_forced(model, params, tokens, device: str):
    """Prefill the first FORCED_PROMPT tokens, then FORCED_STEPS decode
    steps fed the next tokens: ([logits per step], cache) on the CPU."""
    tokens = tokens.to(device)
    B = tokens.shape[0]
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": tokens[:, :FORCED_PROMPT]},
            max_len=FORCED_PROMPT + FORCED_STEPS)
        out = [logits.cpu()]
        for i in range(FORCED_STEPS):
            idx = torch.full((B,), FORCED_PROMPT + i, dtype=torch.int32,
                             device=device)
            logits, cache = model.decode_step(
                params, cache,
                tokens[:, FORCED_PROMPT + i:FORCED_PROMPT + i + 1], idx)
            out.append(logits.cpu())
    return out, {k: t.cpu() for k, t in cache["kv"].items()}


def phase_serve_card_vs_cpu():
    """The port on the card against the port on the CPU: prefill logits,
    every teacher-forced decode step's logits and the KV cache, at full
    width with the depth cut to 2 layers, and on the reduced config."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, make_batch

    full = get_arch(SERVE_ARCH)
    for tag, cfg in (("full_width_2_layers",
                      dataclasses.replace(full, n_layers=2)),
                     ("reduced", full.reduced())):
        model = build_model(cfg)
        params = model.init(torch.Generator(device=DEV).manual_seed(0),
                            device=DEV)
        params_cpu = tree_map(lambda t: t.cpu(), params)
        tokens = make_batch(cfg, 2, FORCED_PROMPT + FORCED_STEPS, seed=1,
                            device="cpu")["tokens"]
        _reset_launches()
        got, cache_gpu = _teacher_forced(model, params, tokens, DEV)
        k3 = _flash_launches()
        want, cache_cpu = _teacher_forced(model, params_cpu, tokens, "cpu")
        if k3 != cfg.n_layers:
            raise AssertionError(f"{tag}: {k3} K3 launches in the card's "
                                 f"prefill, expected {cfg.n_layers}")
        errs = []
        for step, (g, w) in enumerate(zip(got, want)):
            rel = float((g - w).abs().max()) / float(w.abs().max())
            errs.append(rel)
            if not (torch.isfinite(g).all() and rel <= SERVE_TOL):
                raise AssertionError(
                    f"serve card vs CPU ({tag}): logits of step {step} "
                    f"differ by {rel} per unit of max |logits| "
                    f"(tolerance {SERVE_TOL})")
        cache_errs = {}
        for name in ("k", "v"):
            w = cache_cpu[name]
            cache_errs[name] = float((cache_gpu[name] - w).abs().max()) \
                / float(w.abs().max())
        if max(cache_errs.values()) > SERVE_TOL or not torch.equal(
                cache_gpu["pos"], cache_cpu["pos"]):
            raise AssertionError(
                f"serve card vs CPU ({tag}): KV cache differs: "
                f"{cache_errs}, pos equal: "
                f"{torch.equal(cache_gpu['pos'], cache_cpu['pos'])}")
        emit({"phase": "serve_card_vs_cpu", "case": tag, "arch": cfg.name,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "batch": 2, "prompt_len": FORCED_PROMPT,
              "forced_steps": FORCED_STEPS,
              "logits_rel_err_per_step": errs,
              "cache_rel_err": cache_errs, "tolerance": SERVE_TOL,
              "flash_attention_launches": k3})
        del params, params_cpu


# the dense serve phases, which --only can run alone
SERVE_PHASES = ("flash_vs_plain", "serve_path", "serve_path_bf16",
                "serve_path_phi4")
# the phases --only can run alone (after the build), in this order
ONLY_PHASES = ("main_path", "assoc_path", "oracle_path", "sweep_path",
               "paper_rows", "residency_path", "chaos_path",
               "resume_path") + SERVE_PHASES


def serve_phases(names):
    """Run the named phases of SERVE_PHASES: (flash_vs_plain's records,
    K3 launches on serve_path, on serve_path_bf16, on serve_path_phi4)."""
    fv, k3, k3_bf16, k3_phi4 = {}, 0, 0, 0
    if "flash_vs_plain" in names or "serve_path" in names:
        cfg, model, params, tokens, init_s = _serve_setup()
        if "flash_vs_plain" in names:
            fv = phase_flash_vs_plain(_layer0_qkv(cfg, params, tokens))
        if "serve_path" in names:
            k3 = phase_serve_path(cfg, model, params, tokens, init_s)
        del model, params, tokens
    if "serve_path_bf16" in names:
        cfg, model, params, tokens, init_s = _serve_setup(torch.bfloat16)
        k3_bf16 = phase_serve_path(cfg, model, params, tokens, init_s,
                                   torch.bfloat16)
        del model, params, tokens
    if "serve_path_phi4" in names:
        # phi4-mini-3.8B in bf16 (~7.7 GB of weights): K3's hd-128 build
        cfg, model, params, tokens, init_s = _serve_setup(torch.bfloat16,
                                                          PHI4_ARCH)
        k3_phi4 = phase_serve_path(cfg, model, params, tokens, init_s,
                                   torch.bfloat16, sfx="_phi4")
        del model, params, tokens
    return fv, k3, k3_bf16, k3_phi4


def _flash_entry(name, rec, launches, by_path, design):
    """The kernels line's entry for one K3 design."""
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:95",
        "launches": launches, "max_abs_err": rec["max_abs_err"],
        "row_err_per_unit": rec["row_err_per_unit"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": rec["library_ms"], "library": rec["library"],
        "shape": [rec[k] for k in ("B", "Sq", "Skv", "KV", "G", "hd")],
        "dtype": rec["dtype"].split(".")[-1],
        "design_source": "src/repro_torch/kernels/flash_attention/csrc/"
                         + design,
        "launches_by_path": {"main_path": 0, "assoc_path": 0,
                             "oracle_path": 0, "sweep_path": 0,
                             "residency_path": 0, "chaos_path": 0,
                             "resume_path": 0, "serve_path": 0,
                             "serve_path_bf16": 0, "serve_path_phi4": 0,
                             **by_path}}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases of " + ", ".join(
                        ONLY_PHASES) + " to run alone (after the build)")
    only = [p for p in ap.parse_args(argv).only.split(",") if p]
    bad = sorted(set(only) - set(ONLY_PHASES))
    if bad:
        ap.error(f"--only takes {', '.join(ONLY_PHASES)}; got {bad}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_line()
    print(card, flush=True)
    emit({"phase": "setup", "torch": torch.__version__,
          # whether this machine has ml_dtypes (the port never imports it)
          "ml_dtypes_installed":
          importlib.util.find_spec("ml_dtypes") is not None,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision()})
    if only:  # the same phases against another checkout's package (copy
        # this script into its root) read two versions on one card
        phase_build()
        if "main_path" in only:
            phase_main_path()
        if "assoc_path" in only:
            phase_assoc_path()
        if "oracle_path" in only:
            phase_oracle_path()
        if "sweep_path" in only:
            phase_sweep_path()
        if "paper_rows" in only:
            phase_paper_rows()
        if "residency_path" in only:
            phase_residency_path()
        if "chaos_path" in only:
            phase_chaos_path()
        if "resume_path" in only:
            phase_resume_path()
        serve_phases(only)
        print(card_line(), flush=True)
        emit({"ok": True, "only": only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    phase_build()
    kv = phase_kernel_vs_plain()
    sv = phase_scan_vs_plain()
    fv_fold = phase_fold_vs_plain()
    launches = phase_main_path()
    phase_profile()
    scan_launches = phase_assoc_path()
    phase_profile("fedasync", fold_mode="associative")
    k1_oracle = phase_oracle_path()
    phase_sweep_path()
    phase_paper_rows()
    res_fold, res_scan, res_k1 = phase_residency_path()
    chaos_fold, chaos_scan, chaos_k1 = phase_chaos_path()
    resume_fold, resume_fold_reps, resume_scan = phase_resume_path()
    phase_card_vs_cpu()
    fv, flash_launches, flash_launches_bf16, flash_launches_phi4 = \
        serve_phases(SERVE_PHASES)
    phase_serve_card_vs_cpu()
    main_rec = kv[((8, 256), torch.float32, True)]
    fold_rec = fv_fold["main_tick"]
    reps_rec = fv_fold["main_tick_reps"]
    # K2 at the main path's largest leaf (w_h), a = 1: the case with a
    # library yardstick (torch.cumsum); the kernel's time does not depend
    # on the values of a
    scan_rec = sv[((1, 64, 16384), torch.float32, "ones")]
    emit({"kernels": [{
        # K1 redesigned for the main path: the tick's whole sequential fold
        "name": "feature_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/feature_attention/csrc/"
                  "feature_attention.cu",
        "replaces": "src/repro/kernels/feature_attention/kernel.py:38 "
                    "inside src/repro/sim/compile.py:339-352",
        "launches": launches, "max_abs_err": fold_rec["max_abs_err"],
        "ms": fold_rec["ms"], "plain_ms": fold_rec["plain_ms"],
        "bound_ms": fold_rec["bound_ms"], "bound_by": fold_rec["bound_by"],
        "library_ms": None, "chain_ms": fold_rec["chain_ms"],
        "call_ms": fold_rec["call_ms"],
        "shape": {"S": fold_rec["S"], "n_real": fold_rec["n_real"],
                  "leaves": fold_rec["leaves"]},
        "launches_by_path": {"main_path": launches, "assoc_path": 0,
                             "oracle_path": 0, "sweep_path": 0,
                             "residency_path": res_fold,
                             "chaos_path": chaos_fold,
                             "resume_path": resume_fold,
                             "serve_path": 0, "serve_path_bf16": 0,
                             "serve_path_phi4": 0}}, {
        # the same kernel with the chaos layer's per-slot fold counts
        # (reps, read on the card) at the main path's tick; chaos_path's
        # run (a) launches it once a tick
        "name": "feature_fold_reps", "route": "cuda",
        "source": "src/repro_torch/kernels/feature_attention/csrc/"
                  "feature_attention.cu",
        "replaces": "src/repro/kernels/feature_attention/kernel.py:38 "
                    "inside src/repro/sim/compile.py:339-352",
        "launches": chaos_fold, "max_abs_err": reps_rec["max_abs_err"],
        "ms": reps_rec["ms"], "plain_ms": reps_rec["plain_ms"],
        "bound_ms": reps_rec["bound_ms"], "bound_by": reps_rec["bound_by"],
        "library_ms": None, "none_ms": reps_rec["none_ms"],
        "call_ms": reps_rec["call_ms"],
        "shape": {"S": reps_rec["S"], "n_real": reps_rec["n_real"],
                  "folds": reps_rec["folds"]},
        "launches_by_path": {"main_path": 0, "assoc_path": 0,
                             "oracle_path": 0, "sweep_path": 0,
                             "residency_path": 0, "chaos_path": chaos_fold,
                             "resume_path": resume_fold_reps,
                             "serve_path": 0, "serve_path_bf16": 0,
                             "serve_path_phi4": 0}}, {
        # the per-row K1 at the first layer's shape (8, 256), held against
        # its plain version; oracle_path reaches it once a fold
        # (core.server.aggregate -> apply_feature_learning)
        "name": "feature_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/feature_attention/csrc/"
                  "feature_attention.cu",
        "replaces": "src/repro/kernels/feature_attention/kernel.py:38",
        "launches": k1_oracle, "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None,
        "launches_by_path": {"main_path": 0, "assoc_path": 0,
                             "oracle_path": k1_oracle, "sweep_path": 0,
                             "residency_path": res_k1,
                             "chaos_path": chaos_k1, "resume_path": 0,
                             "serve_path": 0, "serve_path_bf16": 0,
                             "serve_path_phi4": 0}}, {
        "name": "linear_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan/kernel.py:56",
        "launches": scan_launches, "max_abs_err": scan_rec["max_abs_err"],
        "ms": scan_rec["ms"], "plain_ms": scan_rec["plain_ms"],
        "bound_ms": scan_rec["bound_ms"], "bound_by": scan_rec["bound_by"],
        "library_ms": scan_rec["library_ms"],
        "library": scan_rec["library"], "shape": scan_rec["shape"],
        "launches_by_path": {"main_path": 0, "assoc_path": scan_launches,
                             "oracle_path": 0, "sweep_path": 0,
                             "residency_path": res_scan,
                             "chaos_path": chaos_scan,
                             "resume_path": resume_scan,
                             "serve_path": 0, "serve_path_bf16": 0,
                             "serve_path_phi4": 0}},
        # K3 at the serve path's shape, N(0, 1) inputs: the fp32 design
        # on serve_path, the bf16 (tensor-core) design on serve_path_bf16
        _flash_entry("flash_attention", fv[("main", torch.float32)],
                     flash_launches, {"serve_path": flash_launches},
                     "fa_f32.cuh"),
        _flash_entry("flash_attention_bf16", fv[("main", torch.bfloat16)],
                     flash_launches_bf16,
                     {"serve_path_bf16": flash_launches_bf16},
                     "fa_bf16.cuh"),
        # the bf16 design's head-dim-128 instance at phi4-mini's prefill
        # shape, which serve_path_phi4 launches once a layer
        _flash_entry("flash_attention_bf16_hd128",
                     fv[(PHI4_CASE, torch.bfloat16)], flash_launches_phi4,
                     {"serve_path_phi4": flash_launches_phi4},
                     "fa_bf16.cuh")]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

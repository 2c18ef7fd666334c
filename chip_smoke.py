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
* ``serve_path_mamba``: ``serve`` on Falcon-Mamba-7B (Mamba-1 SSM) at
  full width and depth in bf16, batch 8, prompt 2016, 32 greedy tokens,
  which runs the fused selective-scan kernel (K2 redesigned for the
  Mamba layer: JAX's ``_fused_chunk_scan``, the coefficients, the
  recurrence and y = h . C in one pass) once per layer of the prefill at
  (8, 2016, 8192, 16), K2 itself not at all, and neither in decode;
* ``serve_path_rgemma``: ``serve`` on RecurrentGemma-9B (RG-LRU + local
  MQA hybrid, 38 layers) at full width and depth in bf16, batch 8,
  prompt 2016, 32 greedy tokens, which runs K2 once per RG-LRU layer (26
  launches at (8, 2016, 4096) fp32) and K3's head-dim-256 instance once
  per local-attention layer (12 launches) of the prefill, and neither in
  decode;
* ``serve_path_deepseek``: ``serve`` on DeepSeek-V2-Lite-16B (MLA + 64
  routed experts top-6 and 2 shared, 27 layers) at full width and depth
  in bf16, batch 8, prompt 2016, 32 greedy tokens: its MLA prefill runs
  plain PyTorch (``blocked_attention``) as every JAX branch does, so no
  kernel is launched;
* ``serve_path_kimi``: ``serve`` on Kimi-K2 (GQA at head dim 112, 384
  routed experts top-8 and 1 shared) at full width with the depth cut
  to 2 layers (1 dense + 1 MoE) in bf16, the same shape, which runs K3's
  head-dim-112 instance once per layer of the prefill and never in
  decode;
* ``serve_path_whisper``: ``serve`` on Whisper-small (audio
  encoder-decoder) at full size in bf16, 32 clips of 1536 stub frame
  embeddings, a 4-token prompt, 124 greedy tokens, which runs K3
  non-causal at (32, 1536, 12, 1, 64) once per encoder layer and causal
  once per decoder layer of the prefill (24 launches; the
  cross-attention is plain PyTorch, as in the JAX package), and never in
  decode;
* ``serve_path_qwen2vl``: ``serve`` on Qwen2-VL-72B at full width with
  its depth cut to 30 layers in bf16, batch 8, 1024 stub patch
  embeddings and 992 text tokens, 32 greedy tokens, which runs K3's
  head-dim-128 instance on M-RoPE-rotated q/k once per layer of the
  prefill and never in decode;
* ``chaos_path``: main_path's shape under the chaos layer
  (``tests/test_faults.py``'s mixed faults at rate 0.15 and its guards,
  ``max_staleness`` 8 and ``max_delta_norm`` 0.5): asofed with the
  ``random_mask`` upload codec (``feature_fold`` once a tick, with each
  slot's fold count read on the card), fedasync associative under noise
  corruption, the downweight policy and ``quantized_delta`` (K2 five
  times a tick), fedbuff sequential; host and device residency bit for
  bit, the port's asofed oracle against the engine (one per-row K1
  launch a server fold, two for a duplicate), the card against the CPU,
  and the synchronizing calls of a chaos window against main_path's;
* ``train_path``: ``repro_torch.launch.train.train`` on Qwen2-0.5B at
  full size in fp32, the training CLI's defaults (4 clients, batch 8 x
  128, 40 steps), from the seed-0 weights with every attention's wq and
  wk scaled by 1/8 (as drawn, the gradient at init is ~1e13 and the run
  diverges, as the JAX package's does): the loss on the plain attention
  under autograd, the ASO-Fed transform, the fold and one per-row K1
  launch a fold over the (151936, 896) token embedding, gated on the
  first local step lowering its batch's loss and changing it over the
  step by what its gradient predicts, then one more step profiled;
* ``train_path_mamba``: the same loop on Falcon-Mamba-7B at full width
  (d_inner 8192, N 16, vocab 65024, tied) with its depth cut to 4 of 64
  layers, from the seed-0 weights as drawn: a gradient runs the fused
  selective scan once a layer at (8, 128, 8192, 16) fp32, saving the
  state before each chunk (JAX's ``_fused_chunk_scan`` with its
  checkpointed chunk body), and its backward kernel once, which
  recomputes a chunk's states at a time from those; K2 not at all; a
  fold one per-row K1 launch over the (65024, 4096) embedding; gated on
  the first local step as train_path, then one step profiled;
* ``train_path_deepseek``: the same loop on DeepSeek-V2-Lite-16B at full
  width with its depth cut to 2 of 27 layers (the dense layer and one
  64-expert MoE layer), attention cooled: MLA and the gathered expert
  products under autograd (one host read of the per-expert counts a
  forward), one per-row K1 launch a fold over the (102400, 2048)
  embedding, then one step profiled;
* ``train_step_rgemma``: one loss and gradient of RecurrentGemma-9B at
  full width, depth cut to one (rglru, rglru, attn) period, batch 8 x
  128 (K2 and its backward twice at (8, 128, 4096)), gated on the
  central difference along its first ASO-Fed step; its whole loop does
  not fit one card at this width;
* ``train_step_mamba_long``: train_path_mamba's model, two timed
  gradients at batch 8 x 2048 (8 chunks of 256 steps: the carry between
  chunks on the path), the fused scan and its backward once a layer
  each, gated the same way;
* ``train_step_families``: one loss and gradient each, gated the same
  way and launching no kernel, of Kimi-K2 (full width, 2 layers, 16
  experts), Whisper-small (full size, 1536 stub frames a clip) and
  Qwen2-VL-72B (full width, 2 layers, 1024 stub patches + 992 tokens);
* ``train_card_vs_cpu`` holds train_path's full width at 2 layers,
  Falcon-Mamba's and DeepSeek-V2-Lite's at 2 layers (each its gradient,
  Falcon-Mamba's also at 1 x 512, two chunks, then its loop),
  RecurrentGemma's gradient at 3 and Kimi-K2's, Whisper's
  and Qwen2-VL's at cut depth against the CPU (the MoE cases with the
  CPU taking the card's expert ids, the flips counted), and
  ``quickstart_path`` runs the quickstart (reduced TinyLlama, 24 rounds,
  then K3 once a layer of the prefill).

Before the paths, ``fold_vs_plain`` holds ``feature_fold`` against its
plain version (the per-arrival loop) and times it beside the per-arrival
chain it replaced (the loop with K1 in it), with and without a per-slot
fold count (``reps``: 0, 1 or 2 folds a slot).  Each path is driven with
the launch counts set to 0 just before it and read just after.  Then
the card's trajectories are held against the CPU's for every ported
strategy, the associative fold against the sequential one on the card,
and the card's prefill and teacher-forced decode logits and caches
against the CPU's (TinyLlama, Falcon-Mamba, RecurrentGemma, whose
reduced config wraps its local-attention ring on the card,
DeepSeek-V2-Lite, whose full-width case also counts its routing flips
and measures the gap again with the card's expert ids forced on the
CPU, Kimi-K2, Whisper and Qwen2-VL); ``serve_gap_bisect`` splits the
DeepSeek-V2-Lite and RecurrentGemma full-width gaps op by op (each op's
own gap on the CPU's input and the carried gap), as drawn and with the
attention's query and key projections cooled.
``scan_vs_plain`` also holds K2 at the Mamba and RG-LRU prefills' and
RecurrentGemma's training shape bit for bit against its plain version
(the Mamba prefill's as the earlier design's time), K2's backward kernel
at that training shape against its plain reverse loop, the fused
selective scan at the Mamba prefill's (``mamba_fused``, bf16 as served,
bounded by its own SASS instruction count) and at its edges bit for bit
against its plain version (JAX's chunk loop in PyTorch), and its
backward at the Mamba training paths' scans (``mamba_fused_backward``
at 8 x 128 and ``_long`` at 8 x 2048, timed, bounded by the function's
own work, its SASS counts, registers, shared memory and waves recorded
beside) and at five edges against its plain version (dxh, ddt and dA bit
for bit), before any model's weights are on the card.  Prints one JSON
line per phase, then a ``{"kernels": [...]}`` line, the card's name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before that line; without a CUDA card it
exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import math
import os
import re
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
# K1 at the training paths' first layer, the (vocab, d) token embedding:
# Qwen2-0.5B's (544.6 MB in fp32, train_path), Falcon-Mamba-7B's (1.065
# GB, 16 KB rows, train_path_mamba) and DeepSeek-V2-Lite's (839 MB, 8 KB
# rows, train_path_deepseek), timed over fewer calls a graph (~0.3-0.9 ms
# each); {case: shape}
EMBED_TABLES = {"embed_table": (151936, 896),
                "embed_table_mamba": (65024, 4096),
                "embed_table_deepseek": (102400, 2048)}
EMBED_REPS = 20
# K1's edge cases, untimed: {case: (rows, cols, dtype, storage offset in
# elements, edge rows)} -> the route and warps a row they must take.  Edge
# rows: a zero row, a tiny row (|w| ~ 1e-20: ||e w|| takes the 1e-12
# clamp), a one-hot row at |w| = 80, a row holding an inf and one holding
# a NaN (NaN where the plain version has NaN)
K1_EDGE_CASES = {
    "edge_rows_896": ((64, 896, torch.float32, 0, True), ("vector", 1)),
    "edge_rows_896_bf16": ((64, 896, torch.bfloat16, 0, True),
                           ("vector", 1)),
    "edge_rows_4096": ((16, 4096, torch.float32, 0, True), ("vector", 4)),
    "group_8192": ((8, 8192, torch.float32, 0, False), ("vector", 8)),
    "cols_1": ((40, 1, torch.float32, 0, False), ("scalar", 1)),
    "cols_3": ((40, 3, torch.float32, 0, False), ("scalar", 1)),
    "cols_33": ((40, 33, torch.float32, 0, True), ("scalar", 1)),
    "cols_1025": ((20, 1025, torch.float32, 0, True), ("scalar", 4)),
    "bf16_odd_cols": ((37, 129, torch.bfloat16, 0, True), ("scalar", 1)),
    "unaligned": ((64, 896, torch.float32, 1, True), ("scalar", 2)),
    "too_wide": ((6, 8193, torch.float32, 0, True), ("wide", 8)),
}
K1_TINY = 1e-20
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


def scan_backward_bound(shape, with_last: bool):
    """(bound_ms, bound_by) of the reverse recurrence on fp32 (B, S, C):
    a, h and dh (and dh_last) read once, da and db written once, over HBM
    bandwidth, against a multiply, an add and a multiply an element."""
    B, S, C = shape
    nbytes = (5 * B * S * C + (B * C if with_last else 0)) * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * B * S * C / FP32_OPS_PER_S * 1e3
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


def _k1_design(w) -> dict:
    """The per-row K1's layout of ``w`` (``feature_attention_plan``): its
    route (``k1_route``: vector, scalar or wide; the kernels line's
    ``route`` is the contract's cuda / triton), warps a row, vectors a
    lane, registers, spills, resident warps an SM, and the loads those
    warps hold in flight an SM (each its share of a row)."""
    from repro_torch.kernels.feature_attention import kernel

    if not hasattr(kernel, "feature_attention_plan"):  # an earlier design:
        # --only against another checkout's package
        return {"k1_route": None, "warps_per_row": None, "design": None}
    p = kernel.feature_attention_plan(w)
    warps = p["blocks_per_sm"] * p["threads_per_block"] // 32
    row_share = (32 * p["vectors_per_lane"] * p["vector_elems"]
                 * w.element_size())
    return {"k1_route": p["route"], "warps_per_row": p["warps_per_row"],
            "design": {**p, "resident_warps_per_sm": warps,
                       "bytes_in_flight_per_sm": (warps * row_share
                                                  if p["route"] != "wide"
                                                  else None)}}


def _k1_edge_matrix(rows, cols, dtype, offset, edges):
    """(rows, cols) on the card from seed 0, ``offset`` elements into its
    storage, with K1_EDGE_CASES's edge rows first if ``edges``."""
    x = np.random.default_rng(0).standard_normal((rows, cols)).astype(
        np.float32)
    if edges:
        x[0] = 0.0
        x[1] *= K1_TINY
        x[2] *= 0.01
        x[2, cols // 2] = -80.0
        x[3, cols - 1] = np.inf
        x[4, 0] = np.nan
    flat = torch.empty(offset + rows * cols, dtype=dtype, device="cuda")
    w = flat[offset:].view(rows, cols)
    w.copy_(torch.from_numpy(x))
    return w


def _k1_edge_case(case, spec, want_route):
    """K1 against its plain version on an edge case: NaN exactly where the
    plain version has NaN, elsewhere within TOL per unit of the largest
    magnitude, and the zero, tiny and one-hot rows within TOL of their own
    largest magnitude; on the route and warps a row it must take."""
    from repro_torch.kernels.feature_attention.kernel import (
        feature_attention_kernel)
    from repro_torch.kernels.feature_attention.ref import (
        feature_attention_ref)

    rows, cols, dtype, offset, edges = spec
    w = _k1_edge_matrix(rows, cols, dtype, offset, edges)
    design = _k1_design(w)
    if design["k1_route"] is not None and (
            design["k1_route"], design["warps_per_row"]) != want_route:
        raise AssertionError(f"feature_attention {case}: route "
                             f"{design['k1_route']} with "
                             f"{design['warps_per_row']} warps a row, "
                             f"expected {want_route}")
    errs = {}
    for normalize in (True, False):
        got = feature_attention_kernel(w, normalize).float()
        want = feature_attention_ref(w, normalize).float()
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        fin = ~nan
        err = float((got - want)[fin].abs().max())
        tol = TOL[dtype] * max(1.0, float(want[fin].abs().max()))
        row_errs = [float((got[r] - want[r]).abs().max()) /
                    max(float(want[r].abs().max()), 1e-300)
                    for r in (range(3) if edges else ())]
        ok = (torch.equal(torch.isnan(got), nan) and err < tol
              and all(e <= TOL[dtype] for e in row_errs))
        if edges:  # the zero row stays 0, the inf and NaN rows are NaN
            ok = ok and float(want[0].abs().max()) == 0.0 and bool(
                nan[3].all() and nan[4].all())
        if not ok:
            raise AssertionError(
                f"feature_attention kernel disagrees with its plain version "
                f"on {case} {tuple(w.shape)} {dtype} normalize={normalize}: "
                f"max abs err {err} (tolerance {tol}), edge rows' errors "
                f"per unit of their own magnitude {row_errs}")
        errs[normalize] = (err, tol, row_errs)
    rec = {"phase": "kernel_vs_plain", "kernel": "feature_attention",
           "case": case, "shape": [rows, cols], "dtype": str(dtype),
           "storage_offset": offset, "edge_rows": edges,
           "max_abs_err": max(e[0] for e in errs.values()),
           "tolerance": min(e[1] for e in errs.values()),
           "edge_row_err_per_unit": [max(e[2][r] for e in errs.values())
                                     for r in range(3 if edges else 0)],
           "nan_rows_match": True if edges else None, **design}
    emit(rec)
    return rec


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
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       **_k1_design(w2)}
                emit(rec)
                rows_out[(tuple(shape), dtype, normalize)] = rec
    # the training paths' feature pass on the (vocab, d) fp32 token
    # embedding, drawn as its init (N(0, 0.02)), once a fold
    for case, table in EMBED_TABLES.items():
        rows_out[case] = _embed_table_case(case, table)
    for case, (spec, route) in K1_EDGE_CASES.items():
        rows_out[case] = _k1_edge_case(case, spec, route)
    return rows_out


def _embed_table_case(case: str, table):
    """K1 against its plain version at a training path's embedding."""
    from repro_torch.kernels.feature_attention.kernel import (
        feature_attention_kernel)
    from repro_torch.kernels.feature_attention.ref import (
        feature_attention_ref)

    w = torch.randn(table, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda").mul_(0.02)
    got = feature_attention_kernel(w, True)
    want = feature_attention_ref(w, True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = TOL[torch.float32] * max(1.0, float(want.abs().max()))
    del got, want
    if not err < tol:
        raise AssertionError(
            f"feature_attention kernel disagrees with its plain version at "
            f"the embedding table {table}: max abs err {err} "
            f"(tolerance {tol})")
    bound_ms, bound_by = feature_bound(*table, 4)
    out = torch.empty_like(w)
    rec = {"phase": "kernel_vs_plain", "kernel": "feature_attention",
           "case": case, "shape": list(table),
           "dtype": str(torch.float32), "normalize": True,
           "max_abs_err": err, "tolerance": tol,
           "ms": device_ms(lambda: feature_attention_kernel(w, True),
                           EMBED_REPS),
           "plain_ms": device_ms(lambda: feature_attention_ref(w, True),
                                 EMBED_REPS),
           "call_ms": call_ms(lambda: feature_attention_kernel(w, True),
                              EMBED_REPS),
           # a yardstick beside the bound, not the same function: the
           # card's own device-to-device copy of the same bytes
           "copy_ms": device_ms(lambda: out.copy_(w), EMBED_REPS),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           **_k1_design(w)}
    del out
    emit(rec)
    del w
    torch.cuda.empty_cache()
    return rec


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
    # K2's design at the Mamba prefill's scan, kept as the yardstick of
    # the fused kernel that replaced it on that path
    rows_out["mamba"] = _model_scan_case("mamba_prefill", MAMBA_SCAN_SHAPE,
                                         MAMBA_SCAN_REPS)
    for name, shape, dtype in SELECTIVE_CASES:
        rows_out[name] = _selective_case(name, shape, dtype)
    rows_out["rglru"] = _model_scan_case("rglru_prefill", RGEMMA_SCAN_SHAPE,
                                         RGEMMA_SCAN_REPS)
    rows_out["rglru_train"], rows_out["rglru_train_backward"] = \
        _train_scan_case("rglru_train", RGEMMA_TRAIN_SCAN)
    for name, shape, reps in SELECTIVE_BWD_CASES:
        rows_out[name] = _selective_backward_case(name, shape, reps)
    return rows_out


def selective_bound(B: int, S: int, di: int, N: int, itemsize: int,
                    per_elem: dict):
    """(bound_ms, bound_by, detail) of the fused selective scan on these
    shapes: xh and dt read once (xh in ``itemsize`` bytes), bc (B, S, 2N)
    and A once, y and h_last written once, over HBM bandwidth; against
    the B S di N elements times the kernel's own instructions an element
    (``per_elem``, read from its SASS by ``_sass_loop_counts``): the
    FP32-pipe ones at 128 a clock an SM and the MUFU.EX2 (inside expf)
    at 16 a clock an SM, at the clock FP32_OPS_PER_S implies (1.98 GHz on
    132 SMs).  ``detail`` also gives the issue limit (every instruction,
    one warp instruction a clock per scheduler), which the bound does not
    take."""
    elems = B * S * di * N
    nbytes = (B * S * di * (itemsize + 4 + 4) + B * S * 2 * N * itemsize
              + di * N * 4 + B * di * N * 4)
    fp32_rate = FP32_OPS_PER_S / 2  # FP32-pipe instructions a second
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32_pipe": elems * per_elem["fp32"] / fp32_rate * 1e3,
             "sfu": elems * per_elem["ex2"] / (fp32_rate / 8) * 1e3}
    limit = max(times, key=times.get)
    detail = {**{f"{k}_ms": v for k, v in times.items()},
              "issue_ms": elems * per_elem["all"] / fp32_rate * 1e3,
              "bytes": nbytes, "elements": elems, "binds": limit,
              "per_element": per_elem}
    return times[limit], ("bytes" if limit == "bytes" else "operations"), \
        detail


# FP32-pipe opcodes of Hopper's SASS (FFMA, FMUL, FADD and their forms,
# FMNMX, FSEL, FSETP, FCHK) and the SFU's exponential
_SASS_FP32 = ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSETP", "FCHK")


@functools.lru_cache(maxsize=None)
def _sass(lib: str) -> str:
    """``cuobjdump -sass`` of a built library (read once a process)."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def _sass_instructions(lib: str, kernel: str) -> list:
    """(address, opcode, operands) of each instruction of the function
    whose name holds ``kernel``, from ``cuobjdump -sass`` of the built
    library."""
    out = _sass(lib)
    funcs, cur = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :")[1].strip()
            funcs[cur] = []
            continue
        if cur is None or "/*" not in ln or ";" not in ln:
            continue
        head = ln.split("*/", 1)[0].strip().lstrip("/*").strip()
        body = ln.split("*/", 1)[1].split(";")[0].strip()
        if not body:
            continue
        try:
            addr = int(head, 16)
        except ValueError:
            continue
        toks = body.split()
        if toks[0].startswith("@"):
            toks = toks[1:]
        funcs[cur].append((addr, toks[0], toks[1:]))
    return next(v for k, v in funcs.items() if kernel in k)


def _sass_function_counts(lib: str, kernel: str) -> dict:
    """The count of each opcode (its name before the first dot) in
    ``kernel``'s SASS, "all" and "ex2" (the MUFU.EX2s)."""
    ops = {"all": 0, "ex2": 0}
    for _, op, _ in _sass_instructions(lib, kernel):
        ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
        ops["all"] += 1
        ops["ex2"] += op.startswith("MUFU.EX2")
    return ops


def _sass_loop_counts(lib: str, kernel: str) -> list:
    """The innermost loops of ``kernel`` that hold a MUFU.EX2, from
    ``cuobjdump -sass`` of the built library, in address order: each
    loop is a backward branch's range around MUFU.EX2s that holds no
    other such range, and an element is one MUFU.EX2 (one exp a state
    element).  Each loop's {"fp32", "ex2", "all", and a count for each
    opcode} an element, its length and its MUFU.EX2 count."""
    insts = _sass_instructions(lib, kernel)
    ranges = []
    for addr, op, args in insts:
        if op.startswith("BRA") and args:
            try:
                target = int(args[-1].strip("`()"), 16)
            except ValueError:
                continue
            body = [o for a, o, _ in insts if target <= a <= addr]
            if target <= addr and any(o.startswith("MUFU.EX2")
                                      for o in body):
                ranges.append((target, addr, body))
    loops = []
    for lo, hi, body in sorted(ranges):
        if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
               for l2, h2, _ in ranges):
            continue  # holds an inner exp loop
        n_ex2 = sum(o.startswith("MUFU.EX2") for o in body)
        ops = {}
        for o in body:
            ops[o.split(".")[0]] = ops.get(o.split(".")[0], 0) + 1
        per = {k: v / n_ex2 for k, v in sorted(ops.items())}
        loops.append({
            "fp32": sum(v for k, v in per.items() if k in _SASS_FP32),
            "ex2": 1.0, "all": len(body) / n_ex2,
            "loop_instructions": len(body), "loop_ex2": n_ex2,
            "opcodes": per})
    return loops


def _selective_inputs(shape, dtype, seed: int = 0):
    """A Mamba layer's scan inputs drawn on the card as the served model
    forms them: xh = silu(N(0, 1)) and bc N(0, 1) in ``dtype``, dt =
    softplus(N(0, 1) / 2 + b_dt) with b_dt ~ U(-4, 4) a channel (the
    init's range), A = -exp(U(-1, 1)) (A_log's init) in fp32."""
    B, S, di, N = shape
    gen = torch.Generator(device=DEV).manual_seed(seed)
    u = lambda *sh: torch.rand(sh, generator=gen, device=DEV)  # noqa: E731
    xh = torch.nn.functional.silu(torch.randn(
        (B, S, di), generator=gen, device=DEV)).to(dtype)
    b_dt = u(di).mul_(8.0).sub_(4.0)
    dt = torch.nn.functional.softplus(torch.randn(
        (B, S, di), generator=gen, device=DEV).mul_(0.5).add_(b_dt))
    A = -torch.exp(u(di, N).mul_(2.0).sub_(1.0))
    bc = torch.randn((B, S, 2 * N), generator=gen, device=DEV).to(dtype)
    return xh, dt, A, bc


def _selective_case(name: str, shape, dtype):
    """The fused selective scan against its plain version
    (``selective_scan_ref``, JAX's chunk loop in PyTorch) on the card:
    h_last bit for bit (both round each product and sum alone, exp
    included), y within SELECTIVE_Y_TOL of its largest magnitude overall
    and in every (b, s) row (the sums over n differ in order).  The
    served shape is timed (kernel, plain version) and bounded by its own
    SASS instruction count; no single PyTorch call computes the
    function, so ``library_ms`` is None."""
    from repro_torch.kernels import build
    from repro_torch.kernels.linear_scan.kernel import selective_scan_kernel
    from repro_torch.kernels.linear_scan.ref import selective_scan_ref

    B, S, di, N = shape
    xh, dt, A, bc = _selective_inputs(shape, dtype)
    y, h_last = selective_scan_kernel(xh, dt, A, bc)
    want, want_last = selective_scan_ref(xh, dt, A, bc)
    torch.cuda.synchronize()
    bitwise = torch.equal(h_last, want_last)
    h_err = _max_abs_diff(h_last, want_last)
    diff = (y - want).abs()
    y_err = float(diff.max())
    y_scale = float(want.abs().max())
    row_err = float((diff.amax(-1) / want.abs().amax(-1).clamp_min(
        1e-30)).max())
    finite = bool(torch.isfinite(y).all() and torch.isfinite(h_last).all())
    del diff
    if not (bitwise and finite and y.dtype == torch.float32
            and y_err <= SELECTIVE_Y_TOL * y_scale
            and row_err <= SELECTIVE_Y_TOL):
        raise AssertionError(
            f"selective_scan kernel at {name} {tuple(shape)} {dtype}: h_last "
            f"bit for bit {bitwise} (max abs err {h_err}), y max abs err "
            f"{y_err} against {SELECTIVE_Y_TOL} x {y_scale}, worst row "
            f"{row_err} per unit, finite {finite}")
    rec = {"phase": "kernel_vs_plain", "kernel": "selective_scan",
           "case": name, "shape": list(shape), "dtype": str(dtype),
           "h_last_bitwise": bitwise, "h_last_max_abs_err": h_err,
           "max_abs_err": y_err, "y_scale": y_scale,
           "y_err_per_unit": y_err / y_scale, "row_err_per_unit": row_err,
           "tolerance_per_unit": SELECTIVE_Y_TOL}
    if name == "mamba_fused":
        lib = build.library_path("selective_scan")
        # the serving instance: no chunk carries stored
        kname = ("selective_scan_fwdI13__nv_bfloat16Lb0E" if dtype ==
                 torch.bfloat16 else "selective_scan_fwdIfLb0E")
        # its step loop: the shortest innermost exp loop
        per = min(_sass_loop_counts(lib, kname),
                  key=lambda r: r["loop_instructions"])
        bound_ms, bound_by, detail = selective_bound(
            B, S, di, N, xh.element_size(), per)
        kern = lambda: selective_scan_kernel(xh, dt, A, bc)  # noqa: E731
        ms = device_ms(kern, reps=SELECTIVE_REPS)
        rec.update(
            ms=ms, call_ms=call_ms(kern, reps=SELECTIVE_REPS),
            # the plain loop issues ~3 ops a step: one call a graph
            plain_ms=device_ms(lambda: selective_scan_ref(xh, dt, A, bc),
                               reps=1),
            bound_ms=bound_ms, bound_by=bound_by, bound_detail=detail,
            bound_share=bound_ms / ms, library_ms=None,
            library="none: no single PyTorch call computes the function",
            ptxas=[ln.strip() for ln in build.BUILD_LOG.get(
                "selective_scan", (0.0, ""))[1].splitlines()
                if "registers" in ln or "spill" in ln or "smem" in ln])
    emit(rec)
    del xh, dt, A, bc, y, h_last, want, want_last
    torch.cuda.empty_cache()
    return rec


# the fused backward's own work an element (b, s, d, n), whatever the
# design: the 23 products and sums its plain version rounds (the chunk's
# states recomputed once: dt A, dt B, (dt B) x, dA h, + dBx; the reverse
# walk: gy C, + r, g (dt B), + over n, g x, (g h) dA, q A, (g x) B, +, +
# over n, q dt, + over t, (g x) dt, + over d, gy h, + over d, dA g) and
# one expf, 6 FP32-pipe instructions and one MUFU.EX2 on sm_90a
SELECTIVE_BWD_FP32_PER_ELEM = 23 + 6
SELECTIVE_BWD_EX2_PER_ELEM = 1


def selective_backward_bound(B: int, S: int, di: int, N: int, c: int):
    """(bound_ms, bound_by, detail) of the fused backward on these
    shapes, the function's own work and no design's: its inputs xh, dt,
    gy (B, S, di), bc (B, S, 2N), A, the chunk carries (B, S / c, di, N)
    and gh_last read once, dxh, ddt, dA and dbc written once, over HBM
    bandwidth; against the B S di N elements times
    SELECTIVE_BWD_FP32_PER_ELEM FP32-pipe instructions at 128 a clock an
    SM and SELECTIVE_BWD_EX2_PER_ELEM MUFU.EX2 at 16, at the clock
    FP32_OPS_PER_S implies (1.98 GHz on 132 SMs)."""
    elems = B * S * di * N
    nbytes = 4 * (5 * B * S * di + 2 * B * S * 2 * N + 2 * di * N
                  + B * (S // c) * di * N + B * di * N)
    fp32_rate = FP32_OPS_PER_S / 2  # FP32-pipe instructions a second
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "fp32_pipe": elems * SELECTIVE_BWD_FP32_PER_ELEM / fp32_rate
             * 1e3,
             "sfu": elems * SELECTIVE_BWD_EX2_PER_ELEM / (fp32_rate / 8)
             * 1e3}
    limit = max(times, key=times.get)
    detail = {**{f"{k}_ms": v for k, v in times.items()},
              "bytes": nbytes, "elements": elems, "binds": limit,
              "per_element": {"fp32": SELECTIVE_BWD_FP32_PER_ELEM,
                              "ex2": SELECTIVE_BWD_EX2_PER_ELEM}}
    return times[limit], ("bytes" if limit == "bytes" else "operations"), \
        detail


def _selective_backward_design(B: int, S: int, di: int, N: int, c: int):
    """The running backward's own costs, beside its bound and not in it:
    its instructions from the SASS of ``selective_scan_bwd`` (the whole
    function; each element runs expf twice, on the chunk's first walk and
    in its stage's record, so the function's instructions over half its
    MUFU.EX2s are what an element issues, the prologue included), the
    issue limit they set (one warp instruction a clock per scheduler),
    the scratch in device memory (none), and its launch: ptxas's
    registers, spills and static shared memory, the dynamic shared memory
    and blocks an SM at this chunk (the library's occupancy entry), and
    the waves of blocks on this card.  An earlier design's library, which
    has no occupancy entry, gives its SASS counts alone."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.linear_scan import kernel

    lib_path = build.library_path("selective_scan")
    ops = _sass_function_counts(lib_path, "selective_scan_bwd")
    per = {k: v * 2 / ops["ex2"] for k, v in ops.items()}
    fp32 = sum(v for k, v in per.items() if k in _SASS_FP32)
    elems = B * S * di * N
    out = {"sass_per_element": {"all": per["all"], "fp32": fp32,
                                "opcodes": per},
           "issue_ms": elems * per["all"] / (FP32_OPS_PER_S / 2) * 1e3,
           "ptxas": _ptxas_function(build.BUILD_LOG.get(
               "selective_scan", (0.0, ""))[1], "selective_scan_bwd")}
    fn = getattr(build.load("selective_scan"),
                 "selective_scan_backward_occupancy", None)
    if fn is None:
        return {**out, "design": "earlier (no occupancy entry)"}
    smem, blocks_sm = ctypes.c_int(0), ctypes.c_int(0)
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    err = fn(c, ctypes.byref(smem), ctypes.byref(blocks_sm))
    if err:
        raise RuntimeError(f"selective_scan_backward_occupancy: CUDA error "
                           f"{err}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-di // kernel.SELECTIVE_BLOCK) * B
    return {**out, "scratch_bytes": 0, "dynamic_smem_bytes": smem.value,
            "blocks_per_sm": blocks_sm.value, "sms": sms, "blocks": blocks,
            "waves": blocks / (blocks_sm.value * sms)}


def _ptxas_function(log: str, name: str) -> dict:
    """ptxas's -v report of the entry function whose name holds ``name``:
    registers, spill stores and loads and static shared memory in bytes
    (empty where the log has no such entry)."""
    rec, inside = {}, False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            inside = name in ln
            continue
        if not inside:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            rec["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            rec["static_smem_bytes"] = int(m.group(1)) if m else 0
    return rec


def _selective_backward_case(name: str, shape, reps: int):
    """The fused selective scan's backward against its plain version
    (``selective_scan_backward_ref``) on the card, fp32, inputs drawn as
    ``_selective_inputs`` and the gradients gy of y and gh_last of h_last
    N(0, 1): first the forward with its chunk carries (y, h_last and
    h_chunks bit for bit), then the backward with and without gh_last,
    dxh, ddt and dA bit for bit and dbc within SELECTIVE_BWD_TOL per unit
    of its largest magnitude.  With ``reps`` the kernel is timed
    (``reps`` launches a graph, with gh_last), its plain version once a
    graph, bounded by the function's own work
    (``selective_backward_bound``) and its design's costs recorded beside
    (``_selective_backward_design``); no PyTorch call computes the
    function, so ``library_ms`` is None."""
    from repro_torch.kernels.linear_scan.kernel import (
        selective_scan_backward_kernel, selective_scan_kernel)
    from repro_torch.kernels.linear_scan.ref import (
        fused_chunk, selective_scan_backward_ref, selective_scan_ref)

    B, S, di, N = shape
    xh, dt, A, bc = _selective_inputs(shape, torch.float32, seed=2)
    gen = torch.Generator(device=DEV).manual_seed(3)
    gy = torch.randn((B, S, di), generator=gen, device=DEV)
    gl = torch.randn((B, di, N), generator=gen, device=DEV)
    y, h_last, chunks = selective_scan_kernel(xh, dt, A, bc, chunks=True)
    want = selective_scan_ref(xh, dt, A, bc, chunks=True)
    fwd_bitwise = all(torch.equal(a, b)
                      for a, b in zip((y, h_last, chunks), want))
    del y, h_last, want
    rec = {"phase": "kernel_vs_plain", "kernel": "selective_scan_backward",
           "case": name, "shape": list(shape), "dtype": str(torch.float32),
           "chunk": fused_chunk(S), "n_chunks": S // fused_chunk(S),
           "forward_bitwise": fwd_bitwise,
           "tolerance_per_unit": SELECTIVE_BWD_TOL}
    ok = fwd_bitwise
    for tag, last in (("", gl), ("no_gh_last_", None)):
        got = selective_scan_backward_kernel(xh, dt, A, bc, chunks, gy, last)
        ref = selective_scan_backward_ref(xh, dt, A, bc, chunks, gy, last)
        torch.cuda.synchronize()
        bitwise = [torch.equal(a, b) for a, b in zip(got[:3], ref[:3])]
        errs = [_max_abs_diff(a, b) for a, b in zip(got, ref)]
        units = [e / max(_max_abs(b), 1e-30)
                 for e, b in zip(errs[2:], ref[2:])]
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        rec.update({f"{tag}dxh_bitwise": bitwise[0],
                    f"{tag}ddt_bitwise": bitwise[1],
                    f"{tag}dA_bitwise": bitwise[2],
                    f"{tag}max_abs_err": max(errs),
                    f"{tag}dA_err_per_unit": units[0],
                    f"{tag}dbc_err_per_unit": units[1],
                    f"{tag}finite": finite})
        ok = ok and all(bitwise) and finite and max(units) <= \
            SELECTIVE_BWD_TOL
        del got, ref
    if not ok:
        emit(rec)
        raise AssertionError(
            f"selective_scan backward at {name} {tuple(shape)}: {rec}")
    if reps:
        bound_ms, bound_by, detail = selective_backward_bound(
            B, S, di, N, fused_chunk(S))
        kern = lambda: selective_scan_backward_kernel(  # noqa: E731
            xh, dt, A, bc, chunks, gy, gl)
        ms = device_ms(kern, reps=reps)
        rec.update(
            ms=ms, call_ms=call_ms(kern, reps=reps),
            # the plain loops issue ~5 ops a step: one call a graph
            plain_ms=device_ms(lambda: selective_scan_backward_ref(
                xh, dt, A, bc, chunks, gy, gl), reps=1),
            bound_ms=bound_ms, bound_by=bound_by, bound_detail=detail,
            bound_share=bound_ms / ms, library_ms=None,
            library="none: no single PyTorch call computes the function",
            design=_selective_backward_design(B, S, di, N, fused_chunk(S)))
    emit(rec)
    del xh, dt, A, bc, gy, gl, chunks
    torch.cuda.empty_cache()
    return rec


def _train_scan_case(case: str, shape):
    """K2's forward and backward kernels at a training path's scan, fp32,
    drawn on the card: a uniform in (0.5, 0.999), b, the gradient dh of h
    and dh_last of h_last N(0, 1).  Each is held bit for bit against its
    plain version (the forward's plain loop, ``linear_scan_backward_ref``)
    and timed with SCAN_TRAIN_REPS launches a graph; no PyTorch call
    computes either (torch.cumsum only the a = 1 forward), so
    ``library_ms`` is None.  Returns (forward record, backward record)."""
    from repro_torch.kernels.linear_scan.kernel import (
        linear_scan_backward_kernel, linear_scan_kernel)
    from repro_torch.kernels.linear_scan.ref import (
        linear_scan_backward_ref, linear_scan_ref)

    B, S, C = shape
    gen = torch.Generator(device=DEV).manual_seed(1)
    a = torch.rand((B, S, C), generator=gen, device=DEV).mul_(0.499).add_(0.5)
    b = torch.randn((B, S, C), generator=gen, device=DEV)
    dh = torch.randn((B, S, C), generator=gen, device=DEV)
    dh_last = torch.randn((B, C), generator=gen, device=DEV)
    h, h_last = linear_scan_kernel(a, b)
    want, want_last = linear_scan_ref(a, b)
    torch.cuda.synchronize()
    fwd_bitwise = torch.equal(h, want) and torch.equal(h_last, want_last)
    fwd_err = max(_max_abs_diff(h, want), _max_abs_diff(h_last, want_last))
    del want, want_last
    da, db = linear_scan_backward_kernel(a, h, dh, dh_last)
    want_da, want_db = linear_scan_backward_ref(a, h, dh, dh_last)
    torch.cuda.synchronize()
    bwd_bitwise = torch.equal(da, want_da) and torch.equal(db, want_db)
    bwd_err = max(_max_abs_diff(da, want_da), _max_abs_diff(db, want_db))
    finite = bool(torch.isfinite(h_last).all() and torch.isfinite(da).all())
    del da, db, want_da, want_db, h_last
    if not (fwd_bitwise and bwd_bitwise and finite):
        raise AssertionError(
            f"linear_scan at the {case} shape {shape} fp32: forward bit for "
            f"bit {fwd_bitwise} (max abs err {fwd_err}), backward bit for "
            f"bit {bwd_bitwise} (max abs err {bwd_err}), finite {finite}")
    out = []
    for kernel, err, kern, plain, (bound_ms, bound_by) in (
            ("linear_scan", fwd_err, lambda: linear_scan_kernel(a, b),
             lambda: linear_scan_ref(a, b), scan_bound(a, b)),
            ("linear_scan_backward", bwd_err,
             lambda: linear_scan_backward_kernel(a, h, dh, dh_last),
             lambda: linear_scan_backward_ref(a, h, dh, dh_last),
             scan_backward_bound(shape, True))):
        rec = {"phase": "kernel_vs_plain", "kernel": kernel, "case": case,
               "shape": [B, S, C], "dtype": str(torch.float32),
               "a": "uniform(0.5, 0.999)", "bitwise": True,
               "max_abs_err": err, "tolerance": 0.0,
               "ms": device_ms(kern, reps=SCAN_TRAIN_REPS),
               "call_ms": call_ms(kern, reps=SCAN_TRAIN_REPS),
               # the plain loops issue ~2-5 ops a step: one call a graph
               "plain_ms": device_ms(plain, reps=1),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        emit(rec)
        out.append(rec)
    del a, b, dh, dh_last, h
    torch.cuda.empty_cache()
    return tuple(out)


def _max_abs_diff(x: torch.Tensor, y: torch.Tensor) -> float:
    """max |x - y| a batch row at a time (no full-size temporary)."""
    return max(float((x[i] - y[i]).abs().max()) for i in range(x.shape[0]))


def _model_scan_case(case: str, shape, reps: int):
    """K2 at a model prefill's scan, fp32, drawn on the card (a in [0, 1),
    as Mamba's dA = exp(dt A) with dt > 0 and A < 0 and RG-LRU's a =
    exp(-c softplus(lam) sigmoid(.)) give; b N(0, 1)): Falcon-Mamba-7B's
    (B, S, d_inner x N) = (8, 2016, 131072), 2.11e9 elements, and
    RecurrentGemma-9B's (B, S, lru_width) = (8, 2016, 4096).  Held bit for
    bit against its plain version (the kernel's fp32 contract); timed
    with ``reps`` launches a graph; torch.cumsum along S on the same b as
    the library yardstick (a = 1)."""
    from repro_torch.kernels.linear_scan.kernel import linear_scan_kernel
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref

    B, S, C = shape
    gen = torch.Generator(device=DEV).manual_seed(0)
    a = torch.rand((B, S, C), generator=gen, device=DEV)
    b = torch.randn((B, S, C), generator=gen, device=DEV)
    h, h_last = linear_scan_kernel(a, b)
    want, want_last = linear_scan_ref(a, b)
    torch.cuda.synchronize()
    bitwise = torch.equal(h, want) and torch.equal(h_last, want_last)
    err = max(_max_abs_diff(h, want), _max_abs_diff(h_last, want_last))
    finite = bool(torch.isfinite(h_last).all())
    del h, h_last, want, want_last
    if not (bitwise and finite):
        raise AssertionError(
            f"linear_scan kernel at the {case} shape {shape} fp32 is not "
            f"bit for bit its plain version: max abs err {err}, finite "
            f"{finite}")
    kern = lambda: linear_scan_kernel(a, b)  # noqa: E731
    # the library yardstick against the kernel at a = 1 (broadcast over C)
    ones = torch.ones((B, S, 1), device=DEV)
    lib = lambda: torch.cumsum(b, dim=1)  # noqa: E731
    lib_err = _max_abs_diff(lib(), linear_scan_kernel(ones, b)[0])
    bound_ms, bound_by = scan_bound(a, b)
    rec = {"phase": "kernel_vs_plain", "kernel": "linear_scan",
           "case": case, "shape": [B, S, C],
           "a_shape": [B, S, C], "dtype": str(b.dtype), "bitwise": bitwise,
           "max_abs_err": err, "tolerance": 0.0,
           "ms": device_ms(kern, reps=reps),
           "call_ms": call_ms(kern, reps=reps),
           # the plain loop issues 2 S + 1 ops: one call a graph
           "plain_ms": device_ms(lambda: linear_scan_ref(a, b), reps=1),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library": "torch.cumsum along S",
           "library_ms": device_ms(lib, reps=reps),
           "library_max_abs_err_vs_a1": lib_err}
    emit(rec)
    del a, b, ones
    torch.cuda.empty_cache()
    return rec


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
        (first,) = first_layer_path(cfg_model)
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
        (first,) = first_layer_path(cfg_model)
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
    for k in (_fold_kernel(), _scan_backward_kernel(), _selective_kernel(),
              _selective_backward_kernel()):
        if k is not None:
            k.launches = 0


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


def _scan_backward_kernel():
    """K2's backward wrapper, or None in an older checkout's package."""
    from repro_torch.kernels.linear_scan import kernel

    return getattr(kernel, "linear_scan_backward_kernel", None)


def _scan_backward_launches() -> int:
    """K2 backward launches since the last reset (0 in a package without
    the backward kernel)."""
    k = _scan_backward_kernel()
    return 0 if k is None else k.launches


def _selective_kernel():
    """The fused selective scan's wrapper, or None in an older checkout's
    package."""
    from repro_torch.kernels.linear_scan import kernel

    return getattr(kernel, "selective_scan_kernel", None)


def _selective_launches() -> int:
    """Fused selective-scan launches since the last reset (0 in a package
    without it)."""
    k = _selective_kernel()
    return 0 if k is None else k.launches


def _selective_backward_kernel():
    """The fused selective scan's backward wrapper, or None in an older
    checkout's package."""
    from repro_torch.kernels.linear_scan import kernel

    return getattr(kernel, "selective_scan_backward_kernel", None)


def _selective_backward_launches() -> int:
    """Fused backward launches since the last reset (0 in a package
    without it)."""
    k = _selective_backward_kernel()
    return 0 if k is None else k.launches


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
# depth of the oracle check (e) and of the card-vs-CPU runs (f): 2 shared
# tick boundaries each
CHAOS_ORACLE_T, CHAOS_CPU_T = 64, 64
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
# serve() runs of a path timed after its warm-up: one, so that the
# training phases fit the script's time (PERF.md §4)
SERVE_REPEATS = 1
# tokens the warm-up serve() generates: the prefill and one decode step
# warm cuBLAS, the allocator and every decode kernel; the path's whole
# decode (32, Whisper's 124) cost the script ~21 s (PERF.md §4)
SERVE_WARMUP_GEN = 2
# serve_path_phi4's architecture (head dim 128) and its flash_vs_plain case
PHI4_ARCH, PHI4_CASE = "phi4-mini-3.8b", "phi4_layer0"
# serve_path_mamba's architecture, and K2's design at its prefill's scan
# (the yardstick of the fused kernel that replaced it there): (B, S,
# d_inner x N) = (8, 2016, 8192 x 16), timed with a few launches a graph
# (~10 ms each)
MAMBA_ARCH = "falcon-mamba-7b"
MAMBA_SCAN_SHAPE = (SERVE_B, SERVE_PROMPT, 8192 * 16)
MAMBA_SCAN_REPS = 5
# the fused selective scan (K2's redesign on the Mamba prefill, JAX's
# _fused_chunk_scan) against its plain version: (case, (B, S, d_inner,
# N), xh and bc dtype).  mamba_fused is serve_path_mamba's prefill scan
# (bf16 as served), timed with SELECTIVE_REPS launches a graph (~1 ms
# each); then the edges: fp32 (serve_card_vs_cpu's full-width case), S
# not a multiple of the kernel's 8-step stage, one step, d_inner not a
# multiple of its 128-channel block
SELECTIVE_CASES = [
    ("mamba_fused", (SERVE_B, SERVE_PROMPT, 8192, 16), torch.bfloat16),
    ("fp32", (2, 64, 8192, 16), torch.float32),
    ("ragged_s", (2, 13, 256, 16), torch.bfloat16),
    ("ragged_s_fp32", (3, 37, 136, 16), torch.float32),
    ("one_step", (2, 1, 128, 16), torch.bfloat16),
    ("ragged_di", (1, 40, 200, 16), torch.bfloat16)]
SELECTIVE_REPS = 20
# y of the fused kernel against its plain version: max abs error per unit
# of the largest |y|, overall and in every (b, s) row over d_inner.  The
# states are bit for bit the same; the 16-term sum over n is a chain of
# fused multiply-adds in the kernel and cuBLAS's order in the plain
# version, a few fp32 ulps (1.2e-7 each) of the row's largest term
SELECTIVE_Y_TOL = 1e-6
# tokens of every serve path's profiled run (the prefill and one decode
# step; 4 before PR 25): the profiler's cost grows with the eager ops of
# each decode step (~3,000 a step over Falcon-Mamba's 64 layers: ~85 s
# for 32 steps; phi4-mini's 32 took 65 s); the kernels' shares of the
# prefill need none of them
SERVE_PROFILE_GEN = 2
# serve_path_rgemma's architecture (RG-LRU + local MQA hybrid, head dim
# 256), its flash_vs_plain cases and K2 at its prefill's RG-LRU scan:
# (B, S, lru_width) = (8, 2016, 4096)
RGEMMA_ARCH, RGEMMA_CASE = "recurrentgemma-9b", "rgemma_layer0"
RGEMMA_WINDOW_CASE = "rgemma_window_binds"
RGEMMA_SCAN_SHAPE = (SERVE_B, SERVE_PROMPT, 4096)
RGEMMA_SCAN_REPS = 20
# serve_path_deepseek's architecture (MLA + MoE: no kernel), and
# serve_path_kimi's (GQA + MoE at head dim 112) with its depth cut: 61
# layers are 2.05 TB in bf16, 2 (1 dense + 1 MoE) 39.87 GB; 3 would be
# 74.0 GB, no room left for activations on an 80 GB card
DEEPSEEK_ARCH = "deepseek-v2-lite-16b"
KIMI_ARCH, KIMI_CASE = "kimi-k2-1t-a32b", "kimi_layer0"
KIMI_CUT = {"n_layers": 2}
# serve_card_vs_cpu's Kimi-K2 case at full width (2 layers, 16 experts)
KIMI_FULL_CASE = "full_width_2_layers_16_experts"
# serve_card_vs_cpu's DeepSeek-V2-Lite case at full width (1 dense and 3
# MoE layers), which also records its routing flips
DEEPSEEK_FULL_CASE = "full_width_4_layers"
# serve_path_whisper's architecture at full size: 32 clips of 1536 stub
# frames (30 s at 50 Hz, padded as the config pads them), the 4-token
# start-of-transcript prompt, 124 greedy tokens (max_len 128, inside the
# 448-token decode horizon); its flash_vs_plain case is the served
# model's layer-0 encoder q/k/v, non-causal
WHISPER_ARCH, WHISPER_CASE = "whisper-small", "whisper_enc_layer0"
# serve_path_qwen2vl's architecture at full width, its depth cut 80 -> 30
# layers (28.8e9 parameters, 57.6 GB in bf16); the serve shape is the
# other paths' (1024 patch embeddings of a 32 x 32 image + 992 text
# tokens); its flash_vs_plain case is the served model's layer-0 q/k/v
# rotated by M-RoPE, causal
QWEN2VL_ARCH, QWEN2VL_CASE = "qwen2-vl-72b", "qwen2vl_layer0"
QWEN2VL_CUT = {"n_layers": 30}
# (batch, prompt tokens, generated tokens) of an architecture's serve
# path where it is not (SERVE_B, SERVE_PROMPT, SERVE_GEN)
SERVE_SHAPES = {WHISPER_ARCH: (32, 4, 124)}
# serve_card_vs_cpu's Qwen2-VL case at full width: 1 layer, the 1024-patch
# prefix and 32 text tokens
QWEN2VL_FULL_CASE, QWEN2VL_FULL_PROMPT = "full_width_1_layer", 1024 + 32
# serve_card_vs_cpu scales Whisper's attention wq and wk by this (both
# sides get the same weights).  As drawn (the JAX spec's fan_in of a (d,
# heads, hd) projection is its head count), q and k entries have a
# standard deviation of ~8 and scores of ~64: over 1536 frames and 24
# layers some rows are near-tied, and fp32 rounding flips their winner
# (at full size the card's logits then lie O(1) per unit from the
# CPU's).  Cooled, the scores are O(1), as a trained model's are
WHISPER_COOL = 0.125
# serve_path_deepseek / _kimi: interleaved pairs of serve runs of
# MOE_DECODE_GEN tokens whose decode is forced onto each of the MoE
# layer's two expert products (1 pair; 2 before the MoE, audio and VLM
# training came, for the script's 1000 s)
MOE_DECODE_PAIRS, MOE_DECODE_GEN = 1, 16
MOE_DECODE_PAIRS_WERE = 2
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
# every head dim K3 takes, each held at its edges
FLASH_HEAD_DIMS = (32, 64, 112, 128, 256)
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
    # RecurrentGemma-9B's local attention (16 heads over 1 KV head, head
    # dim 256, window 2048): the hd-256 instances serve_path_rgemma (bf16)
    # and serve_card_vs_cpu (fp32) launch; at 2016 keys the window does
    # not bind, at 4096 it does and the window's tile skip runs
    (RGEMMA_CASE, SERVE_B, SERVE_PROMPT, SERVE_PROMPT, 1, 16, 256, True,
     2048),
    (RGEMMA_WINDOW_CASE, 1, 4096, 4096, 1, 16, 256, True, 2048),
    # Kimi-K2's prefill attention (64 heads over 8 KV heads, head dim
    # 112): the hd-112 instances serve_path_kimi (bf16) and
    # serve_card_vs_cpu (fp32) launch; then at its head layout a window
    # that binds and non-causal
    (KIMI_CASE, SERVE_B, SERVE_PROMPT, SERVE_PROMPT, 8, 8, 112, True, 0),
    ("kimi_window_binds", 1, 512, 512, 8, 8, 112, True, 128),
    ("kimi_noncausal", 1, 256, 256, 8, 8, 112, False, 0),
] + [case for hd in FLASH_HEAD_DIMS for case in (
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
# the architectures whose reduced config serve_card_vs_cpu also runs:
# RecurrentGemma's (its 64-slot local ring wraps in the 4 forced steps),
# DeepSeek's (the baseline of its full-width gap, ROADMAP.md §3) and
# Kimi's at head dim 112.  TinyLlama's, Falcon-Mamba's, Whisper's and
# Qwen2-VL's reduced cases, which their full-width cases cover, were left
# out for the script's 1000 s when the MoE, audio and VLM training came
SERVE_CMP_REDUCED = (RGEMMA_ARCH, DEEPSEEK_ARCH)
# the MoE cases' batch: the prefill's 512 tokens take the gathered expert
# products and each decode step's 8 every expert at once (moe._dispatch)
MOE_FORCED_B = 8


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
        # SDPA is the same function wherever the window does not bind
        # (every query sees at most Skv <= window keys)
        lib = lambda: sdpa(qs, ks, vs, is_causal=causal,  # noqa: E731
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
                    f"(enable_gqa, is_causal={causal})",
            library_same_function=window == 0 or k.shape[1] <= window,
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
    layer-0 q/k/v (both timed), phi4-mini's, RecurrentGemma's and
    Kimi-K2's prefill attention (the latter two timed in both types;
    RecurrentGemma's again at 4096 keys, where its 2048 window binds;
    Kimi's head layout with a window that binds and non-causal), and at
    every head dim ragged lengths, a
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
                causal, window, True,
                timed=name in ("main", RGEMMA_CASE, KIMI_CASE)
                or (name == PHI4_CASE and dtype == torch.bfloat16))
            del q, k, v
        q, k, v = (t.to(dtype) for t in layer0_qkv)
        out[("main_model", dtype)] = _flash_case(
            "main_model_qkv", q, k, v, _arange_pos(SERVE_B, SERVE_PROMPT),
            _arange_pos(SERVE_B, SERVE_PROMPT), True, 0, True, timed=True)
        del q, k, v
        for hd in FLASH_HEAD_DIMS:
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


def _serve_shape(cfg):
    """(batch, prompt tokens, generated tokens) of ``cfg``'s serve path."""
    return SERVE_SHAPES.get(cfg.name, (SERVE_B, SERVE_PROMPT, SERVE_GEN))


def _serve_setup(dtype=torch.float32, arch: str = SERVE_ARCH, cut=None):
    """``arch`` (TinyLlama-1.1B) at full width and depth (the fields of
    ``cut`` replaced), random weights from seed 0 on the card in
    ``dtype``, and the serve batch: the prompt tokens and the family's
    stub embeddings (Whisper's frames, Qwen2-VL's patches) in ``dtype``,
    drawn with numpy from seed 0."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, make_batch

    cfg = dataclasses.replace(get_arch(arch), **(cut or {}))
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0),
                        device=DEV, dtype=dtype)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, prompt, _ = _serve_shape(cfg)
    # an older checkout's make_batch draws no stub and takes no dtype
    kw = {"dtype": dtype} if cfg.family in ("audio", "vlm") else {}
    batch = make_batch(cfg, B, prompt, seed=0, device=DEV, **kw)
    del batch["labels"]
    return cfg, model, params, batch, init_s


def _layer0_qkv(cfg, params, batch):
    """Layer 0's rotated q (B, S, KV, G, hd), k and v for the prompt: the
    MoE family's first dense layer, Qwen2-VL's first layer over the patch
    prefix and the text rotated by M-RoPE, Whisper's first encoder layer
    over the frames (no RoPE: S is the frames)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import layer

    with torch.no_grad():
        mrope_pos = None
        if cfg.family == "audio":
            x = batch["frames"]
            x = x + tf._sinusoidal(x.shape[1], cfg.d_model, x.dtype, DEV)
            p = layer(params["enc_blocks"], 0)
        else:
            if cfg.family == "vlm":
                x, _, mrope_pos = tf._embed_inputs(params, cfg, batch)
            else:
                x = L.embed(params["embed"], batch["tokens"])
            p = layer(params["blocks" if "blocks" in params else
                             "dense_blocks"], 0)
        B, S = x.shape[:2]
        h = L.apply_norm(cfg.norm, p["ln1"], x)
        q, k, v = attn._project_qkv(p["attn"], h, cfg)
        if cfg.family != "audio":
            pos = _arange_pos(B, S)
            q, k = attn._apply_rope(cfg, q, k, pos, pos, mrope_pos)
    KV = cfg.n_kv_heads
    return (q.reshape(B, S, KV, cfg.n_heads // KV, cfg.head_dim).contiguous(),
            k.contiguous(), v.contiguous())


def _serve_once(model, params, batch, gen: int = SERVE_GEN):
    """serve() on the batch's tokens, its stub embeddings as ``stubs``
    (an older checkout's serve takes none)."""
    from repro_torch.launch.serve import serve

    stubs = {k: t for k, t in batch.items() if k != "tokens"}
    with torch.no_grad():
        return serve(model, params, batch["tokens"], gen, temperature=0.0,
                     device=DEV, **({"stubs": stubs} if stubs else {}))


def _expected_launches(cfg):
    """(K3, K2, fused selective scan) launches of one prefill: a layer's
    attention runs K3, an RG-LRU layer's recurrence K2 and a Mamba
    layer's the fused selective scan (JAX's _fused_chunk_scan, K2's
    redesign on that path); the hybrid's 3 n_super + rem layers are
    n_super attention layers and 2 n_super + rem RG-LRU ones; Whisper
    runs K3 in each encoder and each decoder layer; MLA runs none."""
    if cfg.use_mla:
        return 0, 0, 0
    if cfg.family == "audio":
        return cfg.encoder_layers + cfg.n_layers, 0, 0
    if cfg.family == "hybrid":
        n_super, rem = divmod(cfg.n_layers, 3)
        return n_super, 2 * n_super + rem, 0
    return (0, 0, cfg.n_layers) if cfg.family == "ssm" else (cfg.n_layers,
                                                            0, 0)


def phase_serve_path(cfg, model, params, batch, init_s: float,
                     dtype=torch.float32, sfx=None, cut=None):
    """serve() at full width and depth in the weights' ``dtype`` on
    ``batch`` (tokens and stubs) of the architecture's serve shape: the
    family's kernels (K3 for a dense model, the fused selective scan for
    the SSM, K2 and K3 for the hybrid) once per layer of the prefill, no
    kernel in decode; the rates
    of SERVE_REPEATS runs after a warm-up of SERVE_WARMUP_GEN tokens;
    then one profiled run of SERVE_PROFILE_GEN tokens.  Phases ``serve_path``,
    ``serve_path_spread``, ``serve_profile`` (fp32) or the same names
    with the suffix ``sfx`` (default ``_bf16`` for bf16 weights).
    Returns the (K3, K2, fused selective scan) launches of one run."""
    from repro_torch.common.pytree import tree_leaves

    from repro_torch.configs import get_arch

    if sfx is None:
        sfx = "" if dtype == torch.float32 else "_bf16"
    fam = cfg.family
    full = get_arch(cfg.name)
    B, prompt, n_gen = _serve_shape(cfg)
    want = _expected_launches(cfg)  # in the prefill
    _serve_once(model, params, batch, SERVE_WARMUP_GEN)  # warm-up
    runs = []
    for _ in range(SERVE_REPEATS):
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        gen, stats = _serve_once(model, params, batch, n_gen)
        k1, k2 = _launches()
        k1 += _fold_launches() + _scan_backward_launches()
        k3, ss = _flash_launches(), _selective_launches()
        # an older checkout's serve() counts no K2 and no fused scan
        # (--only A/B)
        got = (stats["k3_launches"], stats.get("k2_launches", 0),
               stats.get("selective_scan_launches", 0))
        decode = (stats["k3_decode_launches"],
                  stats.get("k2_decode_launches", 0),
                  stats.get("selective_scan_decode_launches", 0))
        if not ((k3, k2, ss) == want == got and decode == (0, 0, 0)
                and k1 == 0):
            raise AssertionError(
                f"serve path{sfx}: (K3, K2, fused selective scan) launches "
                f"{(k3, k2, ss)}, {got} in the prefill and {decode} in "
                f"decode; expected {want} and (0, 0, 0); K1, feature_fold "
                f"and K2 backward {k1}")
        if not stats["finite_logits"] or tuple(gen.shape) != (B, n_gen + 1):
            raise AssertionError(f"serve path{sfx}: non-finite logits or "
                                 f"tokens of shape {tuple(gen.shape)}")
        shape = ({"d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state}
                 if fam == "ssm" else {"n_heads": cfg.n_heads,
                                       "n_kv_heads": cfg.n_kv_heads,
                                       "head_dim": cfg.head_dim})
        if fam == "hybrid":
            shape.update(lru_width=cfg.lru_width,
                         local_window=cfg.local_window)
        if fam == "moe":
            shape.update(n_experts=cfg.n_experts, top_k=cfg.top_k,
                         n_shared_experts=cfg.n_shared_experts,
                         d_ff_expert=cfg.d_ff_expert, d_ff=cfg.d_ff,
                         first_dense_layers=cfg.first_dense_layers,
                         use_mla=cfg.use_mla)
            if cfg.use_mla:
                shape.update(kv_lora_rank=cfg.kv_lora_rank,
                             qk_nope_head_dim=cfg.qk_nope_head_dim,
                             qk_rope_head_dim=cfg.qk_rope_head_dim,
                             v_head_dim=cfg.v_head_dim)
        if fam == "vlm":
            shape.update(d_ff=cfg.d_ff, n_patches=cfg.n_patches,
                         mrope_sections=list(cfg.mrope_sections))
        if fam == "audio":
            shape.update(d_ff=cfg.d_ff, encoder_layers=cfg.encoder_layers,
                         encoder_frames=cfg.encoder_frames,
                         max_decode_len=cfg.max_decode_len,
                         prefill_frames_per_s=B * cfg.encoder_frames
                         / stats["prefill_s"])
        # {field: [the config's value or the script's former setting,
        # the value run]}
        shape["reduced"] = {**{k: [getattr(full, k), v]
                               for k, v in (cut or {}).items()},
                            "timed_runs": [2, SERVE_REPEATS],
                            "warmup_gen": [n_gen, SERVE_WARMUP_GEN],
                            "profiled_gen": [4, SERVE_PROFILE_GEN]}
        rec = {"phase": "serve_path" + sfx, "arch": cfg.name,
               "n_layers": cfg.n_layers, "d_model": cfg.d_model, **shape,
               "batch": B, "prompt_len": prompt,
               "gen": n_gen, "max_len": prompt + n_gen,
               "temperature": 0.0, "dtype": str(dtype).split(".")[-1],
               **stats,
               "prefill_tokens_per_s": B * prompt / stats["prefill_s"],
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "weight_bytes": sum(t.numel() * t.element_size()
                                   for t in tree_leaves(params)),
               "flash_attention_launches": k3, "linear_scan_launches": k2,
               "selective_scan_launches": ss,
               "linear_scan_backward_launches": _scan_backward_launches(),
               "init_s": init_s,
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
    if fam == "moe":
        _moe_decode_products(cfg, model, params, batch["tokens"], sfx)
    gen = SERVE_PROFILE_GEN
    (_, stats), wall, per = _device_profile(
        lambda: _serve_once(model, params, batch, gen))
    rec = {"phase": "serve_profile" + sfx, "arch": cfg.name, "gen": gen,
           "wall_s": wall, "prefill_s": stats["prefill_s"],
           "decode_s": stats["decode_s"],
           **_profile_record(per, wall, ("fa_fwd_f32", "fa_fwd_bf16",
                                         "linear_scan_channels",
                                         "selective_scan_fwd"))}
    # the kernels run only in the prefill: their shares of its time
    for name, kern, n in (("k2", "linear_scan_channels", want[1]),
                          ("k3", "fa_fwd", want[0]),
                          ("selective_scan", "selective_scan_fwd", want[2])):
        if n and fam != "dense":
            ms = sum(t for k, t, _ in per if kern in k)
            rec.update({f"{name}_ms": ms, f"{name}_share_of_prefill":
                        ms / 1e3 / stats["prefill_s"]})
    emit(rec)
    return (runs[-1]["flash_attention_launches"],
            runs[-1]["linear_scan_launches"],
            runs[-1]["selective_scan_launches"])


def _moe_decode_products(cfg, model, params, tokens, sfx: str):
    """The measurement behind ``moe._dispatch``'s rule in decode: serve
    runs of MOE_DECODE_GEN tokens whose decode steps (B tokens a MoE
    call) are forced onto the gathered rows (one host read of the counts
    a MoE layer, only the routed experts' weights) and onto every expert
    at once (no host read, every expert's weights), MOE_DECODE_PAIRS
    times interleaved, at batch B and 2 B; the prefill keeps the rule's
    choice.  One phase ``serve_path{sfx}_moe_decode`` a batch."""
    from repro_torch.models import make_batch, moe

    pick = moe._dispatch
    forced = {"gathered": moe._gathered, "all_experts": moe._all_experts}
    for batch in (SERVE_B, 2 * SERVE_B):
        toks = tokens if batch == SERVE_B else make_batch(
            cfg, batch, SERVE_PROMPT, seed=0, device=DEV)["tokens"]
        runs = {name: [] for name in forced}
        try:
            for _ in range(MOE_DECODE_PAIRS):
                for name, fn in forced.items():
                    moe._dispatch = (lambda n, _f=fn, _b=batch:
                                     _f if n == _b else pick(n))
                    _, stats = _serve_once(model, params, {"tokens": toks},
                                           MOE_DECODE_GEN)
                    if not stats["finite_logits"]:
                        raise AssertionError(
                            f"serve path{sfx}: non-finite logits, batch "
                            f"{batch}, decode on {name}")
                    runs[name].append(stats["tokens_per_s"])
        finally:
            moe._dispatch = pick
        rec = {"phase": f"serve_path{sfx}_moe_decode", "arch": cfg.name,
               "batch": batch, "gen": MOE_DECODE_GEN,
               "reduced": {"pairs": [MOE_DECODE_PAIRS_WERE,
                                     MOE_DECODE_PAIRS]},
               "rule_picks": pick(batch).__name__,
               "assignments": batch * cfg.top_k,
               "n_experts": cfg.n_experts}
        for name, vals in runs.items():
            rec.update({f"{name}_tokens_per_s": vals,
                        f"{name}_tokens_per_s_median":
                        float(np.median(vals))})
        emit(rec)
        del toks
        torch.cuda.empty_cache()


def _cache_leaves(cache, prefix: str = "") -> dict:
    """{path: tensor on the CPU} of a nested cache: ``kv/k`` (dense),
    ``state/h`` (ssm), ``super/r1/h``, ``super/a/k``, ``tail/conv``
    (hybrid) ..."""
    out = {}
    for name, t in cache.items():
        path = f"{prefix}{name}"
        if isinstance(t, dict):
            out.update(_cache_leaves(t, path + "/"))
        else:
            out[path] = t.cpu()
    return out


def _teacher_forced(model, params, batch, device: str,
                    prompt: int = FORCED_PROMPT):
    """Prefill the first ``prompt`` tokens (with the batch's stub
    embeddings), then FORCED_STEPS decode steps fed the next tokens:
    ([logits per step], {path: cache leaf}) on the CPU (the KV cache of a
    dense model, the recurrent state of the SSM, the hybrid's RG-LRU
    states and local-attention rings, Whisper's self and cross K/V)."""
    batch = {k: t.to(device) for k, t in batch.items()}
    tokens = batch["tokens"]
    B = tokens.shape[0]
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {**batch, "tokens": tokens[:, :prompt]},
            max_len=prompt + FORCED_STEPS)
        out = [logits.cpu()]
        for i in range(FORCED_STEPS):
            idx = torch.full((B,), prompt + i, dtype=torch.int32,
                             device=device)
            logits, cache = model.decode_step(
                params, cache, tokens[:, prompt + i:prompt + i + 1], idx)
            out.append(logits.cpu())
    return out, _cache_leaves(cache)


def phase_serve_card_vs_cpu(archs=None):
    """The port on the card against the port on the CPU, for TinyLlama,
    Falcon-Mamba, RecurrentGemma, DeepSeek-V2-Lite, Kimi-K2, Whisper and
    Qwen2-VL in fp32 (those named in ``archs``, or all):
    prefill logits, every teacher-forced decode step's logits and every
    cache leaf (K/V and their positions, MLA's latent, the SSM's and the
    RG-LRU's h and conv window), at full width with the depth cut (2
    layers; 4 for RecurrentGemma, one superblock and one tail layer: at
    2 its ``divmod`` gives no superblock and no attention; 4 for
    DeepSeek, 1 dense and 3 MoE layers; Kimi at 2 with its experts cut to
    16; Whisper at full size; Qwen2-VL at full width with 1 layer and a
    prompt of its 1024 patches and 32 text tokens), and on the reduced
    config of SERVE_CMP_REDUCED's architectures (RecurrentGemma's local
    window of 64, which the 4 forced steps after the 64-token prompt wrap
    on the card) and Kimi's at head dim 112.  A batch
    of 2, and MOE_FORCED_B for the MoE cases so both expert products meet
    the CPU; the stub frames and patches are drawn with the tokens, and
    Whisper's attention wq and wk are scaled by WHISPER_COOL.  The
    card's prefill launches the family's kernels once a layer.  Returns
    {(arch, case): (K3, K2, fused selective scan) launches}."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, make_batch, moe

    cases = []
    for arch, depth in ((SERVE_ARCH, 2), (MAMBA_ARCH, 2), (RGEMMA_ARCH, 4),
                        (DEEPSEEK_ARCH, 4)):
        full = get_arch(arch)
        cases += [(f"full_width_{depth}_layers",
                   dataclasses.replace(full, n_layers=depth))]
        if arch in SERVE_CMP_REDUCED:
            cases += [("reduced", full.reduced())]
    # Kimi-K2 at its own head dim 112 (K3's fp32 hd-112 build on the
    # card): reduced() recomputes head_dim = d_model / n_heads = 64, so
    # it is set back; and at full width with 2 layers and the experts
    # cut to 16 (top-8 of 16: 14.4 GB in fp32 on each side)
    kimi = get_arch(KIMI_ARCH)
    cases += [("reduced_hd112", dataclasses.replace(kimi.reduced(),
                                                    head_dim=112)),
              (KIMI_FULL_CASE, dataclasses.replace(kimi, n_layers=2,
                                                   n_experts=16))]
    cases += [("full_size", get_arch(WHISPER_ARCH)),
              (QWEN2VL_FULL_CASE, dataclasses.replace(get_arch(QWEN2VL_ARCH),
                                                      n_layers=1))]
    emit({"phase": "serve_card_vs_cpu", "reduced": {
        "reduced_cases_left_out": [SERVE_ARCH, MAMBA_ARCH, WHISPER_ARCH,
                                   QWEN2VL_ARCH],
        "why": "each covered by its full-width case; the script's 1000 s"}})
    launches = {}
    for tag, cfg in cases:
        if archs and cfg.name not in archs:
            continue
        model = build_model(cfg)
        params = model.init(torch.Generator(device=DEV).manual_seed(0),
                            device=DEV)
        if cfg.family == "audio":
            for blocks, names in (("enc_blocks", ("attn",)),
                                  ("dec_blocks", ("self", "cross"))):
                for name in names:
                    for leaf in ("wq", "wk"):
                        params[blocks][name][leaf].mul_(WHISPER_COOL)
        params_cpu = tree_map(lambda t: t.cpu(), params)
        batch = MOE_FORCED_B if cfg.family == "moe" else 2
        if cfg.family == "moe" and (
                moe._dispatch(batch * FORCED_PROMPT),
                moe._dispatch(batch)) != (moe._gathered, moe._all_experts):
            raise AssertionError("serve card vs cpu: the MoE cases would "
                                 "not compare both expert products")
        prompt = (QWEN2VL_FULL_PROMPT if tag == QWEN2VL_FULL_CASE
                  else FORCED_PROMPT)
        inputs = make_batch(cfg, batch, prompt + FORCED_STEPS, seed=1,
                            device="cpu")
        del inputs["labels"]
        _reset_launches()
        with Routing() as card_routes:
            got, cache_gpu = _teacher_forced(model, params, inputs, DEV,
                                             prompt)
        k3, k2, ss = _flash_launches(), _launches()[1], _selective_launches()
        want, cache_cpu = _teacher_forced(model, params_cpu, inputs, "cpu",
                                          prompt)
        expect = _expected_launches(cfg)
        if (k3, k2, ss) != expect:
            raise AssertionError(
                f"{cfg.name} {tag}: (K3, K2, fused selective scan) launches "
                f"{(k3, k2, ss)} in the card's prefill and decode, expected "
                f"{expect}")
        launches[(cfg.name, tag)] = (k3, k2, ss)
        errs, cache_errs, pos_equal = _serve_gaps(got, cache_gpu, want,
                                                  cache_cpu)
        for step, (g, rel) in enumerate(zip(got, errs)):
            if not (torch.isfinite(g).all() and rel <= SERVE_TOL):
                raise AssertionError(
                    f"serve card vs CPU ({cfg.name} {tag}): logits of step "
                    f"{step} differ by {rel} per unit of max |logits| "
                    f"(tolerance {SERVE_TOL})")
        if max(cache_errs.values()) > SERVE_TOL or not pos_equal:
            raise AssertionError(
                f"serve card vs CPU ({cfg.name} {tag}): cache differs: "
                f"{cache_errs}, pos equal: {pos_equal}")
        forced = {}
        if (cfg.name, tag) == (DEEPSEEK_ARCH, DEEPSEEK_FULL_CASE):
            # the gap again with the CPU taking the card's expert ids: what
            # of it the routing flips account for (recorded, not gated)
            with Routing(card_routes.ids) as route:
                want, cache_cpu = _teacher_forced(
                    model, params_cpu, inputs, "cpu", prompt)
            f_errs, f_cache, _ = _serve_gaps(got, cache_gpu, want, cache_cpu)
            forced = {"routing_forced": {
                "route_flips_by_layer": _flips_by_layer(route.flips,
                                                        _moe_layers(cfg)),
                "route_flips_by_call": route.flips,
                "tokens_a_call": [batch * prompt] + [batch] * FORCED_STEPS,
                "logits_rel_err_per_step": f_errs,
                "cache_rel_err": f_cache}}
        if (cfg.name, tag) == (DEEPSEEK_ARCH, DEEPSEEK_FULL_CASE):
            # as drawn, and with MLA's wq and w_uk cooled as the
            # training phases cool them (the same weights on both sides)
            for cool in (False, True):
                _bisect_moe_prefill(
                    cfg, *(_cool_attention(p) if cool else p
                           for p in (params, params_cpu)),
                    inputs["tokens"][:, :prompt], cool)
        if (cfg.name, tag) == (RGEMMA_ARCH, "full_width_4_layers"):
            for cool in (False, True):  # as drawn, and attention cooled
                _bisect_hybrid_decode(
                    model, cfg, *(_cool_attention(p) if cool else p
                                  for p in (params, params_cpu)),
                    inputs, prompt, cool)
        emit({"phase": "serve_card_vs_cpu", "case": tag, "arch": cfg.name,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "head_dim": cfg.head_dim, "batch": batch,
              "prompt_len": prompt, "forced_steps": FORCED_STEPS,
              "logits_rel_err_per_step": errs,
              "cache_rel_err": cache_errs, "pos_equal": pos_equal,
              "tolerance": SERVE_TOL, "flash_attention_launches": k3,
              "attention_wq_wk_scale": (WHISPER_COOL if cfg.family == "audio"
                                        else 1.0),
              "linear_scan_launches": k2, "selective_scan_launches": ss,
              **forced})
        del params, params_cpu
        torch.cuda.empty_cache()
    return launches


def _gap(card, cpu) -> float:
    """max |card - cpu| per unit of the CPU's largest magnitude."""
    cpu = cpu.to(torch.float32)
    return float((card.cpu().to(torch.float32) - cpu).abs().max()) \
        / max(float(cpu.abs().max()), 1e-30)


def _op_gaps(ops, x_card, x_cpu):
    """Card against CPU, op by op: ``ops`` is [(name, fn(device, x) ->
    y)], a chain, where x and y are a tensor or a tuple (the residual
    stream, the op's output) whose last tensor is compared.  For each op,
    its own gap (the card's op on the CPU's input against the CPU's op)
    and the carried gap (the card's chain against the CPU's chain).
    Returns ({name: {"own": .., "carried": ..}}, the card's chain's
    output, {name: the CPU's output})."""
    def last(y):
        return y[-1] if isinstance(y, tuple) else y

    gaps, cpu_out = {}, {}
    for name, fn in ops:
        y_cpu = fn("cpu", x_cpu)
        mine = fn(DEV, tuple(t.to(DEV) for t in x_cpu)
                  if isinstance(x_cpu, tuple) else x_cpu.to(DEV))
        x_card = fn(DEV, x_card)
        gaps[name] = {"own": _gap(last(mine), last(y_cpu)),
                      "carried": _gap(last(x_card), last(y_cpu))}
        x_cpu = cpu_out[name] = y_cpu
    return gaps, x_card, cpu_out


def _bisect_moe_prefill(cfg, params, params_cpu, tokens, cooled: bool):
    """ROADMAP.md §3's bisection of DeepSeek-V2-Lite's card-vs-CPU gap at
    full width: its prefill layer by layer and op by op (the norms, MLA,
    the router's logits, the top-k routing, the gathered expert products
    on the CPU's expert ids, the ordered fp32 combine, the shared experts,
    the residual adds), each op's own gap (the card's op on the CPU's
    input) and the carried gap (the card's run against the CPU's), per
    unit of the CPU's largest value; the routing's flips counted.
    ``cooled``: the weights' MLA wq and w_uk are scaled by TRAIN_COOL
    (recorded).  Recorded, not gated (the case's 5e-3 gate stays on the
    logits)."""
    from repro_torch.models import layers as L, moe
    from repro_torch.models.transformer import attend, moe_ffn, moe_layers

    pc = {DEV: params, "cpu": params_cpu}
    layers = {d: moe_layers(p, cfg) for d, p in pc.items()}
    x_cpu = L.embed(params_cpu["embed"], tokens)
    x_card = x_cpu.to(DEV)
    k = cfg.top_k
    rows = []
    with torch.no_grad():
        for i, (kind, _) in enumerate(layers["cpu"]):
            lp = {d: layers[d][i][1] for d in pc}

            def norm(name, lp=lp):
                return lambda dev, x: (x, L.apply_norm(
                    cfg.norm, lp[dev][name], x))

            ops = [("ln1", norm("ln1")),
                   ("attn", lambda dev, xh, lp=lp: (xh[0], attend(
                       lp[dev]["attn"], xh[1], cfg))),
                   ("residual1", lambda dev, xa: xa[0] + xa[1]),
                   ("ln2", norm("ln2"))]
            if kind == "dense":
                ops += [("mlp", lambda dev, xh, lp=lp: (xh[0], L.mlp(
                    lp[dev]["mlp"], xh[1], cfg.act)))]
            else:
                ops += [("moe_ffn", lambda dev, xh, lp=lp: (xh[0], moe_ffn(
                    lp[dev], xh[1], cfg)[0]))]
            ops += [("residual2", lambda dev, xy: xy[0] + xy[1])]
            gaps, x_card, cpu_out = _op_gaps(ops, x_card, x_cpu)
            rec = {"layer": i, "kind": kind, "ops": gaps}
            if kind == "moe":
                # the MoE layer's parts on the CPU's normed input
                xt_cpu = cpu_out["ln2"][1].reshape(-1, cfg.d_model)
                xt_card = xt_cpu.to(DEV)
                part = {}
                m_cpu, m_card = lp["cpu"]["moe"], lp[DEV]["moe"]
                lg_cpu = (xt_cpu @ m_cpu["router"]).to(torch.float32)
                part["router_logits"] = _gap(
                    (xt_card @ m_card["router"]).to(torch.float32), lg_cpu)
                g_cpu, ids_cpu, _ = moe._route(m_cpu["router"], xt_cpu, k)
                g_card, ids_card, _ = moe._route(m_card["router"], xt_card, k)
                flips = int((torch.sort(ids_card.cpu(), -1)[0] != torch.sort(
                    ids_cpu, -1)[0]).any(-1).sum())
                part["gates"] = _gap(g_card, g_cpu)
                ids_s, perm = torch.sort(ids_cpu, dim=-1)
                gs = torch.gather(g_cpu, 1, perm)
                ye_cpu = moe._gathered(m_cpu, xt_cpu, ids_s)
                ye_card = moe._gathered(m_card, xt_card, ids_s.to(DEV))
                part["experts_gathered"] = _gap(ye_card, ye_cpu)

                def combine(gates, ye):
                    y = gates[:, 0, None] * ye[:, 0].to(torch.float32)
                    for j in range(1, k):
                        y = y + gates[:, j, None] * ye[:, j].to(torch.float32)
                    return y

                part["combine"] = _gap(combine(gs.to(DEV), ye_cpu.to(DEV)),
                                       combine(gs, ye_cpu))
                part["shared"] = _gap(
                    L.mlp(lp[DEV]["shared"], xt_card, cfg.act),
                    L.mlp(lp["cpu"]["shared"], xt_cpu, cfg.act))
                rec.update(parts_own=part, route_flips=flips,
                           tokens=xt_cpu.shape[0])
            rows.append(rec)
            x_cpu = cpu_out["residual2"]
    emit({"phase": "serve_gap_bisect", "arch": cfg.name,
          "n_layers": cfg.n_layers, "tokens": list(tokens.shape),
          "attention_wq_w_uk_scale": TRAIN_COOL if cooled else 1.0,
          "per_unit_of": "the CPU's largest value of each op's output",
          "layers": rows})


def _bisect_hybrid_decode(model, cfg, params, params_cpu, inputs, prompt,
                          cooled: bool):
    """ROADMAP.md §3's check of RecurrentGemma's card-vs-CPU gap at full
    width, 4 layers: the prefill and forced decode steps 0 and 1 on each
    device, every mixer call recorded (the three RG-LRU layers'
    ``rglru_decode`` and the local attention's ``gqa_decode``, their
    inputs and outputs); for each, the carried gap of its input and its
    output (card run against CPU run) and its own gap (the card's mixer on
    the CPU's input, state and cache); then the tail's RG-LRU op by op at
    each step (the x projection, the gelu gate, the conv with the carried
    window, the recurrence gate ``a`` and input ``b``, the new state).
    ``cooled``: the weights' attention wq and wk are scaled by TRAIN_COOL
    (recorded).  Per unit of the CPU's largest value; recorded, not
    gated."""
    from repro_torch.models import attention as attn, rglru as R
    from repro_torch.models.scan_utils import linear_scan_step
    from repro_torch.models.ssm import _causal_conv

    seen = {"card": [], "cpu": []}
    run = ["card"]  # which device's run the spies record
    inner = {"rglru": R.rglru_decode, "attn": attn.gqa_decode}

    def clone(t):
        return ({k: clone(v) for k, v in t.items()} if isinstance(t, dict)
                else t.clone())

    def spy(kind):
        def call(p, x, state, *args, **kw):
            seen[run[0]].append((kind, p, x.clone(), clone(state), args,
                                 kw))
            out = inner[kind](p, x, state, *args, **kw)
            seen[run[0]][-1] += (out[0].clone(),)
            return out
        return call

    tokens = inputs["tokens"]
    B = tokens.shape[0]
    R.rglru_decode, attn.gqa_decode = spy("rglru"), spy("attn")
    try:
        with torch.no_grad():
            for run[0], dev, p in (("card", DEV, params),
                                   ("cpu", "cpu", params_cpu)):
                t = tokens.to(dev)
                _, cache = model.prefill(p, {"tokens": t[:, :prompt]},
                                         max_len=prompt + FORCED_STEPS)
                for i in range(2):
                    idx = torch.full((B,), prompt + i, dtype=torch.int32,
                                     device=dev)
                    _, cache = model.decode_step(
                        p, cache, t[:, prompt + i:prompt + i + 1], idx)
    finally:
        R.rglru_decode, attn.gqa_decode = inner["rglru"], inner["attn"]
    calls = len(seen["cpu"]) // 2  # mixer calls a step
    steps_rec = []
    with torch.no_grad():
        for step in range(2):
            mixers = []
            for j in range(calls):
                kind, p_card, x_card, st_card, args, kw, y_card = \
                    seen["card"][step * calls + j]
                _, _, x_cpu, st_cpu, args_cpu, _, y_cpu = \
                    seen["cpu"][step * calls + j]
                mine = inner[kind](p_card, x_cpu.to(DEV), _to_card(st_cpu),
                                   *_to_card(args_cpu), **kw)[0]
                mixers.append({"layer": j, "kind": kind,
                               "input_carried": _gap(x_card, x_cpu),
                               "output_carried": _gap(y_card, y_cpu),
                               "output_own": _gap(mine, y_cpu)})
            # the tail: the step's last RG-LRU call
            _, p_card, x_card, st_card, _, _, _ = seen["card"][
                step * calls + calls - 1]
            _, p_cpu, x_cpu, st_cpu, _, _, _ = seen["cpu"][
                step * calls + calls - 1]

            def ops(p, x, state):
                xr = x @ p["w_x"]
                g = torch.nn.functional.gelu(
                    (x @ p["w_gate"]).to(torch.float32), approximate="tanh")
                xc = _causal_conv(xr, p["conv_w"], p["conv_b"],
                                  prev=state["conv"])
                a, b = R._gates(p, xc)
                h = linear_scan_step(a[:, 0], b[:, 0], state["h"])
                return {"x_proj": xr, "gelu_gate": g, "conv": xc, "a": a,
                        "b": b, "h_new": h}

            want = ops(p_cpu, x_cpu, st_cpu)
            own = ops(p_card, x_cpu.to(DEV), _to_card(st_cpu))
            carried = ops(p_card, x_card, st_card)
            steps_rec.append({
                "decode_step": step, "mixers": mixers,
                "tail_state_in_carried": {k: _gap(st_card[k], v)
                                          for k, v in st_cpu.items()},
                "tail_ops": {k: {"own": _gap(own[k], v),
                                 "carried": _gap(carried[k], v)}
                             for k, v in want.items()},
                "tail_a_range": [float(want["a"].min()),
                                 float(want["a"].max())]})
    emit({"phase": "serve_gap_bisect", "arch": cfg.name,
          "n_layers": cfg.n_layers, "mixer_calls_a_step": calls,
          "attention_wq_wk_scale": TRAIN_COOL if cooled else 1.0,
          "steps": steps_rec,
          "per_unit_of": "the CPU's largest value of each op's output"})


def _to_card(x):
    """Tensors (in dicts, tuples or lists) moved to the card."""
    if isinstance(x, torch.Tensor):
        return x.to(DEV)
    if isinstance(x, dict):
        return {k: _to_card(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_card(v) for v in x)
    return x


def _serve_gaps(got, cache_gpu, want, cache_cpu):
    """(each step's logits gap per unit of max |logits|, {cache leaf: its
    gap per unit}, the position leaves equal) of the card's teacher-forced
    run against the CPU's."""
    errs = [float((g - w).abs().max()) / float(w.abs().max())
            for g, w in zip(got, want)]
    cache_errs, pos_equal = {}, True
    for name, w in cache_cpu.items():
        if name.endswith("pos"):
            pos_equal = pos_equal and torch.equal(cache_gpu[name], w)
        else:
            cache_errs[name] = float((cache_gpu[name] - w).abs().max()) \
                / float(w.abs().max())
    return errs, cache_errs, pos_equal


# ---------------------------------------------------------------------------
# The training slice: ASO-Fed local steps and server folds on a transformer
# ---------------------------------------------------------------------------

# train_path: Qwen2-0.5B at full size (494M parameters, 1.98 GB in fp32),
# the defaults of repro_torch.launch.train: 4 clients, batch 8, seq 128,
# 40 steps, eta / lam / beta as its CLI
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_CLIENTS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 8, 128, 40
TRAIN_HYPER = {"eta": 3e-3, "lam": 0.1, "beta": 0.001}
# each client's token stream: the CLI's 200,000 tokens take ~2 minutes of
# host time at vocab 151936 (a Python loop a token); the batches' starts
# need only a stream longer than seq + 1
TRAIN_TOKENS = 20_000
# steps left out of the step-time median and p90 (cuBLAS, the allocator)
TRAIN_WARMUP = 2
# RecurrentGemma-9B's training scan at batch 8 x 128 (K2 forward and
# backward): (B, S, lru_width); launches a graph when timed.  (Falcon-Mamba
# trains through the fused selective scan: SELECTIVE_BWD_CASES)
RGEMMA_TRAIN_SCAN = (TRAIN_B, TRAIN_S, 4096)
SCAN_TRAIN_REPS = 20
# train_card_vs_cpu: Qwen2-0.5B at full width (vocab 151936: K1 at the
# embedding's real shape) with its depth cut to 2 layers; 3 clients,
# batch 2, seq 64, 2 steps (6 before the MoE, audio and VLM cases came:
# the script's 1000 s; two clients' steps, the second prox against its
# own snapshot of the server), the same weights and streams on both sides
TRAIN_CUT = {"n_layers": 2}
TRAIN_CMP = {"batch": 2, "seq": 64, "steps": 2}
TRAIN_CMP_CLIENTS, TRAIN_CMP_TOKENS = 3, 5_000
# every attention's wq and wk scaled by this in the training phases: as
# drawn, the JAX spec's fan_in of a (d, heads, hd) projection is its head
# count, Qwen2-0.5B's scores reach ~170 and its gradient at init grows
# with depth (the JAX package's, on the CPU: max |grad| 84 at 2 layers,
# 4.4e5 at 8, 9.8e11 at 24), so ASO-Fed's step diverges (the JAX
# package's own loop at 8 layers: loss 12.09 -> 8,915 at step 3) and
# near one-hot attention turns fp32 rounding into trajectory differences
# (tests/test_torch_train.py); cooled, max |grad| is 0.20-0.27 at every
# depth.  The leaves scaled are TRAIN_COOL_LEAVES.  MLA has no wk: its
# keys are the latent's up-projection by w_uk (fan_in the head count
# too) and the shared rotary key by w_kr (fan_in d_model, scores O(1) as
# drawn).  On an H100 (train_witness.py's "mla" reading,
# DeepSeek-V2-Lite at 2 layers) the layer-0 scores' spread is 52.5 as
# drawn, 6.57 with wq alone scaled and 1.15 with wq and w_uk (GQA's
# cooled scale); the first step's central difference over 1/8 of the
# step is 0.011, 0.906 and 1.0076 of its prediction, and the card's
# gradient lies 3.3e-4, 1.6e-5 and 2.4e-6 from the CPU's.  So MLA's w_uk
# is scaled with wq
TRAIN_COOL = 0.125
TRAIN_COOL_LEAVES = ("wq", "wk", "w_uk")
# train_path's gate on the update: client 0's first local step (the
# loop's own local_step, from the initial weights with fresh slots, u the
# update it applies) must lower the loss of its own batch, and over
# TRAIN_FO_FRAC of the step the central difference L(w + tu) - L(w - tu)
# must equal the gradient's prediction <g, w + tu> - <g, w - tu> within
# TRAIN_FO_TOL of it.  Over the whole step the loss is not linear enough
# at full size (the record's ratio_whole_step: the step's higher-order
# terms, which shrink with t).  A wrong gradient parts the two: on the
# CPU at Qwen2-0.5B's reduced width (tests/test_torch_train.py) a wrong
# RMSNorm gradient fails, and so do no update and an uphill one
TRAIN_FO_FRAC = 0.125
TRAIN_FO_TOL = 0.02
# the SSM-family paths' gated fraction.  From the seed-0 weights as drawn
# their first ASO-Fed step leaves the loss's linear range far behind: on
# an H100 (train_witness.py, ROADMAP.md §3) Falcon-Mamba-7B's central
# difference at 4 of 64 layers is ~0.13 of the prediction over 1/8 of
# the step and nears 1 as the fraction shrinks, the mark of curvature
# (RecurrentGemma-9B's with its attention cooled the same).  The gate
# stays TRAIN_FO_TOL.  It sees a wrong db of the scan (the Falcon-Mamba
# case of tests/test_torch_train.py's gate test) but not a wrong da,
# whose leaves move the loss along the step by ~1e-5 of its change:
# train_card_vs_cpu holds every gradient leaf for that
TRAIN_FO_FRAC_SSM = 1 / 2048
# the losses of the initial and final server weights, recorded (not
# gated), on one fixed batch a client drawn with seed TRAIN_EVAL_SEED + i
TRAIN_EVAL_SEED = 1000
# card vs CPU over the whole run: each step's loss and each final server
# leaf, max abs difference per unit of the CPU's largest magnitude (at
# least 1); the fp32 scaled bound (1e-6) compounded over 6 steps of
# gradient, update, fold and feature pass
TRAIN_TOL = 1e-4
# a gradient leaf against the CPU's: per unit of its largest magnitude,
# floored at this share of the largest over all leaves (a leaf whose true
# gradient is ~0 holds only rounding noise), as tests/test_torch_train.py
GRAD_FLOOR = 1e-3
# train_path_mamba: Falcon-Mamba-7B at full width (d 4096, d_inner 8192,
# N 16, vocab 65024, tied), depth 64 -> 4 (0.6876e9 parameters, 2.75 GB
# in fp32): the loop holds ~18.6x its weights (4 clients' fp32 slots,
# snapshots, gradients), and 6 layers would leave the card no margin; the
# training CLI's defaults
MAMBA_TRAIN_CUT = {"n_layers": 4}
# train_step_mamba_long: one gradient of Falcon-Mamba-7B at full width,
# train_path_mamba's 4 layers, at batch 8 x 2048 tokens: 8 of JAX's
# 256-step chunks, so the fused backward's carry between chunks is on the
# path; one warm-up gradient, then MAMBA_LONG_REPS timed
MAMBA_LONG_S = 2048
MAMBA_LONG_REPS = 2
# the fused backward against its plain version: (case, (B, S, d_inner, N),
# launches a graph when timed, 0 untimed).  train_path_mamba's scan (8 x
# 128: one chunk), train_step_mamba_long's (8 x 2048: 8 chunks of 256, the
# carry between chunks on the path), then the edges of the kernel's
# 8-step stages and 32-channel blocks: 65 chunks of 8 (one stage each) at
# a d_inner that is not a multiple of the block, 65 chunks of 4 (shorter
# than a stage), one chunk of 100 (its last stage 4 steps), 3 blocks (far
# below one wave), one step
SELECTIVE_BWD_CASES = [
    ("mamba_fused_backward", (TRAIN_B, TRAIN_S, 8192, 16), 20),
    ("mamba_fused_backward_long", (TRAIN_B, MAMBA_LONG_S, 8192, 16), 3),
    ("ragged_chunks", (2, 520, 200, 16), 0),
    ("short_chunks", (2, 260, 136, 16), 0),
    ("ragged_stage", (3, 100, 200, 16), 0),
    ("three_blocks", (1, 24, 72, 16), 0),
    ("one_step", (1, 1, 128, 16), 0)]
# dbc of the backward against its plain version: sums over d in another
# order, max abs error per unit of the largest magnitude (dA's too,
# recorded; dxh, ddt and dA are bit for bit)
SELECTIVE_BWD_TOL = 1e-6
# train_step_rgemma: RecurrentGemma-9B at full width, depth 38 -> 3 (one
# (rglru, rglru, attn) period: 2.754e9 parameters, 11.0 GB in fp32), one
# loss and gradient at batch 8 x 128: the whole loop (~15-19x its
# weights) does not fit one card at any depth of this width
RGEMMA_TRAIN_CUT = {"n_layers": 3}
# train_step_rgemma and its card-vs-CPU gradient scale the attention's
# wq and wk by TRAIN_COOL: as drawn the local attention is near one-hot,
# the card's gradient lies ~1.6e-3 per unit from the CPU's and the loss
# ~1000x past its linear range along the first step (train_witness.py;
# ROADMAP.md §3)
# train_card_vs_cpu's SSM cases: Falcon-Mamba at full width, 2 layers,
# its gradient at batch 2 x 32, then 1 client, batch 2 x 32, 1 step (2
# clients and 4 steps before the MoE, audio and VLM cases came: one step
# and its fold, K1 at the tied embedding's real shape, against the CPU);
# RecurrentGemma's gradient at full width, 3 layers, batch 1 x 32 (the
# same weights on both sides)
MAMBA_CMP_CUT = {"n_layers": 2}
MAMBA_CMP = {"batch": 2, "seq": 32, "steps": 1}
# and a second gradient at batch 1 x 512: two of the scan's 256-step
# chunks, the fused backward's carry between them against the CPU's
MAMBA_CMP_LONG = (1, 512)
MAMBA_CMP_CLIENTS, MAMBA_CMP_TOKENS = 1, 5_000
RGEMMA_CMP_B, RGEMMA_CMP_S = 1, 32
# train_path_deepseek: DeepSeek-V2-Lite-16B at full width, depth 27 -> 2
# (the dense layer and one MoE layer of 64 routed experts top-6 and 2
# shared; 1.08e9 parameters, 4.3 GB in fp32, untied head), at train_path's
# settings: a fold runs K1 once over the (102400, 2048) embedding, a
# forward the MoE layer's host read of its per-expert counts once
DEEPSEEK_TRAIN_CUT = {"n_layers": 2}
# train_step_families: one loss and gradient of each remaining family, as
# train_step_rgemma: (phase case, architecture, the config's fields cut,
# batch, seq).  Kimi-K2 at full width, 2 layers, its experts cut to 16
# (KIMI_FULL_CASE; 384 are 67.6 GB a MoE layer in fp32); Whisper-small at
# full size on make_batch's stub frames (1536 a clip); Qwen2-VL-72B at
# full width, depth 80 -> 2, batch 2 x 2016 (its 1024-patch prefix and
# 992 tokens: a sequence must be longer than the prefix).  Neither
# package's training CLI trains Whisper or Qwen2-VL (their batches lack
# the stubs: KeyError 'frames' / 'patches'), so the loss takes
# make_batch's stubs
TRAIN_FAMILIES = (
    ("kimi", KIMI_ARCH, {"n_layers": 2, "n_experts": 16}, TRAIN_B, TRAIN_S),
    ("whisper", WHISPER_ARCH, {}, TRAIN_B, TRAIN_S),
    ("qwen2vl", QWEN2VL_ARCH, {"n_layers": 2}, 2, SERVE_PROMPT))
# train_path_deepseek and train_step_families gate at TRAIN_FO_FRAC: on
# an H100 (train_witness.py's "mla" and "families" readings) their
# cooled models' central difference over 1/8 of the first step is 1.0076
# (DeepSeek), 0.9928 (Kimi), 0.99998 (Whisper) and 0.9991 (Qwen2-VL) of
# its prediction
# train_card_vs_cpu's cases of the MoE, audio and VLM families: (case,
# architecture, the config's fields cut, batch, seq), each gradient from
# the same weights on both sides.  DeepSeek at train_path_deepseek's cut
# and Kimi at train_step_families' (full width, 2 layers); Whisper at full
# width with 2 encoder and 2 decoder layers (1536 frames: the encoder's
# self-attention over 3 blocks of 512) and Qwen2-VL at full width with 1
# layer, a 64-patch prefix and its vocabulary cut to 16384, so the CPU's
# gradient takes seconds (at full depth, or past 1024 patches, minutes;
# the 152064 x 8192 embedding and head alone 18 s); Kimi at batch 1 x 32
# with its vocabulary cut to 16384 too (its CPU gradient was bound by the
# 1.17e9-parameter head and embedding: 36 s of the case on an H100 host;
# train_step_families takes its full vocabulary on the card)
FAMILY_CMP = (
    ("deepseek", DEEPSEEK_ARCH, DEEPSEEK_TRAIN_CUT, 2, 64),
    ("kimi", KIMI_ARCH, {"n_layers": 2, "n_experts": 16,
                         "vocab_size": 16384}, 1, 32),
    ("whisper", WHISPER_ARCH, {"n_layers": 2, "encoder_layers": 2}, 1, 64),
    ("qwen2vl", QWEN2VL_ARCH, {"n_layers": 1, "n_patches": 64,
                               "vocab_size": 16384}, 1, 96))
# and DeepSeek's loop: 1 client, batch 2 x 32, 1 step (its fold and K1 at
# the embedding's real shape; the CPU's loop at 1.085e9 parameters takes
# ~25 s a step and client: Qwen2's loop holds the snapshots)
DEEPSEEK_CMP = {"batch": 2, "seq": 32, "steps": 1}
DEEPSEEK_CMP_CLIENTS, DEEPSEEK_CMP_TOKENS = 1, 5_000


def _train_streams(n: int, vocab: int, tokens: int):
    from repro_torch.data.lm import federated_token_clients

    return federated_token_clients(n, vocab, tokens_per_client=tokens,
                                   seed=0)


def _cool_attention(params, leaves=None):
    """``params`` with every attention's query and key projections
    (``leaves``, default TRAIN_COOL_LEAVES) scaled by TRAIN_COOL (new
    tensors; the rest shared)."""
    leaves = TRAIN_COOL_LEAVES if leaves is None else leaves
    if not isinstance(params, dict):
        return params
    return {k: (v * TRAIN_COOL if k in leaves
                and isinstance(v, torch.Tensor) else _cool_attention(v, leaves))
            for k, v in params.items()}


def _scan_launches(cfg):
    """(K2, K2 backward, fused selective scan, its backward) launches a
    gradient of ``cfg``: an RG-LRU layer runs K2 and K2's backward once
    each, a Mamba layer the fused scan (saving its chunk carries) and
    the fused backward once each."""
    layers = _recurrent_layers(cfg)
    return ((0, 0, layers, layers) if cfg.family == "ssm"
            else (layers, layers, 0, 0))


class Routing:
    """Wraps ``repro_torch.models.moe._route`` (the package is left as it
    is) for a card-vs-CPU comparison of a MoE model whose top-k choice
    may flip between the devices at a near tie.  ``Routing()`` records
    each call's expert ids on the CPU (the card's run); ``Routing(ids)``
    makes the i-th call take the i-th recorded ids, with its own softmax
    probabilities gathered at those ids and normalised as ``_route``
    does, and counts in ``flips[i]`` the tokens whose own top-k set
    differs from the forced one.  Forcing a run's own ids changes
    nothing."""

    def __init__(self, ids=None):
        self.forced = ids is not None
        self.ids = list(ids) if self.forced else []
        self.flips = []
        self.calls = 0

    def route(self, router_w, xt, k: int):
        import torch.nn.functional as F

        if not self.forced:
            out = self._inner(router_w, xt, k)
            self.ids.append(out[1].detach().cpu())
            self.calls += 1
            return out
        ids = self.ids[self.calls].to(xt.device)
        self.calls += 1
        logits = (xt @ router_w).to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        own = torch.sort(probs.detach(), dim=-1, descending=True,
                         stable=True)[1][:, :k]
        self.flips.append(int((torch.sort(own, -1)[0]
                               != torch.sort(ids, -1)[0]).any(-1).sum()))
        gates = torch.gather(probs, 1, ids)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        E = logits.shape[-1]
        me = probs.mean(0)
        ce = F.one_hot(ids, E).to(torch.float32).sum(1).mean(0)
        return gates, ids, E * torch.sum(me * ce)

    def __enter__(self):
        from repro_torch.models import moe

        self._inner = moe._route
        moe._route = self.route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self._inner
        return False


def _flips_by_layer(flips, n_moe: int):
    """Per MoE layer, the tokens flipped over the run's calls (a forward
    calls the MoE layers in order)."""
    return [sum(flips[i::n_moe]) for i in range(n_moe)]


def _moe_layers(cfg) -> int:
    return cfg.n_layers - cfg.first_dense_layers if cfg.family == "moe" \
        else 0


def _host_reads(cfg, n_tokens: int) -> int:
    """A forward's host reads of the per-expert counts at ``n_tokens``
    tokens: one a MoE layer where ``moe._dispatch`` takes the gathered
    rows (the training batches' 1024 tokens), none where every expert
    runs at once."""
    from repro_torch.models import moe

    return _moe_layers(cfg) if moe._dispatch(n_tokens) is moe._gathered \
        else 0


def _train_launches():
    """(K1 per-row, feature_fold, K2, K3) launches since the last
    reset."""
    k1, k2 = _launches()
    return k1, _fold_launches(), k2, _flash_launches()


# the training phases' launch tuple
GRAD_LAUNCHES = ("K1", "feature_fold", "K2", "K3", "K2 backward",
                 "fused scan", "fused backward")


def _grad_launches():
    """GRAD_LAUNCHES' counts since the last reset."""
    return _train_launches() + (_scan_backward_launches(),
                                _selective_launches(),
                                _selective_backward_launches())


def _launch_fields(launches) -> dict:
    """The record's fields of a GRAD_LAUNCHES tuple."""
    return {"feature_attention_launches": launches[0],
            "feature_fold_launches": launches[1],
            "linear_scan_launches": launches[2],
            "flash_attention_launches": launches[3],
            "linear_scan_backward_launches": launches[4],
            "selective_scan_launches": launches[5],
            "selective_scan_backward_launches": launches[6]}


def _recurrent_layers(cfg) -> int:
    """Mamba or RG-LRU layers of ``cfg``: K2 forward and backward launches
    a gradient (the hybrid's superblocks, then its rglru tail)."""
    if cfg.family == "ssm":
        return cfg.n_layers
    if cfg.family == "hybrid":
        return sum(kind == "rglru" for kind in (
            cfg.block_pattern * cfg.n_layers)[:cfg.n_layers])
    return 0


def _batch(stream, seed: int):
    from repro_torch.data.lm import batches_from_tokens

    return {k: torch.from_numpy(v).to(DEV) for k, v in next(
        batches_from_tokens(stream, TRAIN_B, TRAIN_S, seed=seed)).items()}


def _first_step_check(model, params, streams, frac: float = TRAIN_FO_FRAC):
    """Client 0's first local step of the loop (its first batch, its
    delay, fresh slots, the server snapshot ``params``): the loss change
    on that batch and its first-order prediction <g, u>, and the central
    difference over ``frac`` of the step against its prediction.
    The gradient is taken over every leaf: autograd refuses a leaf the
    loss does not reach."""
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.launch.train import local_step
    from repro_torch.optim.asofed import init_slots

    batch = _batch(streams[0], 0)
    delay = float(np.float32(np.random.default_rng(0).uniform(
        10.0, 100.0, size=len(streams))[0]))
    q = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = model.loss(q, batch)[0]
    g = torch.autograd.grad(loss, tree_leaves(q))
    loss0 = float(loss.detach())
    del q, loss
    new, _, _ = local_step(model, params, params, init_slots(params), batch,
                           delay, **TRAIN_HYPER)
    def dot(a, b) -> float:  # <g, a - b>, summed in fp64
        return sum(float(torch.sum(gi * (x - y), dtype=torch.float64))
                   for gi, x, y in zip(g, tree_leaves(a), tree_leaves(b)))

    with torch.no_grad():
        pred = dot(new, params)
        loss1 = float(model.loss(new, batch)[0])
        fwd = tree_map(lambda n, w: w + frac * (n - w), new, params)
        bwd = tree_map(lambda n, w: w - frac * (n - w), new, params)
        del new
        pred_t = dot(fwd, bwd)
        central = (float(model.loss(fwd, batch)[0])
                   - float(model.loss(bwd, batch)[0]))
        del fwd, bwd
    del g
    torch.cuda.empty_cache()
    return {"loss_before": loss0, "loss_after": loss1,
            "change": loss1 - loss0, "predicted": pred,
            "ratio_whole_step": (loss1 - loss0) / pred if pred else math.nan,
            "fraction": frac, "central": central,
            "central_predicted": pred_t,
            "ratio": central / pred_t if pred_t else math.nan}


def _first_step_ok(r) -> bool:
    """train_path's gate on ``_first_step_check``'s record."""
    return (r["change"] < 0 and r["predicted"] < 0
            and abs(r["ratio"] - 1.0) <= TRAIN_FO_TOL)


def _eval_loss(model, params, streams) -> float:
    with torch.no_grad():
        return float(np.mean([float(model.loss(
            params, _batch(s, TRAIN_EVAL_SEED + i))[0])
            for i, s in enumerate(streams)]))


class _CountCalls:
    """Counts the calls of ``module.name`` while it is entered (the
    function is wrapped, not changed)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.n = module, name, 0

    def __enter__(self):
        inner = self.inner = getattr(self.module, self.name)

        def counted(*args, **kw):
            self.n += 1
            return inner(*args, **kw)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)
        return False


def _train_loop_phase(phase: str, profile_phase: str, arch: str, cut,
                      cool: bool, frac: float, profile_kernels,
                      loss_falls: bool = False):
    """``repro_torch.launch.train.train`` on ``arch`` (its depth cut by
    ``cut``; None: full size) from the port's own seed-0 weights (every
    attention's query and key projections scaled by TRAIN_COOL where
    ``cool``), at the training CLI's settings; then one further step (one
    client, fresh slots) profiled as ``profile_phase``, with each of
    ``profile_kernels`` ({tag: kernel name}) timed and shared.  Gated,
    after the records: client 0's first local step
    (``_first_step_check`` over ``frac`` of it), finite losses and
    weights, the launches (one per-row K1 a fold over the token
    embedding, ``_scan_launches`` a gradient, no feature_fold, no K3),
    a MoE layer's host read of its per-expert counts once a forward, and
    where ``loss_falls`` the mean of the last 10 losses below the first.
    Returns (K1, K2, K2 backward, fused scan, fused backward) launches of
    the run."""
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import train
    from repro_torch.models import build_model, moe

    full = get_arch(arch)
    cfg = dataclasses.replace(full, **cut) if cut else full
    model = build_model(cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEV).manual_seed(0),
                        device=DEV)
    if cool:
        params = _cool_attention(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    t0 = time.perf_counter()
    streams = _train_streams(TRAIN_CLIENTS, cfg.vocab_size, TRAIN_TOKENS)
    streams_s = time.perf_counter() - t0
    first = _first_step_check(model, params, streams, frac)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with _CountCalls(moe, "_gathered") as host_reads:
        res = train(model, params, streams, steps=TRAIN_STEPS,
                    batch=TRAIN_B, seq=TRAIN_S, seed=0, device=DEV,
                    log=None, **TRAIN_HYPER)
    torch.cuda.synchronize()
    launches = _grad_launches()
    peak = torch.cuda.max_memory_allocated()
    k2, k2b, ss, ssb = _scan_launches(cfg)
    want = (TRAIN_STEPS, 0, TRAIN_STEPS * k2, 0, TRAIN_STEPS * k2b,
            TRAIN_STEPS * ss, TRAIN_STEPS * ssb)
    reads_want = TRAIN_STEPS * _host_reads(cfg, TRAIN_B * TRAIN_S)
    losses = res["losses"]
    last10 = float(np.mean(losses[-10:]))
    finite = all(math.isfinite(v) for v in losses) and all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(res["params"]))
    # the gates, raised after the records: one failed gate shows the rest
    failed = [msg for ok, msg in (
        (_first_step_ok(first),
         f"client 0's first step {first}: the loss change must be negative "
         f"and the central difference within {TRAIN_FO_TOL} of its "
         f"prediction per unit"),
        (launches == want,
         f"{GRAD_LAUNCHES} launches {launches}; expected {want}: one "
         f"per-row K1 a fold, {_scan_launches(cfg)} K2, K2 backward, fused "
         f"scan and fused backward launches a gradient"),
        (host_reads.n == reads_want,
         f"{host_reads.n} host reads of the per-expert counts; expected "
         f"{reads_want}, one a MoE layer a forward"),
        (finite and (last10 < losses[0] or not loss_falls),
         f"losses {losses} (finite{', the mean of the last 10 below the '
         'first' if loss_falls else ''}) or the final server weights not "
         f"finite")) if not ok]
    eval_loss = (_eval_loss(model, params, streams),
                 _eval_loss(model, res["params"], streams))
    steady = res["step_s"][TRAIN_WARMUP:]
    med = statistics.median(steady)
    emit({"phase": phase, "arch": cfg.name,
          **({"reduced": {"n_layers": [full.n_layers, cfg.n_layers]}}
             if cut else {}),
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "params": n_params,
          "weight_bytes": 4 * n_params, "dtype": "float32",
          "clients": TRAIN_CLIENTS, "batch": TRAIN_B, "seq": TRAIN_S,
          "steps": TRAIN_STEPS, **TRAIN_HYPER, "feature_learning": True,
          "tokens_per_client": TRAIN_TOKENS, "init_s": init_s,
          "streams_s": streams_s, "wall_s": res["wall_s"],
          "step_s": res["step_s"], "warmup_steps": TRAIN_WARMUP,
          "step_s_median": med,
          "step_s_p90": float(np.percentile(steady, 90)),
          "tokens_per_s": TRAIN_B * TRAIN_S / med,
          "attention_scaled_leaves": (list(TRAIN_COOL_LEAVES) if cool
                                      else []),
          "attention_scale": TRAIN_COOL if cool else 1.0,
          "first_loss": losses[0], "last10_loss_mean": last10,
          "losses": losses, "clients_order": res["clients"],
          "first_step": first, "first_step_tolerance": TRAIN_FO_TOL,
          "eval_loss_initial": eval_loss[0], "eval_loss_final": eval_loss[1],
          "eval_seeds": [TRAIN_EVAL_SEED + i for i in range(TRAIN_CLIENTS)],
          "peak_device_bytes": peak,
          "moe_host_reads": host_reads.n, **_launch_fields(launches)})
    final = res["params"]
    del res, params
    torch.cuda.empty_cache()
    _, wall, per = _device_profile(lambda: train(
        model, final, streams[:1], steps=1, batch=TRAIN_B, seq=TRAIN_S,
        seed=0, device=DEV, log=None, **TRAIN_HYPER))
    rec = _profile_record(per, wall, ("feature_attention_rows",
                                      "feature_fold_tick", "fa_fwd",
                                      "linear_scan_channels",
                                      "linear_scan_backward_channels",
                                      "selective_scan_fwd",
                                      "selective_scan_bwd"))
    busy = sum(ms for _, ms, _ in per)
    shares = {}
    for tag, name in profile_kernels.items():
        ms = sum(m for k, m, _ in per if name in k)
        shares[f"{tag}_ms"] = ms
        shares[f"{tag}_share_of_busy"] = ms / busy if busy else \
            "not measured"
        shares[f"{tag}_share_of_wall"] = ms / 1e3 / wall
    emit({"phase": profile_phase, "arch": cfg.name, "steps": 1,
          "clients": 1, "wall_s": wall, **rec, **shares})
    del final
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{phase}: " + "; ".join(failed))
    return launches[0], launches[2], launches[4], launches[5], launches[6]


K1_PROFILE = {"k1": "feature_attention_rows"}


def phase_train_path():
    """Qwen2-0.5B at full size (``_train_loop_phase``), every attention's
    wq and wk scaled by TRAIN_COOL: the loss on the plain attention under
    autograd, ``asofed_transform``, the Eq. (4) fold and the feature
    pass, one per-row K1 launch over the (151936, 896) embedding a fold,
    no feature_fold, no K2, no K3; the first step gated over
    TRAIN_FO_FRAC, and the loss must fall.  Returns the K1 launches of
    the run."""
    return _train_loop_phase("train_path", "train_profile", TRAIN_ARCH,
                             None, True, TRAIN_FO_FRAC, K1_PROFILE,
                             loss_falls=True)[0]


def _first_asofed_step_eps(n_clients: int) -> float:
    """``r eta``: client 0's first ASO-Fed step from fresh slots at the
    server weights is ``-r eta g`` with ``r = max(1, ln delay)`` (Eq. 11
    over one round)."""
    delay = float(np.float32(np.random.default_rng(0).uniform(
        10.0, 100.0, size=n_clients)[0]))
    return max(1.0, math.log(delay)) * TRAIN_HYPER["eta"]


def _grad(model, params, batch):
    """(loss, [gradient of each leaf of params])."""
    from repro_torch.common.pytree import tree_leaves, tree_map

    q = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = model.loss(q, batch)[0]
    return loss.detach(), list(torch.autograd.grad(loss, tree_leaves(q)))


def phase_train_path_mamba():
    """Falcon-Mamba-7B at full width, depth cut to MAMBA_TRAIN_CUT
    (``_train_loop_phase``), from the seed-0 weights as drawn: a gradient
    runs the fused selective scan once a layer (saving its chunk carries)
    and its backward kernel once, K2 not at all, a fold one per-row K1
    launch over the (65024, 4096) tied embedding; the first step gated
    over TRAIN_FO_FRAC_SSM.  Returns (K1, K2, K2 backward, fused scan,
    fused backward) launches."""
    return _train_loop_phase(
        "train_path_mamba", "train_profile_mamba", MAMBA_ARCH,
        MAMBA_TRAIN_CUT, False, TRAIN_FO_FRAC_SSM,
        {**K1_PROFILE, "fused": "selective_scan_fwd",
         "fused_backward": "selective_scan_bwd"})


def phase_train_path_deepseek():
    """DeepSeek-V2-Lite-16B at full width, depth cut to DEEPSEEK_TRAIN_CUT
    (``_train_loop_phase``: the dense layer and one 64-expert MoE layer),
    its attention cooled (TRAIN_COOL_LEAVES): MLA and the gathered expert
    products on plain PyTorch under autograd, one host read of the
    per-expert counts a forward, one per-row K1 launch over the (102400,
    2048) embedding a fold, no K2, no K3; the first step gated over
    TRAIN_FO_FRAC.  Returns the K1 launches of the run."""
    return _train_loop_phase(
        "train_path_deepseek", "train_profile_deepseek", DEEPSEEK_ARCH,
        DEEPSEEK_TRAIN_CUT, True, TRAIN_FO_FRAC, K1_PROFILE)[0]


def _central_along_gradient(model, params, g, batch, frac: float,
                            step_eps: float):
    """Along the first ASO-Fed step from ``params`` with fresh slots,
    ``-step_eps g``, over ``frac`` of it: (the central difference
    ``L(w - t step_eps g) - L(w + t step_eps g)``, its prediction
    ``<g, fwd - bwd>`` on the rounded weights).  One perturbed copy of
    the weights at a time."""
    from repro_torch.common.pytree import tree_leaves, tree_unflatten

    leaves = tree_leaves(params)
    side = []
    with torch.no_grad():
        for sign in (1.0, -1.0):
            moved = [w - sign * frac * step_eps * gi
                     for w, gi in zip(leaves, g)]
            side.append(float(model.loss(
                tree_unflatten(params, moved), batch)[0]))
            del moved
        # <g, fwd - bwd>, a leaf at a time
        predicted = sum(float(torch.sum(
            gi * ((w - frac * step_eps * gi) - (w + frac * step_eps * gi)),
            dtype=torch.float64)) for w, gi in zip(leaves, g))
    return side[0] - side[1], predicted


LOOP_DOES_NOT_FIT = ("one gradient: the ASO-Fed loop at full width does "
                     "not fit one card")


def _train_step_case(phase: str, arch: str, cut, B: int, S: int,
                     frac: float, case=None, reps: int = 1,
                     why: str = LOOP_DOES_NOT_FIT):
    """The loss and gradient of ``arch`` (its config's fields cut by
    ``cut``) at batch B x S of ``make_batch`` (tokens and the family's
    stub), from the port's seed-0 weights with the attention cooled
    (TRAIN_COOL_LEAVES), ``reps`` times after one warm-up gradient: each
    step's time, their peak and their launches (``_scan_launches`` a
    gradient; no K1, no K3, no feature_fold), a MoE layer's host read of
    its per-expert counts once.  Gated: along client 0's first ASO-Fed
    step from these weights, ``-r eta g`` (fresh slots), over ``frac`` of
    it, the central difference within TRAIN_FO_TOL of its prediction
    (``_central_along_gradient``: weights, gradient and one perturbed
    copy).  ``why`` says in the record why one gradient and not the
    loop.  Emits the record; raises after it if a gate fails.  Returns
    (K2, K2 backward, fused scan, fused backward) launches of the counted
    gradients."""
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, make_batch, moe

    full = get_arch(arch)
    cfg = dataclasses.replace(full, **cut)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    params = _cool_attention(model.init(
        torch.Generator(device=DEV).manual_seed(0), device=DEV))
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = make_batch(cfg, B, S, seed=0, device=DEV)
    _grad(model, params, batch)  # warm-up: cuBLAS, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    steps, g = [], None
    with _CountCalls(moe, "_gathered") as host_reads:
        for _ in range(reps):
            del g
            t0 = time.perf_counter()
            loss, g = _grad(model, params, batch)
            loss0 = float(loss)
            steps.append(time.perf_counter() - t0)
    step_s = statistics.median(steps)
    launches = _grad_launches()
    peak = torch.cuda.max_memory_allocated()
    gsq = sum(float(torch.sum(gi * gi, dtype=torch.float64)) for gi in g)
    gmax = max(float(gi.abs().max()) for gi in g)
    step_eps = _first_asofed_step_eps(TRAIN_CLIENTS)
    central, predicted = _central_along_gradient(
        model, params, g, batch, frac, step_eps)
    ratio = central / predicted if predicted else math.nan
    finite = math.isfinite(loss0) and math.isfinite(gsq)
    reduced = {k: [getattr(full, k), v] for k, v in cut.items()}
    if cfg.family == "vlm":
        reduced["seq"] = [TRAIN_S, S]
    emit({"phase": phase, **({"case": case} if case else {}),
          "arch": cfg.name, "reduced": {**reduced, "loop": why},
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab_size, "params": n_params,
          "weight_bytes": 4 * n_params, "dtype": "float32", "batch": B,
          "seq": S, "stub": {"audio": "frames", "vlm": "patches"}.get(
              cfg.family), "loss": loss0, "gradients": reps,
          "step_s": step_s, "step_s_each": steps,
          "tokens_per_s": B * S / step_s,
          "grad_max_abs": gmax, "grad_sq_norm": gsq,
          "step_eps": step_eps, "fraction": frac,
          "central": central, "central_predicted": predicted,
          "ratio": ratio, "attention_scaled_leaves": list(TRAIN_COOL_LEAVES),
          "attention_scale": TRAIN_COOL,
          "tolerance": TRAIN_FO_TOL, "peak_device_bytes": peak,
          "moe_host_reads": host_reads.n, **_launch_fields(launches)})
    del g, params, batch
    torch.cuda.empty_cache()
    k2, k2b, ss, ssb = _scan_launches(cfg)
    want = (0, 0, reps * k2, 0, reps * k2b, reps * ss, reps * ssb)
    reads = reps * _host_reads(cfg, B * S)
    if not (finite and predicted < 0 and launches == want
            and host_reads.n == reads and abs(ratio - 1.0) <= TRAIN_FO_TOL):
        raise AssertionError(
            f"{phase} {cfg.name}: loss {loss0}, central difference "
            f"{central} against {predicted} (ratio {ratio}, tolerance "
            f"{TRAIN_FO_TOL}); {GRAD_LAUNCHES} launches {launches}, "
            f"expected {want}; host reads {host_reads.n}, expected {reads}")
    return launches[2], launches[4], launches[5], launches[6]


def phase_train_step_rgemma():
    """One loss and gradient of RecurrentGemma-9B at full width, depth cut
    to RGEMMA_TRAIN_CUT (both RG-LRU layers and the hd-256 local
    attention, on the plain ``blocked_attention``), batch 8 x 128
    (``_train_step_case``, gated over TRAIN_FO_FRAC_SSM): K2 and its
    backward once an RG-LRU layer, no K3.  Returns (K2, K2 backward)
    launches of the counted gradient."""
    return _train_step_case("train_step_rgemma", RGEMMA_ARCH,
                            RGEMMA_TRAIN_CUT, TRAIN_B, TRAIN_S,
                            TRAIN_FO_FRAC_SSM)[:2]


def phase_train_step_mamba_long():
    """Falcon-Mamba-7B at full width, depth cut to MAMBA_TRAIN_CUT, its
    loss and gradient at batch 8 x MAMBA_LONG_S (``_train_step_case``:
    one warm-up, MAMBA_LONG_REPS timed, gated over TRAIN_FO_FRAC_SSM):
    the fused scan and its backward once a layer a gradient, 8 chunks of
    256 steps each, K2 not at all.  Returns (fused scan, fused backward)
    launches of the timed gradients."""
    return _train_step_case(
        "train_step_mamba_long", MAMBA_ARCH, MAMBA_TRAIN_CUT, TRAIN_B,
        MAMBA_LONG_S, TRAIN_FO_FRAC_SSM, reps=MAMBA_LONG_REPS,
        why=f"gradients at {TRAIN_B} x {MAMBA_LONG_S} tokens; "
            "train_path_mamba runs the loop at 8 x 128")[2:]


def phase_train_step_families():
    """One loss and gradient of each family not trained in a loop
    (TRAIN_FAMILIES: Kimi-K2's GQA MoE, Whisper-small's encoder-decoder
    on stub frames, Qwen2-VL-72B's M-RoPE layers on a patch prefix), each
    ``_train_step_case`` gated over TRAIN_FO_FRAC: no kernel
    launched (no fold, and training attends on the plain
    ``blocked_attention``)."""
    for case, arch, cut, B, S in TRAIN_FAMILIES:
        _train_step_case("train_step_families", arch, cut, B, S,
                         TRAIN_FO_FRAC, case)


def _max_abs(t: torch.Tensor) -> float:
    """max |t| with no temporary of t's size."""
    return float(torch.linalg.vector_norm(t, float("inf")))


def _max_abs_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want|, ``got`` (on any device) copied once to ``want``'s
    device and dtype and the difference taken in place: at a 15 GB
    model a temporary a term would page-fault tens of GB on the host."""
    d = got.to(want.device, want.dtype, copy=True)
    return _max_abs(d.sub_(want))


def _per_unit(got, want) -> float:
    """max |got - want| per unit of want's largest magnitude (at least 1);
    got may be on the card."""
    return _max_abs_gap(got, want) / max(_max_abs(want), 1.0)


def _loop_card_vs_cpu(cfg, params, n_clients: int, tokens: int, loop):
    """``train`` on the card and on the CPU from ``params`` (CPU tensors)
    and the same streams: (record fields, (K1, feature_fold, K2, K3, K2
    backward) launches of the card's run)."""
    from repro_torch.common.pytree import tree_flatten_with_path, tree_map
    from repro_torch.launch.train import train
    from repro_torch.models import build_model

    model = build_model(cfg)
    streams = _train_streams(n_clients, cfg.vocab_size, tokens)
    kw = {**loop, **TRAIN_HYPER, "seed": 0, "log": None}
    card_params = tree_map(lambda t: t.to(DEV), params)
    _reset_launches()
    with Routing() as card_routes:
        card = train(model, card_params, streams, device=DEV, **kw)
    torch.cuda.synchronize()
    launches = _grad_launches()
    t0 = time.perf_counter()
    with Routing(card_routes.ids) as forced:
        cpu = train(model, params, streams, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    want = np.array(cpu["losses"])
    loss_err = float(np.max(np.abs(np.array(card["losses"]) - want))) / max(
        float(np.max(np.abs(want))), 1.0)
    got = dict(tree_flatten_with_path(card["params"]))
    leaf_err = {"/".join(path): _per_unit(got[path], w)
                for path, w in tree_flatten_with_path(cpu["params"])}
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "clients": n_clients, **loop,
           "card_losses": card["losses"], "cpu_losses": cpu["losses"],
           "loss_err_per_unit": loss_err,
           "weight_err_per_unit": max(leaf_err.values()),
           "weight_err_by_leaf": leaf_err, "tolerance": TRAIN_TOL,
           "card_wall_s": card["wall_s"], "cpu_wall_s": cpu_s,
           **_routing_record(cfg, forced), **_launch_fields(launches)}
    return rec, launches


def _routing_record(cfg, forced) -> dict:
    """A MoE comparison's routing fields: the CPU took the card's expert
    ids (``Routing``); the tokens whose own top-k set differed, per MoE
    layer over the run's forwards, and per call."""
    if cfg.family != "moe":
        return {}
    return {"routing": "forced: the CPU takes the card's expert ids",
            "route_calls": forced.calls,
            "route_flips_by_layer": _flips_by_layer(forced.flips,
                                                    _moe_layers(cfg)),
            "route_flips_by_call": forced.flips}


def _grad_gaps(paths, got, want):
    """{leaf path: max |got - want| per unit of want's largest magnitude,
    floored at GRAD_FLOOR of the largest over all leaves}; ``got`` may be
    on the card, ``want`` on the CPU."""
    scale = [_max_abs(w) for w in want]
    floor = GRAD_FLOOR * max(scale)
    return {path: _max_abs_gap(x, w) / max(m, floor)
            for path, x, w, m in zip(paths, got, want, scale)}


def _grad_card_vs_cpu(cfg, params, B: int, S: int):
    """``cfg``'s loss and gradient on batch B x S (``make_batch``, seed
    0) from ``params`` on the card and from a copy on the CPU, every leaf
    within ``_grad_gaps``; a MoE model's CPU side takes the card's expert
    ids (``Routing``).  Returns (record, GRAD_LAUNCHES of the card's
    gradient)."""
    from repro_torch.common.pytree import tree_flatten_with_path, tree_map
    from repro_torch.models import build_model, make_batch

    model = build_model(cfg)
    card_params = tree_map(lambda t: t.to(DEV), params)
    params = tree_map(lambda t: t.cpu(), params)
    batch = make_batch(cfg, B, S, seed=0, device="cpu")
    _reset_launches()
    with Routing() as card_routes:
        card_loss, card_g = _grad(model, card_params,
                                  {k: v.to(DEV) for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = _grad_launches()
    del card_params
    t0 = time.perf_counter()
    with Routing(card_routes.ids) as forced:
        cpu_loss, cpu_g = _grad(model, params, batch)
    cpu_s = time.perf_counter() - t0
    paths = ["/".join(p) for p, _ in tree_flatten_with_path(params)]
    grad_err = _grad_gaps(paths, card_g, cpu_g)
    loss_err = abs(float(card_loss) - float(cpu_loss)) / max(
        abs(float(cpu_loss)), 1.0)
    rec = {"arch": cfg.name, "case": "gradient",
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "batch": B, "seq": S,
           "card_loss": float(card_loss), "cpu_loss": float(cpu_loss),
           "loss_err_per_unit": loss_err,
           "grad_err_per_unit": max(grad_err.values()),
           "grad_err_by_leaf": grad_err, "grad_floor_share": GRAD_FLOOR,
           "tolerance": TRAIN_TOL, "cpu_s": cpu_s,
           **_routing_record(cfg, forced), **_launch_fields(launches)}
    del card_g, cpu_g, params
    torch.cuda.empty_cache()
    return rec, launches


def phase_train_card_vs_cpu():
    """The training slice on the card against the CPU, each within
    TRAIN_TOL per unit: ``train`` on Qwen2-0.5B at full width, 2 layers
    (attention cooled on both sides; each step's loss and each final
    server leaf), on Falcon-Mamba-7B at full width, 2 layers (as drawn;
    the same, and first every gradient leaf at the initial weights, at
    MAMBA_CMP's batch and at MAMBA_CMP_LONG's, two of the scan's 256-step
    chunks: a fault in the scan's gradient of A moves the loss along a
    step by ~1e-5 of its change, past what a loss difference or the
    weights per unit can show, and the A_log gradient by its own size)
    and on DeepSeek-V2-Lite
    at full width, 2 layers (its gradient first); the loss and every
    gradient leaf of RecurrentGemma-9B at full width, 3 layers, and of
    FAMILY_CMP's Kimi-K2, Whisper and Qwen2-VL cuts (cooled, the same
    weights on both sides).  The MoE cases' CPU side takes the card's
    expert ids (``Routing``), and their records count the tokens whose
    own top-k set differed.  Returns {architecture: (K1, K2, K2 backward,
    fused scan, fused backward) launches of its card runs}."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    out = {}

    def grad_case(cfg, params, B, S, cool, case=None):
        t0 = time.perf_counter()
        rec, launches = _grad_card_vs_cpu(cfg, params, B, S)
        emit({"phase": "train_card_vs_cpu", **rec,
              **({"reduced": case} if case else {}),
              "case_wall_s": time.perf_counter() - t0,
              "attention_scaled_leaves": (list(TRAIN_COOL_LEAVES) if cool
                                          else [])})
        k2, k2b, ss, ssb = _scan_launches(cfg)
        want = (0, 0, k2, 0, k2b, ss, ssb)
        if launches != want or not (
                rec["loss_err_per_unit"] <= TRAIN_TOL
                and rec["grad_err_per_unit"] <= TRAIN_TOL):
            raise AssertionError(
                f"train_card_vs_cpu {cfg.name} gradient: {GRAD_LAUNCHES} "
                f"launches {launches}, expected {want}; loss "
                f"{rec['loss_err_per_unit']}, gradient "
                f"{rec['grad_err_per_unit']} per unit (tolerance "
                f"{TRAIN_TOL})")
        return np.array((0,) + launches[2:3] + launches[4:])

    # the loops' clients and steps before the MoE, audio and VLM cases
    # came (cut for the script's 1000 s)
    for arch, cut, cool, n, tokens, loop, grad_shapes, was in (
            (TRAIN_ARCH, TRAIN_CUT, True, TRAIN_CMP_CLIENTS,
             TRAIN_CMP_TOKENS, TRAIN_CMP, (), (3, 6)),
            (MAMBA_ARCH, MAMBA_CMP_CUT, False, MAMBA_CMP_CLIENTS,
             MAMBA_CMP_TOKENS, MAMBA_CMP, ((MAMBA_CMP["batch"],
                                            MAMBA_CMP["seq"]),
                                           MAMBA_CMP_LONG), (2, 4)),
            (DEEPSEEK_ARCH, DEEPSEEK_TRAIN_CUT, True, DEEPSEEK_CMP_CLIENTS,
             DEEPSEEK_CMP_TOKENS, DEEPSEEK_CMP, (FAMILY_CMP[0][3:],),
             None)):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_arch(arch), **cut)
        params = build_model(cfg).init(
            torch.Generator(device=DEV).manual_seed(0), device=DEV)
        if cool:
            params = _cool_attention(params)
        params = tree_map(lambda t: t.cpu(), params)
        grad = sum((grad_case(cfg, params, *shape, cool)
                    for shape in grad_shapes), np.zeros(5, dtype=int))
        rec, launches = _loop_card_vs_cpu(cfg, params, n, tokens, loop)
        del params
        k2, k2b, ss, ssb = _scan_launches(cfg)
        steps = loop["steps"]
        want = (steps, 0, steps * k2, 0, steps * k2b, steps * ss,
                steps * ssb)
        emit({"phase": "train_card_vs_cpu", **rec,
              **({"reduced": {"clients": [was[0], n],
                              "steps": [was[1], loop["steps"]]}}
                 if was else {}),
              "case_wall_s": time.perf_counter() - t0,
              "attention_scaled_leaves": (list(TRAIN_COOL_LEAVES) if cool
                                          else [])})
        if launches != want:
            raise AssertionError(
                f"train_card_vs_cpu {arch}: {GRAD_LAUNCHES} launches "
                f"{launches}; expected {want}")
        if not (rec["loss_err_per_unit"] <= TRAIN_TOL
                and rec["weight_err_per_unit"] <= TRAIN_TOL):
            raise AssertionError(
                f"train_card_vs_cpu {arch}: losses "
                f"{rec['loss_err_per_unit']}, weights "
                f"{rec['weight_err_per_unit']} per unit (tolerance "
                f"{TRAIN_TOL})")
        out[arch] = tuple(int(v) for v in grad + np.array(
            [launches[i] for i in (0, 2, 4, 5, 6)]))
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_arch(RGEMMA_ARCH), **RGEMMA_TRAIN_CUT)
    params = _cool_attention(build_model(cfg).init(
        torch.Generator(device=DEV).manual_seed(0), device=DEV))
    out[RGEMMA_ARCH] = tuple(int(v) for v in grad_case(
        cfg, params, RGEMMA_CMP_B, RGEMMA_CMP_S, True))
    del params
    torch.cuda.empty_cache()
    for case, arch, cut, B, S in FAMILY_CMP[1:]:
        full = get_arch(arch)
        cfg = dataclasses.replace(full, **cut)
        params = _cool_attention(build_model(cfg).init(
            torch.Generator(device=DEV).manual_seed(0), device=DEV))
        out[arch] = tuple(int(v) for v in grad_case(
            cfg, params, B, S, True,
            {k: [getattr(full, k), v] for k, v in cut.items()}))
        del params
        torch.cuda.empty_cache()
    return out


def phase_quickstart_path():
    """``repro_torch.launch.quickstart.quickstart`` on the card: reduced
    TinyLlama, 3 clients, 24 rounds (one per-row K1 launch a round), then
    prefill (K3 once a layer) and 8 greedy decode steps.  Returns the
    (K1, K3) launches."""
    from repro_torch.launch import quickstart as qs

    _reset_launches()
    t0 = time.perf_counter()
    res = qs.quickstart(device=DEV, log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _train_launches()
    n_layers = res["params"]["blocks"]["ln1"]["scale"].shape[0]
    want = (qs.ROUNDS, 0, 0, n_layers)
    if launches != want:
        raise AssertionError(f"quickstart_path: (K1, feature_fold, K2, K3) "
                             f"launches {launches}; expected {want}")
    if not (all(math.isfinite(v) for v in res["losses"])
            and torch.isfinite(res["prefill_logits"]).all()
            and len(res["generated"]) == qs.GEN):
        raise AssertionError(f"quickstart_path: losses {res['losses']}, "
                             f"generated {res['generated']}")
    emit({"phase": "quickstart_path", "arch": qs.ARCH, "reduced": True,
          "clients": qs.CLIENTS, "rounds": qs.ROUNDS, "wall_s": wall,
          "losses": res["losses"], "generated": res["generated"],
          "feature_attention_launches": launches[0],
          "flash_attention_launches": launches[3]})
    return launches[0], launches[3]


# the serve phases, which --only can run alone
SERVE_PHASES = ("flash_vs_plain", "serve_path", "serve_path_bf16",
                "serve_path_phi4", "serve_path_mamba", "serve_path_rgemma",
                "serve_path_deepseek", "serve_path_kimi",
                "serve_path_whisper", "serve_path_qwen2vl")
# the phases --only can run alone (after the build), in this order
ONLY_PHASES = ("kernel_vs_plain", "scan_vs_plain", "main_path",
               "assoc_path", "oracle_path", "sweep_path", "paper_rows",
               "residency_path", "chaos_path", "resume_path") \
    + SERVE_PHASES + ("serve_card_vs_cpu",) \
    + ("train_path", "train_path_mamba", "train_path_deepseek",
       "train_step_rgemma", "train_step_mamba_long", "train_step_families",
       "train_card_vs_cpu", "quickstart_path")
# the serve paths after serve_path: (phase, architecture, weights' dtype,
# the config's fields cut)
SERVE_MODEL_PATHS = (
    ("serve_path_bf16", SERVE_ARCH, torch.bfloat16, None),
    # phi4-mini-3.8B in bf16 (~7.7 GB of weights): K3's hd-128 build
    ("serve_path_phi4", PHI4_ARCH, torch.bfloat16, None),
    # Falcon-Mamba-7B in bf16 (~14 GB of weights); each layer's fused
    # scan holds dt and y, 528 MB each in fp32 (K2's route held three
    # 8.46 GB fp32 tensors)
    ("serve_path_mamba", MAMBA_ARCH, torch.bfloat16, None),
    # RecurrentGemma-9B in bf16 (~20.9 GB of weights): K2 at (8, 2016,
    # 4096) and K3's hd-256 build
    ("serve_path_rgemma", RGEMMA_ARCH, torch.bfloat16, None),
    # DeepSeek-V2-Lite-16B in bf16 (~31.4 GB of weights): MLA, no kernel
    ("serve_path_deepseek", DEEPSEEK_ARCH, torch.bfloat16, None),
    # Kimi-K2 at full width, 2 layers, in bf16 (~39.9 GB of weights):
    # K3's hd-112 build
    ("serve_path_kimi", KIMI_ARCH, torch.bfloat16, KIMI_CUT),
    # Whisper-small at full size in bf16 (0.56 GB of weights): K3
    # non-causal at (32, 1536, 12, 1, 64) in the encoder, causal in the
    # decoder; a 1.81 GB cross-K/V cache
    ("serve_path_whisper", WHISPER_ARCH, torch.bfloat16, None),
    # Qwen2-VL-72B at full width, 30 layers, in bf16 (57.6 GB of
    # weights): K3's hd-128 build on M-RoPE-rotated q/k
    ("serve_path_qwen2vl", QWEN2VL_ARCH, torch.bfloat16, QWEN2VL_CUT))
# the serve paths whose flash_vs_plain case is the served model's layer-0
# q/k/v, timed in both types after the serve path (its weights freed):
# {architecture: (case, causal)}
LAYER0_CASES = {WHISPER_ARCH: (WHISPER_CASE, False),
                QWEN2VL_ARCH: (QWEN2VL_CASE, True)}


def serve_phases(names):
    """Run the named phases of SERVE_PHASES: (flash_vs_plain's records,
    {serve path: its (K3, K2, fused selective scan) launches in one run},
    (0, 0, 0) for a path not run)."""
    fv, launches = {}, {p: (0, 0, 0) for p in SERVE_PHASES[1:]}
    if "flash_vs_plain" in names or "serve_path" in names:
        cfg, model, params, batch, init_s = _serve_setup()
        if "flash_vs_plain" in names:
            fv = phase_flash_vs_plain(_layer0_qkv(cfg, params, batch))
        if "serve_path" in names:
            launches["serve_path"] = phase_serve_path(cfg, model, params,
                                                      batch, init_s)
        del model, params, batch
    for phase, arch, dtype, cut in SERVE_MODEL_PATHS:
        if phase not in names:
            continue
        torch.cuda.empty_cache()
        cfg, model, params, batch, init_s = _serve_setup(dtype, arch, cut)
        if arch == KIMI_ARCH:  # K3 at hd 112 on the served layer-0 q/k/v
            qkv = _layer0_qkv(cfg, params, batch)
            pos = _arange_pos(SERVE_B, SERVE_PROMPT)
            for dt in (torch.float32, torch.bfloat16):
                fv[("kimi_model", dt)] = _flash_case(
                    "kimi_model_qkv", *(t.to(dt) for t in qkv), pos, pos,
                    True, 0, True)
            del qkv
            torch.cuda.empty_cache()
        qkv = (_layer0_qkv(cfg, params, batch) if arch in LAYER0_CASES
               else None)
        launches[phase] = phase_serve_path(
            cfg, model, params, batch, init_s, dtype,
            sfx=phase[len("serve_path"):], cut=cut)
        del model, params, batch
        if qkv is not None:  # K3 on the served layer-0 q/k/v, timed
            torch.cuda.empty_cache()
            case, causal = LAYER0_CASES[arch]
            B, S = qkv[1].shape[:2]
            pos = _arange_pos(B, S)
            for dt in (torch.float32, torch.bfloat16):
                fv[(case, dt)] = _flash_case(
                    case, *(t.to(dt) for t in qkv), pos, pos, causal, 0,
                    True, timed=True)
            del qkv
    return fv, launches


# the paths the kernels line counts each kernel's launches on
LAUNCH_PATHS = ("main_path", "assoc_path", "oracle_path", "sweep_path",
                "residency_path", "chaos_path", "resume_path") \
    + SERVE_PHASES[1:] + ("train_path", "train_path_mamba",
                          "train_path_deepseek", "train_step_rgemma",
                          "train_step_mamba_long", "train_step_families",
                          "train_card_vs_cpu", "quickstart_path")


def _by_path(**launches) -> dict:
    """{path: launches} over LAUNCH_PATHS (and any other path named), 0
    where none is given."""
    return {**{p: 0 for p in LAUNCH_PATHS}, **launches}


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
        "launches_by_path": _by_path(**by_path)}


def _embed_entry(name, rec, path, launches, cmp_launches):
    """The kernels line's entry for K1 at a training loop's embedding:
    ``launches`` on ``path``, ``cmp_launches`` on train_card_vs_cpu."""
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/feature_attention/csrc/"
                  "feature_attention.cu",
        "replaces": "src/repro/kernels/feature_attention/kernel.py:38",
        "launches": launches, "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": None, "call_ms": rec["call_ms"],
        "copy_ms": rec["copy_ms"], "shape": rec["shape"],
        "k1_route": rec["k1_route"], "warps_per_row": rec["warps_per_row"],
        "design": rec["design"],
        "launches_by_path": _by_path(**{
            path: launches, "train_card_vs_cpu": cmp_launches})}


def _scan_train_entry(name, rec, by_path):
    """The kernels line's entry for K2 forward or backward at a training
    scan; ``launches`` is the path of the case's model (its first)."""
    backward = rec["kernel"] == "linear_scan_backward"
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan/kernel.py:56",
        "entry": ("linear_scan_backward_launch" if backward
                  else "linear_scan_launch"),
        **({"note": "the reverse of that kernel's recurrence; the TPU "
                    "kernel has no backward (JAX trains on XLA's scans)"}
           if backward else {}),
        "launches": next(iter(by_path.values())),
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
        "call_ms": rec["call_ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
        "library_ms": None, "shape": rec["shape"],
        "launches_by_path": _by_path(**by_path)}


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
        if "kernel_vs_plain" in only:
            phase_kernel_vs_plain()
        if "scan_vs_plain" in only:
            phase_scan_vs_plain()
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
        if "serve_card_vs_cpu" in only:
            phase_serve_card_vs_cpu()
        if "train_path" in only:
            phase_train_path()
        if "train_path_mamba" in only:
            phase_train_path_mamba()
        if "train_path_deepseek" in only:
            phase_train_path_deepseek()
        if "train_step_rgemma" in only:
            phase_train_step_rgemma()
        if "train_step_mamba_long" in only:
            phase_train_step_mamba_long()
        if "train_step_families" in only:
            phase_train_step_families()
        if "train_card_vs_cpu" in only:
            phase_train_card_vs_cpu()
        if "quickstart_path" in only:
            phase_quickstart_path()
        print(card_line(), flush=True)
        emit({"ok": True, "only": only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    seconds = {}  # each phase's wall seconds, the build's included
    t_start = time.perf_counter()

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    kv = timed("kernel_vs_plain", phase_kernel_vs_plain)
    sv = timed("scan_vs_plain", phase_scan_vs_plain)
    fv_fold = timed("fold_vs_plain", phase_fold_vs_plain)
    launches = timed("main_path", phase_main_path)
    timed("profile", phase_profile)
    scan_launches = timed("assoc_path", phase_assoc_path)
    timed("profile_assoc", phase_profile, "fedasync",
          fold_mode="associative")
    k1_oracle = timed("oracle_path", phase_oracle_path)
    timed("sweep_path", phase_sweep_path)
    timed("paper_rows", phase_paper_rows)
    res_fold, res_scan, res_k1 = timed("residency_path",
                                       phase_residency_path)
    chaos_fold, chaos_scan, chaos_k1 = timed("chaos_path", phase_chaos_path)
    resume_fold, resume_fold_reps, resume_scan = timed("resume_path",
                                                       phase_resume_path)
    timed("card_vs_cpu", phase_card_vs_cpu)
    fv, served = timed("serve_phases", serve_phases, SERVE_PHASES)
    flash_launches = served["serve_path"][0]
    flash_launches_bf16 = served["serve_path_bf16"][0]
    flash_launches_phi4 = served["serve_path_phi4"][0]
    fused_launches_mamba = served["serve_path_mamba"][2]
    flash_launches_rgemma, scan_launches_rgemma, _ = served[
        "serve_path_rgemma"]
    flash_launches_deepseek = served["serve_path_deepseek"][0]
    flash_launches_kimi = served["serve_path_kimi"][0]
    flash_launches_whisper = served["serve_path_whisper"][0]
    flash_launches_qwen2vl = served["serve_path_qwen2vl"][0]
    # K3's fp32 hd-256 build runs on the card's fp32 RecurrentGemma at
    # full width (serve_card_vs_cpu), once a superblock; its fp32 hd-112
    # build on Kimi-K2's two cases there, once a layer
    card_cpu = timed("serve_card_vs_cpu", phase_serve_card_vs_cpu)
    # the training slice last, on a card the serve paths have left empty
    train_k1 = timed("train_path", phase_train_path)
    mamba_k1, _, _, mamba_ss, mamba_ssb = timed("train_path_mamba",
                                                phase_train_path_mamba)
    deepseek_k1 = timed("train_path_deepseek", phase_train_path_deepseek)
    rgemma_k2, rgemma_k2b = timed("train_step_rgemma",
                                  phase_train_step_rgemma)
    long_ss, long_ssb = timed("train_step_mamba_long",
                              phase_train_step_mamba_long)
    timed("train_step_families", phase_train_step_families)
    train_cmp = timed("train_card_vs_cpu", phase_train_card_vs_cpu)
    train_cmp_k1 = sum(v[0] for v in train_cmp.values())
    quick_k1, quick_k3 = timed("quickstart_path", phase_quickstart_path)
    emit({"phase": "timing", "seconds": seconds,
          "total_s": time.perf_counter() - t_start})
    flash_launches_hd256 = card_cpu[(RGEMMA_ARCH, "full_width_4_layers")][0]
    flash_launches_hd112 = sum(card_cpu[(KIMI_ARCH, case)][0] for case in (
        "reduced_hd112", KIMI_FULL_CASE))
    # and its fp32 hd-64 build at Whisper's full size (12 encoder and 12
    # decoder layers), its fp32 hd-128 build at Qwen2-VL's full width
    flash_launches_whisper_f32 = card_cpu[(WHISPER_ARCH, "full_size")][0]
    flash_launches_qwen2vl_f32 = card_cpu[(QWEN2VL_ARCH,
                                           QWEN2VL_FULL_CASE)][0]
    if flash_launches_deepseek:
        raise AssertionError(f"serve_path_deepseek launched K3 "
                             f"{flash_launches_deepseek} times (MLA: 0)")
    main_rec = kv[((8, 256), torch.float32, True)]
    fold_rec = fv_fold["main_tick"]
    reps_rec = fv_fold["main_tick_reps"]
    # K2 at the main path's largest leaf (w_h), a = 1: the case with a
    # library yardstick (torch.cumsum); the kernel's time does not depend
    # on the values of a
    scan_rec = sv[((1, 64, 16384), torch.float32, "ones")]
    mamba_rec, rglru_rec = sv["mamba"], sv["rglru"]
    fused_rec = sv["mamba_fused"]
    bwd_rec, bwd_long = sv["mamba_fused_backward"], sv[
        "mamba_fused_backward_long"]
    # K2 forward and backward on the training paths: the gradients of
    # train_step_rgemma (2 and 2) and train_card_vs_cpu's RecurrentGemma
    # (2 and 2); the fused scan and its backward, the Mamba layer's, on
    # train_path_mamba (4 and 4 a gradient), train_step_mamba_long (4 and
    # 4) and train_card_vs_cpu's Falcon-Mamba (2 and 2 a gradient)
    cmp_mamba, cmp_rgemma = train_cmp[MAMBA_ARCH], train_cmp[RGEMMA_ARCH]
    scan_train_by_path = {
        "rglru_train": dict(train_step_rgemma=rgemma_k2,
                            train_card_vs_cpu=cmp_rgemma[1]),
        "rglru_train_backward": dict(train_step_rgemma=rgemma_k2b,
                                     train_card_vs_cpu=cmp_rgemma[2])}
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
        "launches_by_path": _by_path(
            main_path=launches, residency_path=res_fold,
            chaos_path=chaos_fold, resume_path=resume_fold)}, {
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
        "launches_by_path": _by_path(chaos_path=chaos_fold,
                                     resume_path=resume_fold_reps)}, {
        # the per-row K1 at the first layer's shape (8, 256), held against
        # its plain version; oracle_path reaches it once a fold
        # (core.server.aggregate -> apply_feature_learning), the training
        # paths once a fold on the token embedding
        "name": "feature_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/feature_attention/csrc/"
                  "feature_attention.cu",
        "replaces": "src/repro/kernels/feature_attention/kernel.py:38",
        "launches": k1_oracle, "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None, "k1_route": main_rec["k1_route"],
        "warps_per_row": main_rec["warps_per_row"],
        # the untimed edge cases, each held against the plain version
        "edge_cases": {c: kv[c]["max_abs_err"] for c in K1_EDGE_CASES},
        "launches_by_path": _by_path(
            oracle_path=k1_oracle, residency_path=res_k1,
            chaos_path=chaos_k1, train_path=train_k1,
            train_path_mamba=mamba_k1, train_path_deepseek=deepseek_k1,
            train_card_vs_cpu=train_cmp_k1, quickstart_path=quick_k1)},
        # the same kernel at each training loop's first layer, its fp32
        # token embedding, once a server fold: train_path's Qwen2-0.5B
        # (151936, 896), train_path_mamba's Falcon-Mamba tied (65024, 4096)
        # and train_path_deepseek's DeepSeek-V2-Lite (102400, 2048)
        *(_embed_entry(name, kv[case], path, launches_, train_cmp[arch][0])
          for name, case, path, launches_, arch in (
              ("feature_attention_embed_table", "embed_table", "train_path",
               train_k1, TRAIN_ARCH),
              ("feature_attention_embed_table_mamba", "embed_table_mamba",
               "train_path_mamba", mamba_k1, MAMBA_ARCH),
              ("feature_attention_embed_table_deepseek",
               "embed_table_deepseek", "train_path_deepseek", deepseek_k1,
               DEEPSEEK_ARCH))), {
        "name": "linear_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan/kernel.py:56",
        "launches": scan_launches, "max_abs_err": scan_rec["max_abs_err"],
        "ms": scan_rec["ms"], "plain_ms": scan_rec["plain_ms"],
        "bound_ms": scan_rec["bound_ms"], "bound_by": scan_rec["bound_by"],
        "library_ms": scan_rec["library_ms"],
        "library": scan_rec["library"], "shape": scan_rec["shape"],
        "launches_by_path": _by_path(
            assoc_path=scan_launches, residency_path=res_scan,
            chaos_path=chaos_scan, resume_path=resume_scan)},
        # K3 at the serve path's shape, N(0, 1) inputs: the fp32 design
        # on serve_path, the bf16 (tensor-core) design on serve_path_bf16
        # (and the quickstart's prefill, reduced TinyLlama in fp32 at hd
        # 64, once a layer)
        _flash_entry("flash_attention", fv[("main", torch.float32)],
                     flash_launches, {"serve_path": flash_launches,
                                      "quickstart_path": quick_k3},
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
                     "fa_bf16.cuh"), {
        # K2 redesigned for the Mamba layer: the fused selective scan
        # (JAX's _fused_chunk_scan) at Falcon-Mamba-7B's (8, 2016, 8192,
        # 16) with bf16 xh / bc, which serve_path_mamba launches once a
        # layer of the prefill (and serve_card_vs_cpu's fp32 full-width
        # case once a layer; the training paths once a Mamba layer a
        # gradient, in fp32 with its chunk carries); K2's design at that
        # scan, which it replaced, beside it
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/linear_scan/csrc/"
                  "selective_scan.cu",
        "replaces": "src/repro/kernels/linear_scan/kernel.py:56 on the "
                    "Mamba layer, as src/repro/models/ssm.py:81 "
                    "(_fused_chunk_scan, XLA: no Pallas kernel)",
        "launches": fused_launches_mamba,
        "max_abs_err": fused_rec["max_abs_err"],
        "h_last_bitwise": fused_rec["h_last_bitwise"],
        "ms": fused_rec["ms"], "call_ms": fused_rec["call_ms"],
        "plain_ms": fused_rec["plain_ms"],
        "bound_ms": fused_rec["bound_ms"],
        "bound_by": fused_rec["bound_by"],
        "bound_detail": fused_rec["bound_detail"],
        "library_ms": None, "library": fused_rec["library"],
        "shape": fused_rec["shape"], "dtype": "bfloat16",
        "earlier_design": {
            "kernel": "linear_scan", "case": mamba_rec["case"],
            "ms": mamba_rec["ms"], "bound_ms": mamba_rec["bound_ms"],
            "library_ms": mamba_rec["library_ms"],
            "note": "K2 at (8, 2016, 131072) fp32 coefficients, without "
                    "the coefficient passes and the C-projection the "
                    "fused kernel also does"},
        "launches_by_path": _by_path(
            serve_path_mamba=fused_launches_mamba,
            serve_card_vs_cpu=card_cpu[(MAMBA_ARCH,
                                        "full_width_2_layers")][2],
            train_path_mamba=mamba_ss, train_step_mamba_long=long_ss,
            train_card_vs_cpu=cmp_mamba[3])}, {
        # its backward (recomputing a chunk's states on the SM a stage at
        # a time and walking them in reverse), fp32, at train_path_mamba's
        # scan (8, 128, 8192, 16), one chunk, which it launches once a
        # layer a gradient, and at train_step_mamba_long's (8, 2048, 8192,
        # 16), eight chunks of 256
        "name": "selective_scan_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/linear_scan/csrc/"
                  "selective_scan.cu",
        "entry": "selective_scan_backward_launch",
        "replaces": "src/repro/kernels/linear_scan/kernel.py:56 on the "
                    "Mamba training path, as the gradient of "
                    "src/repro/models/ssm.py:81 (_fused_chunk_scan's "
                    "checkpointed chunk body; XLA's autodiff, no Pallas "
                    "kernel)",
        "launches": mamba_ssb, "max_abs_err": bwd_rec["max_abs_err"],
        "dxh_ddt_dA_bitwise": all(bwd_rec[k] for k in (
            "dxh_bitwise", "ddt_bitwise", "dA_bitwise")),
        "dA_err_per_unit": bwd_rec["dA_err_per_unit"],
        "dbc_err_per_unit": bwd_rec["dbc_err_per_unit"],
        "ms": bwd_rec["ms"], "call_ms": bwd_rec["call_ms"],
        "plain_ms": bwd_rec["plain_ms"], "bound_ms": bwd_rec["bound_ms"],
        "bound_by": bwd_rec["bound_by"],
        "bound_detail": bwd_rec["bound_detail"],
        "design": bwd_rec["design"],
        "library_ms": None, "library": bwd_rec["library"],
        "shape": bwd_rec["shape"], "dtype": "float32",
        "long": {k: bwd_long[k] for k in (
            "shape", "n_chunks", "max_abs_err", "ms", "call_ms", "plain_ms",
            "bound_ms", "bound_by", "bound_share", "design")},
        "launches_by_path": _by_path(
            train_path_mamba=mamba_ssb, train_step_mamba_long=long_ssb,
            train_card_vs_cpu=cmp_mamba[4])}, {
        # K2 at RecurrentGemma-9B's RG-LRU scan, (8, 2016, 4096) fp32:
        # serve_path_rgemma launches it once an RG-LRU layer of the prefill
        "name": "linear_scan_rglru", "route": "cuda",
        "source": "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan/kernel.py:56",
        "launches": scan_launches_rgemma,
        "max_abs_err": rglru_rec["max_abs_err"],
        "ms": rglru_rec["ms"], "plain_ms": rglru_rec["plain_ms"],
        "bound_ms": rglru_rec["bound_ms"],
        "bound_by": rglru_rec["bound_by"],
        "library_ms": rglru_rec["library_ms"],
        "library": rglru_rec["library"], "shape": rglru_rec["shape"],
        "launches_by_path": _by_path(
            serve_path_rgemma=scan_launches_rgemma)},
        # K2 forward and its backward kernel at RecurrentGemma-9B's
        # training scan, (8, 128, 4096) fp32: once an RG-LRU layer a
        # gradient each
        *(_scan_train_entry(name, sv[key], scan_train_by_path[key])
          for name, key in (
              ("linear_scan_rglru_train", "rglru_train"),
              ("linear_scan_backward", "rglru_train_backward"))),
        # K3's head-dim-256 instances at RecurrentGemma-9B's layer 0 (16
        # heads over 1 KV head, window 2048, which 2016 keys do not bind):
        # bf16 on serve_path_rgemma once a superblock of the prefill, fp32
        # on serve_card_vs_cpu's full-width run
        _flash_entry("flash_attention_bf16_hd256",
                     fv[(RGEMMA_CASE, torch.bfloat16)],
                     flash_launches_rgemma,
                     {"serve_path_rgemma": flash_launches_rgemma},
                     "fa_bf16.cuh"),
        _flash_entry("flash_attention_hd256",
                     fv[(RGEMMA_CASE, torch.float32)], flash_launches_hd256,
                     {"serve_card_vs_cpu": flash_launches_hd256},
                     "fa_f32.cuh"),
        # K3's head-dim-112 instances at Kimi-K2's layer 0 (64 heads over 8
        # KV heads): bf16 on serve_path_kimi once a layer of the prefill
        # (serve_path_deepseek, MLA, launches none), fp32 on
        # serve_card_vs_cpu's Kimi cases
        _flash_entry("flash_attention_bf16_hd112",
                     fv[(KIMI_CASE, torch.bfloat16)], flash_launches_kimi,
                     {"serve_path_kimi": flash_launches_kimi,
                      "serve_path_deepseek": flash_launches_deepseek},
                     "fa_bf16.cuh"),
        _flash_entry("flash_attention_hd112",
                     fv[(KIMI_CASE, torch.float32)], flash_launches_hd112,
                     {"serve_card_vs_cpu": flash_launches_hd112},
                     "fa_f32.cuh"),
        # K3 non-causal at Whisper-small's layer-0 encoder q/k/v (12 heads
        # over 12 KV heads, G 1, hd 64, 1536 frames): bf16 on
        # serve_path_whisper once an encoder and once a decoder layer of
        # the prefill (the decoder's causal over its 4 prompt tokens),
        # fp32 on serve_card_vs_cpu's full-size Whisper
        _flash_entry("flash_attention_bf16_whisper_enc",
                     fv[(WHISPER_CASE, torch.bfloat16)],
                     flash_launches_whisper,
                     {"serve_path_whisper": flash_launches_whisper},
                     "fa_bf16.cuh"),
        _flash_entry("flash_attention_whisper_enc",
                     fv[(WHISPER_CASE, torch.float32)],
                     flash_launches_whisper_f32,
                     {"serve_card_vs_cpu": flash_launches_whisper_f32},
                     "fa_f32.cuh"),
        # K3's hd-128 instances at Qwen2-VL-72B's layer 0 (64 heads over 8
        # KV heads), q/k rotated by M-RoPE: bf16 on serve_path_qwen2vl once
        # a layer of the prefill, fp32 on serve_card_vs_cpu's full width
        _flash_entry("flash_attention_bf16_hd128_qwen2vl",
                     fv[(QWEN2VL_CASE, torch.bfloat16)],
                     flash_launches_qwen2vl,
                     {"serve_path_qwen2vl": flash_launches_qwen2vl},
                     "fa_bf16.cuh"),
        _flash_entry("flash_attention_hd128_qwen2vl",
                     fv[(QWEN2VL_CASE, torch.float32)],
                     flash_launches_qwen2vl_f32,
                     {"serve_card_vs_cpu": flash_launches_qwen2vl_f32},
                     "fa_f32.cuh")]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

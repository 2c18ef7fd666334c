"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in this
checkout, holds each against its plain PyTorch version on the card,
drives the main path — ASO-Fed through the cohort engine on
``lstm_regression`` at the paper LSTM's registered width (hidden 64) —
and checks that the main path went through every kernel and that the
card's trajectory agrees with the CPU's.  Prints one JSON line per phase,
then a ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line; without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and fp32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
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
# identical main-path runs, each with its own launch count check: the
# spread of iters/s within one call on one card
MAIN_PATH_REPEATS = 5
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


def _main_path_run(T: int, stats: dict, telemetry=None):
    from repro_torch.core.algorithms import get_strategy
    from repro_torch.sim.engine import run_strategy
    from repro_torch.sim.workloads import get_workload

    wl = get_workload("lstm_regression")
    cfg_model, model = wl.build(hidden=64)
    clients = wl.make_clients(256, seed=0)
    cfg = wl.run_config(T=T, batch_size=32, local_epochs=2,
                        eval_every=256, window=32, seed=0)
    t0 = time.perf_counter()
    hist = run_strategy(get_strategy("asofed"), model, cfg_model, clients,
                        cfg, stats=stats, telemetry=telemetry)
    return hist, time.perf_counter() - t0, cfg_model


def phase_main_path():
    from repro_torch.kernels.feature_attention.kernel import (
        feature_attention_kernel)

    _main_path_run(64, {})  # warm-up: cuBLAS / cuDNN handles, allocator
    rates = []
    for _ in range(MAIN_PATH_REPEATS):
        stats = {}
        feature_attention_kernel.launches = 0
        hist, wall, cfg_model = _main_path_run(512, stats)
        launches = feature_attention_kernel.launches
        if launches != stats["iters"] or stats["iters"] != 512:
            raise AssertionError(
                f"main path: {launches} feature-kernel launches for "
                f"{stats['iters']} folded arrivals (expected one per fold)")
        if not all(math.isfinite(v) for h in hist
                   for v in h.metrics.values()):
            raise AssertionError(f"non-finite eval metrics: {hist}")
        rates.append(stats["iters"] / wall)
        final = hist[-1].metrics
        emit({"phase": "main_path", "workload": "lstm_regression",
              "hidden": cfg_model.hidden,
              "in_features": cfg_model.in_features, "clients": 256,
              "T": 512, "batch_size": 32, "local_epochs": 2, "window": 32,
              "iters": stats["iters"], "ticks": stats["ticks"],
              "windows": stats["windows"], "wall_s": wall,
              "iters_per_s": rates[-1], "device_s": stats["device_s"],
              "host_build_s": stats["host_build_s"],
              "eval_s": stats["eval_s"],
              "peak_device_bytes": stats["peak_device_bytes"],
              "participation_mean": stats.get("participation_mean"),
              "feature_kernel_launches": launches,
              "smape": final["smape"], "mae": final["mae"]})
    q1, med, q3 = np.percentile(rates, [25, 50, 75])
    emit({"phase": "main_path_spread", "runs": len(rates),
          "iters_per_s": rates, "median": med, "iqr": q3 - q1})
    return launches


def phase_profile():
    """Device time by kernel over one main-path run (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    stats = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall, _ = _main_path_run(512, stats)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    key = "self_device_time_total" if events and hasattr(
        events[0], "self_device_time_total") else "self_cuda_time_total"
    per = sorted(((e.key, getattr(e, key, 0.0) / 1e3, e.count)
                  for e in events), key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in per)
    emit({"phase": "profile", "wall_s": wall,
          "device_busy_ms": dev_ms if per else "not measured",
          "device_idle_share": (1.0 - dev_ms / 1e3 / wall) if per
          else "not measured",
          "top_kernels_ms": [[k, ms, n] for k, ms, n in per[:12]]})


def _small_run(name: str, T: int, device: str):
    from repro_torch.core.algorithms import get_strategy
    from repro_torch.sim.engine import run_strategy
    from repro_torch.sim.workloads import get_workload

    wl = get_workload(name)
    cfg_model, model = wl.build(hidden=12)
    cfg = wl.run_config(T=T, batch_size=8, local_epochs=2, eta=0.02,
                        eval_every=30, seed=0)
    trace = []
    hist = run_strategy(get_strategy("asofed"), model, cfg_model,
                        wl.make_clients(5, n_per=60, seed=0), cfg,
                        device=device, trace=trace)
    return hist, trace


def phase_card_vs_cpu():
    for name, T in [("lstm_regression", 60), ("cnn_classification", 30),
                    ("lstm_multilabel", 60)]:
        _, tr_gpu = _small_run(name, T, "cuda")
        _, tr_cpu = _small_run(name, T, "cpu")
        if [t for t, _ in tr_gpu] != [t for t, _ in tr_cpu]:
            raise AssertionError(f"{name}: tick boundaries differ")
        worst, worst_rel = 0.0, 0.0
        for (t, wg), (_, wc) in zip(tr_gpu, tr_cpu):
            for k in wg:
                d = np.abs(wg[k] - wc[k])
                worst = max(worst, float(d.max()))
                excess = d - (TRAJ_ATOL + TRAJ_RTOL * np.abs(wc[k]))
                worst_rel = max(worst_rel, float(excess.max()))
                if not np.all(np.isfinite(wg[k])) or excess.max() > 0:
                    raise AssertionError(
                        f"{name}: card and CPU trajectories differ at "
                        f"t={t} in {k}: max abs diff {float(d.max())}")
        emit({"phase": "card_vs_cpu", "workload": name, "T": T,
              "ticks": len(tr_gpu), "max_abs_diff": worst,
              "atol": TRAJ_ATOL, "rtol": TRAJ_RTOL})


def main() -> int:
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
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision()})
    phase_build()
    kv = phase_kernel_vs_plain()
    launches = phase_main_path()
    phase_profile()
    phase_card_vs_cpu()
    main_rec = kv[((8, 256), torch.float32, True)]
    emit({"kernels": [{
        "name": "feature_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/feature_attention/csrc/"
                  "feature_attention.cu",
        "replaces": "src/repro/kernels/feature_attention/kernel.py:38",
        "launches": launches, "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: find the cell's parts by name, check the card,
run the cell's driver, read the per-layer metrics, check the outputs
and print the result's line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``; its last key, ``checks``, gives each number
compared beside its limit, which also end standard error.  Without a
card, with fewer cards than the cell asks for, without the port, or with
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` loaded once
the window has closed, the run prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# every build and kernel cache of the program, at fixed paths inside the
# checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions"}
CACHE_ROOT = "_bench_cache"


class RunError(Exception):
    """A run that can print no result."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's content
    traffic: dict  # the mix file's content
    limits: dict  # the cell's correctness limits
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str
    t0: float = 0.0  # the run's start, on the host's clock

    def driver(self):
        return importlib.import_module(
            f"perfbench.drivers.{self.traffic['driver']}")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, its parts found by
    name: ``configs`` entry's file, ``perfbench/traffic/<traffic>.json``,
    ``perfbench/limits/<cell>.json``, and the metrics that cover it."""
    manifest = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise RunError(f"no cell {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = os.path.join(root, "perfbench")
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench, "traffic",
                                      f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(bench, "limits", f"{name}.json"))
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer,
                root)


def reader(metric: str, root: str = ROOT) -> Callable:
    """``perfbench/metrics/<metric>.py``'s ``read(ctx)``."""
    path = os.path.join(root, "perfbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that are JAX or its package,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def port_config(cell: Cell, path: str):
    """The port's ModelConfig of the cell's configuration, its depth the
    one held on ``path``; every width the file states is checked against
    the port's."""
    from repro_torch.configs import get_arch

    cfg = cell.config
    port = get_arch(cfg["port_arch"])
    held = cfg["held"][path]
    port = dataclasses.replace(port, n_layers=held["num_hidden_layers"],
                               **cfg.get("port_overrides", {}))
    for field, key in cfg["port_fields"].items():
        have, want = getattr(port, field), cfg[key]
        if have != want:
            raise RunError(f"{cfg['name']}: the port's {field} is {have}, "
                           f"the configuration's {key} {want}")
    return port


def check_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA card: torch.cuda.is_available() is False; "
                       "the benchmark measures on the card only")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are here")


def set_cache_dirs(root: str = ROOT) -> None:
    for var, sub in CACHE_DIRS.items():
        path = os.path.join(root, CACHE_ROOT, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the window's end-to-end values (by
    metric name), its request counts, the numbers compared with their
    limits, the device's peak, and for a traced run the reader context
    (``ctx``) with its ``trace``."""
    values: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]
    memory_peak_bytes: int
    window_start: float
    ctx: Optional[object] = None


def check_value(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit


def result_line(cell: Cell, out: Outcome, trace: bool, setup_s: float,
                device: dict) -> dict:
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"], cell.root)(out.ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = out.ctx.trace
        device = {**device, "busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        vals = {**out.values, "setup_s": setup_s}
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct = out.failed == 0 and all(
        check_value(c["value"], c["limit"]) for c in out.checks.values())
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = {"device_ops": out.ctx.trace.top_ops(),
                             "idle_gaps": out.ctx.trace.idle_gaps()}
    line["checks"] = out.checks
    return line


def device_info(out: Outcome, chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": out.memory_peak_bytes}


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = resolve(args.workload)
        cell.t0 = t_start
        if importlib.util.find_spec("repro_torch") is None:
            raise RunError("the port (repro_torch) is not importable here")
        check_card(cell.chips)
        set_cache_dirs()
        out = cell.driver().run(cell, seed=args.seed, seconds=args.seconds,
                                trace=bool(args.trace), device="cuda")
        loaded = forbidden_loaded()
        if loaded:
            raise RunError(f"modules loaded that the benchmark may not "
                           f"load: {loaded}")
        line = result_line(cell, out, bool(args.trace),
                           out.window_start - t_start,
                           device_info(out, cell.chips))
    except RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    for name, c in out.checks.items():
        ok = "ok" if check_value(c["value"], c["limit"]) else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

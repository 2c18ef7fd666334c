"""CPU tests of the per-layer metrics that read the port's own spans
(``perfbench/port_spans.py``): a traced run of each tiny cell
(``perfbench/tinycells.py``) gives each of its time readers a finite
number, the allocator readers None (no card, no allocator), as many
roots as the run's traced units, and the benchmark's ``pb.`` wrappers
still wrap the loop's functions once an arrival.  No test here imports
JAX."""
import math
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "src"))
                if p not in sys.path]

from perfbench import harness, port_spans, tinycells  # noqa: E402
from perfbench.drivers import fedtrain  # noqa: E402

SEED = 2 ** 31 + 29
TIMES = {"fedtrain": ["host_bound_ms.fedtrain", "grad_wall_ms.fedtrain",
                      "update_wall_ms.fedtrain"],
         "prefill": ["mixer_pass_ms.prefill"]}
ALLOCATOR = ["device_allocs.fedtrain", "alloc_retries.fedtrain"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinycells.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("name", list(tinycells.CELLS))
def test_a_traced_run_reads_the_port_spans(root, name):
    from repro_torch.common import trace

    cell = harness.resolve(name, root)
    out = cell.driver().run(cell, seed=SEED, seconds=0.1, trace=True,
                            device="cpu")
    ctx = out.ctx
    kind = cell.traffic["driver"]
    unit = port_spans.ARRIVAL if kind == "fedtrain" else port_spans.CALL
    roots = [r for r in trace.records() if r.parent is None]
    assert [r.name for r in roots] == [unit] * ctx.units
    listed = {m["name"] for m in cell.per_layer}
    for metric in TIMES[kind]:
        assert metric in listed
        v = harness.reader(metric, root)(ctx)
        assert v is not None and math.isfinite(v) and v > 0, (metric, v)
        print(f"{name}: {metric} {v:.3f} (CPU)")
    if kind == "fedtrain":
        for metric in ALLOCATOR:
            assert metric in listed
            assert harness.reader(metric, root)(ctx) is None
        # the benchmark's own spans still wrap the loop's functions
        wrapped = [n for _, _, n in ctx.trace._spans.r]
        for fn in fedtrain.SPANS:
            assert wrapped.count(fn) == ctx.units, (fn, wrapped)

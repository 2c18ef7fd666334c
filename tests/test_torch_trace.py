"""The port's span recorder (``repro_torch.common.trace``) on the CPU: off
while no profiler session runs (nothing recorded, no event, its cost a
span), on under ``torch.profiler`` (parents, roots, a session's records,
whole roots only, device times the host times), and its spans in the
training loop and the Mamba prefill, which leave every number as it was.
"""
import dataclasses
import gc
import os
import sys
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "src"))
                if p not in sys.path]

from perfbench import tinycells  # noqa: E402
from repro_torch.common import trace  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.lm import federated_token_clients  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARRIVAL_CHILDREN = {"train.draw_batch", "train.local_step", "train.fold",
                    "train.feature_pass", "train.read_loss"}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _end_session():
    with trace.span("off", root=True):
        pass


def test_off_records_nothing_and_creates_no_event(monkeypatch):
    _end_session()
    with _cpu_profile():
        with trace.span("before", root=True):
            pass
    before = trace.records()

    def no_event(*a, **k):
        raise AssertionError("an event created while the recorder is off")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", no_event)
    with trace.span("a.root", root=True):
        with trace.span("a.child") as sp:
            pass
    assert sp is trace.span("other")  # the one shared no-op
    # the session ended, and nothing was added to it
    assert [r.name for r in trace.records()] == [r.name for r in before]
    assert [r.name for r in before] == ["before"]


def test_off_costs_under_5_us_a_span():
    n = 20000
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("x"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    print(f"recorder off: {best * 1e6:.3f} us a span (CPU)")
    # 25 spans an arrival stay under 0.1% of the shortest cell's 166 ms
    assert best < 5e-6


def test_on_records_parents_roots_and_the_latest_session():
    _end_session()
    with _cpu_profile():
        for i in range(2):
            with trace.span("r", root=True):
                with trace.span("a"):
                    with trace.span("b"):
                        time.sleep(0.002)
                with trace.span("c"):
                    pass
    recs = trace.records()
    assert [r.name for r in recs] == ["r", "a", "b", "c"] * 2
    assert [r.parent for r in recs] == [None, 0, 1, 0, None, 4, 5, 4]
    assert [r.root for r in recs] == [0] * 4 + [4] * 4
    for r in recs:
        # on the CPU the device is the host
        root = recs[r.root]
        assert r.device_start_ms == (r.host_start_ns
                                     - root.host_start_ns) / 1e6
        assert r.device_ms == pytest.approx(r.host_ms, abs=1e-9)
        assert r.device_allocs is None and r.alloc_retries is None
        assert r.host_end_ns >= r.host_start_ns
    assert recs[2].host_ms >= 2.0
    assert recs[0].host_ms >= recs[1].host_ms >= recs[2].host_ms
    # a new session clears the records when its first root opens: the
    # records read while the profiler was off ended the last one
    with _cpu_profile():
        with trace.span("s", root=True):
            pass
    assert [r.name for r in trace.records()] == ["s"]
    for name in ("t", "u"):  # nothing ends t's session: the two are one
        with _cpu_profile():
            with trace.span(name, root=True):
                pass
    assert [r.name for r in trace.records()] == ["t", "u"]


def test_a_span_entered_while_off_stays_unrecorded():
    _end_session()
    with _cpu_profile():
        with trace.span("prev", root=True):
            pass
    with trace.span("r", root=True):
        with _cpu_profile():
            with trace.span("a"):  # inside an unrecorded root
                pass
    # the off root ended the session and added nothing to it
    assert [r.name for r in trace.records()] == ["prev"]
    with _cpu_profile():
        with trace.span("orphan"):  # no root open
            pass
        with trace.span("r2", root=True):
            with trace.span("a"):
                pass
            # the new session's first root cleared the records; an open
            # root is not read
            assert trace.records() == []
    assert [r.name for r in trace.records()] == ["r2", "a"]


def _tiny(arch, sizes):
    cfg = dataclasses.replace(get_arch(arch), n_layers=2, **sizes)
    model = build_model(cfg)
    w = model.init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, model, w


# (arch, the tiny cells' port sizes); 2 x 160 tokens a forward, past
# moe.ALL_EXPERTS_MAX_TOKENS, so the MoE layer takes the gathered rows
TRAIN_CASES = [("falcon-mamba-7b", tinycells.MAMBA_PORT),
               ("deepseek-v2-lite-16b", tinycells.MOE_PORT)]


@pytest.mark.parametrize("arch,sizes", TRAIN_CASES)
def test_train_spans_cover_each_arrival_and_change_nothing(arch, sizes):
    cfg, model, w = _tiny(arch, sizes)
    streams = federated_token_clients(3, cfg.vocab_size,
                                      tokens_per_client=4000, seed=0)
    steps = 4
    kw = dict(steps=steps, batch=2, seq=160, device="cpu", log=None)
    plain = train(model, w, streams, **kw)
    _end_session()
    # a garbage collection between two spans would read as uncovered time
    # (a full one takes ~150 ms in a test process that has loaded JAX)
    gc.disable()
    try:
        with _cpu_profile():
            traced = train(model, w, streams, **kw)
    finally:
        gc.enable()
    assert traced["losses"] == plain["losses"]
    want, got = (tree_leaves(r["params"]) for r in (plain, traced))
    assert len(want) == len(got)
    assert all(torch.equal(a, b) for a, b in zip(want, got))

    recs = trace.records()
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["train.arrival"] * steps
    n_mamba = cfg.n_layers if cfg.family == "ssm" else 0
    n_moe = cfg.n_layers - cfg.first_dense_layers \
        if cfg.family == "moe" else 0
    assert n_mamba + n_moe > 0
    for i in roots:
        kids = [r for r in recs if r.parent == i]
        assert {r.name for r in kids} == ARRIVAL_CHILDREN
        covered = sum(r.device_ms for r in kids)
        assert covered >= 0.98 * recs[i].host_ms, (covered, recs[i])
        under = Counter(r.name for r in recs if r.root == i)
        assert under["moe.read_counts"] == n_moe
        for name in ("mamba.conv", "mamba.scan", "mamba.gate"):
            assert under[name] == n_mamba
        for name in ("train.grad", "train.transform", "train.apply"):
            assert under[name] == 1
            (r,) = [r for r in recs if r.root == i and r.name == name]
            assert recs[r.parent].name == "train.local_step"


def test_prefill_spans_each_mamba_layer_once_and_serve_unchanged():
    cfg, model, w = _tiny("falcon-mamba-7b", tinycells.MAMBA_PORT)
    cfg = dataclasses.replace(cfg, n_layers=3)
    model = build_model(cfg)
    w = model.init(torch.Generator().manual_seed(1), device="cpu",
                   dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(2))
    plain, _ = serve(model, w, tokens, 3, device="cpu")
    _end_session()
    with _cpu_profile():
        traced, _ = serve(model, w, tokens, 3, device="cpu")
        traced2, _ = serve(model, w, tokens, 0, device="cpu")
    assert torch.equal(plain, traced)
    assert torch.equal(plain[:, :1], traced2)
    recs = trace.records()
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["serve.call"] * 2
    for i in roots:
        under = Counter(r.name for r in recs if r.root == i)
        # the prefill only: decode's mixer step has no span
        assert under == {"serve.call": 1, "mamba.conv": 3,
                         "mamba.scan": 3, "mamba.gate": 3}

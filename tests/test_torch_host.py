"""The port's copies of the numpy host layer replay the JAX package's
draws exactly: synthetic data bitwise, the async arrival stream event for
event, the staging buffers byte for byte."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import data as jax_data  # noqa: E402
from repro.sim import prefetch as jax_prefetch  # noqa: E402
from repro.sim import profiles as jax_profiles  # noqa: E402
from repro.sim import scheduler as jax_scheduler  # noqa: E402
from repro.sim import traces as jax_traces  # noqa: E402
from repro_torch import data as port_data  # noqa: E402
from repro_torch.sim import prefetch as port_prefetch  # noqa: E402
from repro_torch.sim import profiles as port_profiles  # noqa: E402
from repro_torch.sim import scheduler as port_scheduler  # noqa: E402
from repro_torch.sim import traces as port_traces  # noqa: E402

GENERATORS = [
    ("airquality_like", dict(n_clients=4, n_per=40, seed=3)),
    ("fmnist_like", dict(n_clients=5, scale=0.01, seed=3)),
    ("extrasensory_multilabel_like", dict(n_clients=4, n_per=30, seed=3)),
]


@pytest.mark.parametrize("name,kw", GENERATORS)
def test_synthetic_data_is_bitwise_equal(name, kw):
    want = getattr(jax_data, name)(**kw)
    got = getattr(port_data, name)(**kw)
    assert len(got) == len(want)
    for quad_g, quad_w in zip(got, want):
        for g, w in zip(quad_g, quad_w):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _stream(sched, chunk, n=200):
    out = []
    while len(out) < n:
        tick = sched.next_tick(chunk)
        if not tick:
            break
        out.extend(tick)
    return [(a.cid, a.time, a.delay) for a in out[:n]]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("chunk", [1, 7])
def test_async_scheduler_replays_the_same_stream(traced, chunk):
    data = jax_data.airquality_like(n_clients=12, n_per=20)
    kw = dict(seed=4, dropout_frac=0.25, skip_prob=0.1, init_work=8,
              round_work=16, upload_bytes=1234.0)
    jc = jax_profiles.make_sim_clients(data, seed=1,
                                       bandwidth_range=(1e3, 1e4))
    pc = port_profiles.make_sim_clients(data, seed=1,
                                        bandwidth_range=(1e3, 1e4))
    if traced:
        jc = jax_traces.with_traces(jc, jax_traces.scenario_traces(
            "diurnal", len(jc), seed=2))
        pc = port_traces.with_traces(pc, port_traces.scenario_traces(
            "diurnal", len(pc), seed=2))
    want = _stream(jax_scheduler.AsyncScheduler(jc, **kw), chunk)
    got = _stream(port_scheduler.AsyncScheduler(pc, **kw), chunk)
    assert len(got) == 200
    assert got == want  # cid, simulated time and delay, exactly


def test_tick_builder_stages_the_same_window():
    data = jax_data.airquality_like(n_clients=6, n_per=30)
    blocks = []
    for prof, sched_mod, pre in [
            (jax_profiles, jax_scheduler, jax_prefetch),
            (port_profiles, port_scheduler, port_prefetch)]:
        clients = prof.make_sim_clients(data, seed=0)
        sched = sched_mod.AsyncScheduler(clients, seed=0)
        ticks = sched.peek_window(4, 6)
        sched.commit()
        builder = pre.TickBuilder(
            by_id={c.cid: c for c in clients}, batch_size=5,
            local_epochs=2, scratch=6, pad=6, pooled=False,
            transfer=lambda name, a: a.copy())
        pt = builder.build_window(ticks, t_start=0, window=4,
                                  sim_time=ticks[-1][-1].time)
        blocks.append((pt.arrays, pt.t_end,
                       [dataclasses.astuple(m) for m in pt.ticks_meta]))
    (aw, tw, mw), (ag, tg, mg) = blocks
    assert tg == tw and mg == mw
    for g, w in zip(ag, aw):
        np.testing.assert_array_equal(g, w)

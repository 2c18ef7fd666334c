"""CPU tests of the benchmark's harness: its cells are found from their
files by name, new files are picked up with no edit, the manifest keeps
its contract, the counting functions give PERF.md's bounds, the trace
reduction attributes device time to spans, and a run without a card, or
without the port, prints no result.  No test here imports JAX."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "src"))
                if p not in sys.path]

from perfbench import counting, harness, tinycells, tracing  # noqa: E402
from perfbench.traffic import generator  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    MANIFEST = json.load(_f)
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_from_its_files(name):
    cell = harness.resolve(name)
    assert cell.config["held"] and cell.config["port_fields"]
    assert hasattr(cell.driver(), "run")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.reader(m["name"]))


def test_manifest_keeps_the_contract():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    rs = MANIFEST["run_seconds"]
    assert 1 <= rs <= 51
    # a full check with 24 cells fits in its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [x["name"] for x in
             MANIFEST["configs"] + MANIFEST["workloads"] + metrics]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in MANIFEST["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("perfbench/")
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in metrics:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    root = str(tmp_path)
    tinycells.make_root(root)
    bench = os.path.join(root, "perfbench")
    with open(os.path.join(bench, "metrics", "probe_metric.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.0\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["per_layer"].append({"name": "probe_metric", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "device",
                             "moves": "fedtrain_tokens_per_s",
                             "workloads": ["tiny.fm7b.fedtrain"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    cell = harness.resolve("tiny.fm7b.fedtrain", root)
    assert cell.config["name"] == "tiny-tiny.fm7b.fedtrain"
    assert cell.traffic["batch"] == 2
    assert "probe_metric" in [m["name"] for m in cell.per_layer]
    assert harness.reader("probe_metric", root)(None) == 42.0
    assert harness.resolve("tiny.fm7b.prefill", root).traffic["driver"] \
        == "prefill"


def test_counting_gives_perf_md_bounds():
    # K1 at Qwen2-0.5B's and Falcon-Mamba's embeddings (PERF.md section 6)
    assert counting.feature_pass_bound_s(151936, 896) * 1e3 == \
        pytest.approx(0.3251, abs=5e-5)
    assert counting.feature_pass_bound_s(65024, 4096) * 1e3 == \
        pytest.approx(0.6360, abs=5e-5)
    # the fused backward, the function's own work (PR 29's bound)
    assert counting.scan_bwd_bound_s(8, 128, 8192, 16, 128) * 1e3 == \
        pytest.approx(0.1162, abs=5e-5)
    assert counting.scan_bwd_bound_s(8, 2048, 8192, 16, 256) * 1e3 == \
        pytest.approx(1.8590, abs=5e-5)
    # the fused forward at the prefill: 12 + 15/16 FP32-pipe instructions
    assert counting.scan_fwd_bound_s(8, 2016, 8192, 16, 2) * 1e3 == \
        pytest.approx(0.8164, abs=5e-5)
    assert counting.scan_chunk(2016) == 32 and counting.scan_chunk(128) \
        == 128
    cfg = harness.resolve("fm7b.fedtrain").config
    assert counting.model_matmul(cfg, 4, 128) == (686_817_280, 0.0)


def test_generator_is_seeded_and_non_iid():
    mix = {"clients": 4, "tokens_per_client": 5000, "domains": 4,
           "hubs": 64, "successors": 8, "restart_p": 0.1}
    big = 2 ** 31 + 977
    a = generator.client_streams(1000, mix, big)
    b = generator.client_streams(1000, mix, big)
    c = generator.client_streams(1000, mix, big + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    for k, s in enumerate(a):
        assert s.dtype == np.int32 and s.min() >= 0 and s.max() < 1000
        hub_of, hub_next = generator.domain_chain(1000, k % 4, 64, 8)
        follows = np.mean([s[i + 1] in hub_next[hub_of[s[i]]]
                           for i in range(len(s) - 1)])
        assert 0.87 < follows < 0.93  # restarts at 0.1, some by chance


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_trace_summary_puts_device_time_under_spans():
    ev = [_ev("user_annotation", "pb.local_step", 0, 100),
          _ev("user_annotation", "pb.asofed_transform", 60, 30),
          _ev("cpu_op", "aten::mm", 10, 5),
          _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=1),
          _ev("cuda_runtime", "cudaLaunchKernel", 70, 1, correlation=2),
          _ev("cuda_runtime", "cudaLaunchKernel", 120, 1, correlation=3),
          _ev("kernel", "gemm", 20, 10, correlation=1),
          _ev("kernel", "add", 80, 15, correlation=2),
          _ev("kernel", "feature_attention_rows<float>", 130, 20,
              correlation=3)]
    tr = tracing.TraceSummary(ev, window_s=200e-6)
    assert tr.busy_s == pytest.approx(45e-6)
    assert tr.span_s["local_step"] == pytest.approx(10e-6)
    assert tr.span_s["asofed_transform"] == pytest.approx(15e-6)
    assert tr.span_s[None] == pytest.approx(20e-6)
    assert tr.kernel("feature_attention_rows") == (pytest.approx(20e-6), 1)
    gaps = tr.idle_gaps()
    assert gaps[0][1] == pytest.approx(50e-6)  # 30 -> 80
    assert gaps[0][0].startswith("local_step/")


def _run(args, cwd, env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env.update(env_extra)
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_a_run_without_a_card_fails_with_no_result():
    p = _run(["--workload", "fm7b.fedtrain", "--seed", str(2 ** 31 + 3),
              "--seconds", "1", "--trace", "0"], ROOT,
             {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "no CUDA card" in p.stderr


def test_a_run_in_a_bare_directory_fails_with_no_result(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(tmp_path, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = _run(["--workload", "fm7b.prefill", "--seed", "5", "--seconds", "1",
              "--trace", "0"], str(tmp_path), {})
    assert p.returncode != 0
    assert "{" not in p.stdout

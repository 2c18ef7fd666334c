"""Tiny cells for the CPU tests: the benchmark's own cells cut to a few
thousand parameters, written beside a copy of the benchmark in a
scratch root so that the harness finds them by name as it finds the
real ones.  Their limits are the real cells' own."""
from __future__ import annotations

import json
import os
import shutil

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

MAMBA = {"hidden_size": 64, "intermediate_size": 128, "time_step_rank": 4,
         "vocab_size": 256}
MAMBA_PORT = {"d_model": 64, "ssm_dt_rank": 4, "vocab_size": 256}
MOE = {"hidden_size": 64, "intermediate_size": 96,
       "moe_intermediate_size": 32, "n_routed_experts": 8,
       "num_experts_per_tok": 2, "num_attention_heads": 4,
       "num_key_value_heads": 4, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
       "qk_rope_head_dim": 8, "v_head_dim": 8, "vocab_size": 256}
MOE_PORT = {"d_model": 64, "d_ff": 96, "d_ff_expert": 32, "n_experts": 8,
            "top_k": 2, "n_heads": 4, "n_kv_heads": 4, "kv_lora_rank": 16,
            "qk_nope_head_dim": 8, "qk_rope_head_dim": 8, "v_head_dim": 8,
            "vocab_size": 256}
# tiny cell -> (the real cell it stands for, config changes, held, mix
# changes)
CELLS = {
    "tiny.fm7b.fedtrain": (
        "fm7b.fedtrain", "falcon-mamba-7b", MAMBA, MAMBA_PORT,
        {"train": {"num_hidden_layers": 2, "dtype": "float32"}},
        {"batch": 2, "seq": 16, "tokens_per_client": 2000,
         "warm_arrivals": 2, "min_window_arrivals": 2}),
    "tiny.dsv2l.fedtrain": (
        "dsv2l.fedtrain", "deepseek-v2-lite-16b", MOE, MOE_PORT,
        {"train": {"num_hidden_layers": 2, "dtype": "float32"}},
        {"batch": 2, "seq": 16, "tokens_per_client": 2000,
         "warm_arrivals": 2, "min_window_arrivals": 2}),
    # the embedding scaled up so that the tiny model's logits spread as
    # the full model's do (the gap is in logits)
    "tiny.fm7b.prefill": (
        "fm7b.prefill", "falcon-mamba-7b", MAMBA, MAMBA_PORT,
        {"serve": {"num_hidden_layers": 4, "dtype": "bfloat16",
                   "cooled": {"leaves": ["table"], "scale": 32.0}}},
        {"batch": 2, "prompt_len": 64, "tokens_per_client": 2000,
         "check_prompts": 32, "check_block": 16}),
}


def make_root(dest: str) -> str:
    """A root at ``dest``: BENCHMARK.json and perfbench/ copied, plus
    the tiny cells' configuration, mix and limit files and manifest
    entries.  Returns ``dest``."""
    bench = os.path.join(dest, "perfbench")
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    cells = {w["name"]: w for w in man["workloads"]}
    for name, (real, cfg_name, sizes, port, held, mix) in CELLS.items():
        w = cells[real]
        with open(os.path.join(bench, "configs", f"{cfg_name}.json")) as f:
            cfg = json.load(f)
        tiny_cfg = f"tiny-{name}"
        cfg.update(sizes, name=tiny_cfg, held=held,
                   port_overrides={**cfg.get("port_overrides", {}), **port})
        with open(os.path.join(bench, "configs", f"{tiny_cfg}.json"),
                  "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(bench, "traffic",
                               f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        traffic.update(mix)
        with open(os.path.join(bench, "traffic", f"tiny-{name}.json"),
                  "w") as f:
            json.dump(traffic, f)
        shutil.copy(os.path.join(bench, "limits", f"{real}.json"),
                    os.path.join(bench, "limits", f"{name}.json"))
        man["configs"].append({"name": tiny_cfg, "source": "tiny",
                               "file": f"perfbench/configs/{tiny_cfg}.json",
                               "reduced": [], "why": "CPU test"})
        man["workloads"].append({"name": name, "config": tiny_cfg,
                                 "traffic": f"tiny-{name}", "chips": 1,
                                 "why": "CPU test"})
        for m in man["end_to_end"] + man["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return dest

"""Import hygiene of the port: no module of ``repro_torch`` and nothing
``chip_smoke.py`` or ``train_witness.py`` imports pulls in ``jax`` or the
JAX package, and the port's entry points default to the CUDA card (no
silent CPU fallback)."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HYGIENE = r"""
import importlib, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
sys.path.insert(0, ROOT)
import chip_smoke  # its top-level imports; main() is not run
import train_witness  # the same
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _HYGIENE],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30, out.stdout  # every module of the port was imported
    assert bad == "[]", f"imports reached the JAX side: {bad}"


def test_run_strategy_defaults_to_the_card():
    """Without ``device=`` the engine asks for the CUDA card; on a
    machine with none it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    from repro_torch.core.algorithms import get_strategy
    from repro_torch.sim.engine import run_strategy
    from repro_torch.sim.workloads import get_workload

    wl = get_workload("lstm_regression")
    cfg_model, model = wl.build(hidden=4)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        run_strategy(get_strategy("asofed"), model, cfg_model,
                     wl.make_clients(3, n_per=20, seed=0),
                     wl.run_config(T=4))


def _serve_defaults():
    """Each entry point of the serve path, called without a device."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import main, serve
    from repro_torch.models import build_model, make_batch
    from repro_torch.models.convert import params_from_numpy

    cfg = get_arch("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = make_batch(cfg, 1, 4, device="cpu")["tokens"]
    return {
        "serve": lambda: serve(model, params, tokens, 1),
        "serve_main": lambda: main(["--reduced", "--batch", "1",
                                    "--prompt-len", "4", "--gen", "1"]),
        "Model.init": lambda: model.init(torch.Generator().manual_seed(0)),
        "params_from_numpy": lambda: params_from_numpy(
            {"blocks": {"w": np.zeros((2, 3), np.float32)}}),
        "make_batch": lambda: make_batch(cfg, 1, 4),
        "init_cache": lambda: model.init_cache(1, 8),
    }


@pytest.mark.parametrize("entry", ["serve", "serve_main", "Model.init",
                                   "params_from_numpy", "make_batch",
                                   "init_cache"])
def test_serve_entry_points_default_to_the_card(entry):
    """The serve path's entry points, like ``run_strategy``, run on the
    CUDA card unless given ``device="cpu"`` and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        _serve_defaults()[entry]()


def test_serve_main_runs_on_the_cpu_when_asked():
    from repro_torch.launch.serve import main

    rec = main(["--device", "cpu", "--reduced", "--batch", "2",
                "--prompt-len", "8", "--gen", "3", "--temperature", "0"])
    assert rec["device"] == "cpu" and rec["k3_launches"] == 0
    assert rec["finite_logits"] and rec["batch"] == 2


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result where there
    is no CUDA card, in the repo and copied alone into an empty dir."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    env = _env()
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

"""CPU tests of what decides ``correct``, on tiny cells
(``perfbench/tinycells.py``) held to the real cells' limits: a sound
run of the port is correct; the control (the plain reference in the next
lower precision in the program's place) is not; and a run with the timed
path broken underneath is not, for each fault its cell can have: a step
that returns its state unchanged, half of the batch left out with the
mean over the rest, a token or an answer altered where it is produced,
and, for training, a returning client's slots left as they were.
The harness's look for a card is skipped: the drivers run on the CPU.
No test here imports JAX."""
import contextlib
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "src"))
                if p not in sys.path]

from perfbench import controls, harness, tinycells  # noqa: E402

SEED = 2 ** 31 + 11
TRAIN = ["tiny.fm7b.fedtrain", "tiny.dsv2l.fedtrain"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinycells.make_root(str(tmp_path_factory.mktemp("bench")))


def correct(root, name, seed=SEED):
    cell = harness.resolve(name, root)
    out = cell.driver().run(cell, seed=seed, seconds=0.2, trace=False,
                            device="cpu")
    line = harness.result_line(cell, out, False, 1.0,
                               {"platform": "cpu"})
    return line["correct"], line["checks"]


@pytest.mark.parametrize("name", TRAIN + ["tiny.fm7b.prefill"])
def test_a_sound_run_is_correct(root, name):
    ok, checks = correct(root, name)
    assert ok, checks


@pytest.mark.parametrize("name", TRAIN)
def test_the_tf32_control_is_not_correct(root, name):
    cell = harness.resolve(name, root)
    got = controls.train_gaps(cell, SEED, "cpu", ["tf32"])["tf32"]
    assert any(got[k] > limit for k, limit in cell.limits.items()), got


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fp8_control_is_not_correct(root, seed):
    cell = harness.resolve("tiny.fm7b.prefill", root)
    got = controls.prefill_gap(cell, seed, "cpu", "fp8")
    assert any(got[k] > limit for k, limit in cell.limits.items()), got


@contextlib.contextmanager
def swapped(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged_step(fn):
    def step(model, params, server_params, slots, batch, delay, **kw):
        _, _, loss = fn(model, params, server_params, slots, batch, delay,
                        **kw)
        return params, slots, loss
    return step


def _half_batch_loss(fn):
    def loss(self, params, batch):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return fn(self, params, half)
    return loss


def _altered_label(fn):
    def batches(*args, **kwargs):
        for b in fn(*args, **kwargs):
            b["labels"] = b["labels"].copy()
            b["labels"][0, 0] = (b["labels"][0, 0] + 1) % 256
            yield b
    return batches


def _stale_slots(fn):
    def transform(grads, slots, *args, **kwargs):
        updates, _ = fn(grads, slots, *args, **kwargs)
        return updates, slots
    return transform


def _train_fault(kind):
    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    return {"unchanged": (T, "local_step", _unchanged_step),
            "half_batch": (M.Model, "loss", _half_batch_loss),
            "token": (T, "batches_from_tokens", _altered_label),
            "stale_slots": (T, "asofed_transform", _stale_slots)}[kind]


@pytest.mark.parametrize("fault", ["half_batch", "token", "slots"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_planted_reference_fault_is_not_correct(root, name, fault):
    cell = harness.resolve(name, root)
    got = controls.train_gaps(cell, SEED, "cpu", [fault])[fault]
    assert any(got[k] > limit for k, limit in cell.limits.items()), got


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "token",
                                  "stale_slots"])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_training_step_is_not_correct(root, name, kind):
    with swapped(*_train_fault(kind)):
        ok, checks = correct(root, name)
    assert not ok, checks


def _mixer_unchanged(fn):
    def forward(params, x, cfg, return_state=False):
        out = fn(params, x, cfg, return_state)
        if return_state:
            return torch.zeros_like(out[0]), out[1]
        return torch.zeros_like(out)
    return forward


def _half_batch_prefill(fn):
    def prefill(self, params, batch, max_len=None):
        n = batch["tokens"].shape[0] // 2
        logits, cache = fn(self, params, {"tokens": batch["tokens"][:n]},
                           max_len)
        return torch.cat([logits, logits]), cache
    return prefill


def _altered_token(fn):
    def sample(logits, temperature, generator):
        tok = fn(logits, temperature, generator)
        return (tok + 1) % logits.shape[-1]
    return sample


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "token"])
def test_a_broken_prefill_is_not_correct(root, kind):
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    from repro_torch.models import ssm

    fault = {"unchanged": (ssm, "mamba_forward", _mixer_unchanged),
             "half_batch": (M.Model, "prefill", _half_batch_prefill),
             "token": (S, "_sample", _altered_token)}[kind]
    with swapped(*fault):
        ok, checks = correct(root, "tiny.fm7b.prefill")
    assert not ok, checks


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    """A run of each tiny cell in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or repro (compared whole) is
    loaded, though repro_torch is."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}]\n"
        "from perfbench import harness, tinycells\n"
        f"root = tinycells.make_root({str(tmp_path)!r})\n"
        "for name in tinycells.CELLS:\n"
        "    cell = harness.resolve(name, root)\n"
        "    cell.driver().run(cell, seed=3, seconds=0.1, trace=False,"
        " device='cpu')\n"
        "tops = sorted({m.split('.', 1)[0] for m in sys.modules})\n"
        "print(json.dumps({'forbidden': harness.forbidden_loaded(),"
        " 'tops': tops}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "repro_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["tops"])

"""Quickstart: the ASO-Fed protocol end to end on a reduced TinyLlama.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

The path of the JAX package's ``examples/quickstart.py``: a reduced
TinyLlama, 3 non-IID token-stream clients and 24 asynchronous rounds
(the earliest-finishing client wins each), where the winning client's
local step starts from the server model itself (Eq. 7-11), and the
server folds its delta (Eq. 4) and runs the feature pass (Eq. 5-6);
then prefill and 8 greedy decode steps from the central model.  On the
card each round launches the per-row feature kernel (K1) once, and the
prefill runs the flash-attention kernel (K3) once a layer.
"""
from __future__ import annotations

import argparse
import heapq
import json
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import tree_leaves, tree_sub
from repro_torch.configs import get_arch
from repro_torch.core.feature_learning import apply_feature_learning
from repro_torch.data.lm import batches_from_tokens, federated_token_clients
from repro_torch.launch.train import fold_weight, local_step, server_fold
from repro_torch.models import build_model
from repro_torch.optim.asofed import init_slots

ARCH = "tinyllama-1.1b"
CLIENTS, ROUNDS, SEQ, BATCH = 3, 24, 64, 4
ETA, LAM, BETA = 5e-3, 0.1, 0.001
GEN = 8


def quickstart(init_params=None, *, device=None, log=print
               ) -> Dict[str, Any]:
    """Run the quickstart from ``init_params`` (``None``: the reduced
    model's weights drawn from seed 0 on ``device``).  Returns
    ``losses`` (per round), ``params`` (the central model),
    ``prefill_logits`` ((1, V), the prompt's last-token logits) and
    ``generated`` (the 8 greedy decode tokens)."""
    dev = resolve_device(device)
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    w_server = (model.init(torch.Generator(device=dev).manual_seed(0),
                           device=dev)
                if init_params is None else init_params)
    if log is not None:
        n = sum(t.numel() for t in tree_leaves(w_server))
        log(f"{cfg.name} (reduced): {n/1e6:.1f}M params")

    streams = federated_token_clients(CLIENTS, cfg.vocab_size, 50_000)
    iters = [batches_from_tokens(s, BATCH, SEQ, seed=i)
             for i, s in enumerate(streams)]
    delays = np.random.default_rng(0).uniform(10, 100, CLIENTS)
    slots = [init_slots(w_server) for _ in range(CLIENTS)]
    n_k = np.ones(CLIENTS)
    heap = [(delays[k], k) for k in range(CLIENTS)]
    heapq.heapify(heap)
    losses = []
    for t in range(1, ROUNDS + 1):
        now, k = heapq.heappop(heap)  # earliest-finishing client wins
        batch = {name: torch.from_numpy(v).to(dev)
                 for name, v in next(iters[k]).items()}
        new_w, slots[k], loss = local_step(
            model, w_server, w_server, slots[k], batch,
            float(np.float32(delays[k])), lam=LAM, beta=BETA, eta=ETA)
        n_k[k] += BATCH * SEQ
        with torch.no_grad():
            # Eq. (4): fold this client's delta; Eq. (5)-(6): feature pass
            w_server = server_fold(w_server, tree_sub(w_server, new_w),
                                   fold_weight(n_k, k))
            w_server = apply_feature_learning(w_server, cfg)
        heapq.heappush(heap, (now + delays[k], k))
        losses.append(float(loss))
        if log is not None:
            log(f"round {t:2d}  client {k}  sim_t={now:7.1f}s  "
                f"loss={losses[-1]:.3f}")

    # serve from the central model
    prompt = {"tokens": torch.from_numpy(streams[0][:SEQ])[None].to(dev)}
    with torch.no_grad():
        logits, cache = model.prefill(w_server, prompt, max_len=SEQ + GEN)
        first = logits
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out = []
        for i in range(GEN):
            logits, cache = model.decode_step(
                w_server, cache, tok,
                torch.full((1,), SEQ + i, dtype=torch.int32, device=dev))
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(int(tok[0, 0]))
    if log is not None:
        log(f"generated: {out}")
    return {"losses": losses, "params": w_server, "prefill_logits": first,
            "generated": out}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    res = quickstart(device=dev)
    print(json.dumps({"first_loss": res["losses"][0],
                      "last_loss": res["losses"][-1],
                      "generated": res["generated"]}))
    return res


if __name__ == "__main__":
    main()

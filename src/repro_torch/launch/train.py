"""Federated LLM training: ASO-Fed over K clients on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --reduced --clients 4 --steps 40 --seq 128 --batch 8 [--device cpu]

Mirrors ``repro.launch.train`` (its ``--mesh`` is not ported): K clients
whose local data are non-IID synthetic token streams
(``repro_torch.data.lm``) arrive at the server in an event-driven
asynchronous order, a heap of (simulated time, client) with each
client's delay drawn from U(10, 100).  Each arrival runs the client's
local step (the loss and its gradient, ``asofed_transform``: Eq. 7-11),
the server's Eq. (4) fold of the client's delta weighted by its share of
the samples seen, and the Eq. (5)-(6) feature pass on the first layer
(the token embedding), after which the client pulls the fresh central
model.  ``main`` prints the JAX training script's lines and final JSON.

On the card the loss runs the plain ``blocked_attention`` under
autograd, a Mamba layer's scan one launch of the fused selective scan
and one of its backward kernel a gradient, an RG-LRU layer's one launch
of the recurrence kernel (K2) and one of its backward, and the feature
pass is one launch of the per-row feature kernel (K1) over the (vocab,
d) embedding a fold; ``main`` computes in
fp32 with full-fp32 matrix products (TF32 off).  Every update is out of
place, so a client's parameters and the server snapshot its prox term
reads are the server's tensors of that pull, shared, never written.

Under ``torch.profiler`` each arrival is a ``train.arrival`` span
(``repro_torch.common.trace``) whose children cover it in program
order: ``train.draw_batch``, ``train.local_step`` (``train.grad``,
``train.transform``, ``train.apply``), ``train.fold``,
``train.feature_pass`` and ``train.read_loss``.
"""
from __future__ import annotations

import argparse
import heapq
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.common import trace
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import (tree_leaves, tree_map, tree_sub,
                                       tree_unflatten)
from repro_torch.configs import get_arch
from repro_torch.core.feature_learning import apply_feature_learning
from repro_torch.data.lm import batches_from_tokens, federated_token_clients
from repro_torch.models import Model, build_model
from repro_torch.optim.asofed import AsoFedSlots, asofed_transform, init_slots


def local_step(model: Model, params, server_params, slots: AsoFedSlots,
               batch, delay: float, *, lam: float, beta: float, eta: float):
    """One client round: (new params, new slots, the loss).  The gradient
    of ``model.loss`` at ``params``, the ASO-Fed transform against the
    server snapshot ``server_params``, then ``p + u`` in fp32 cast back to
    each leaf's dtype."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        with trace.span("train.grad"):
            loss, _ = model.loss(p, batch)
            grads = torch.autograd.grad(loss, tree_leaves(p),
                                        allow_unused=True,
                                        materialize_grads=True)
    grads = tree_unflatten(params, list(grads))
    with torch.no_grad():
        with trace.span("train.transform"):
            updates, slots = asofed_transform(
                grads, slots, params, server_params, lam=lam, beta=beta,
                eta=eta, delay=delay)
        with trace.span("train.apply"):
            new = tree_map(
                lambda w, u: (w.to(torch.float32) + u).to(w.dtype),
                params, updates)
    return new, slots, loss.detach()


def server_fold(w, delta, weight: float):
    """Eq. (4): ``w - weight * delta``, leaf by leaf, out of place;
    ``weight`` is taken in fp32, as ``jnp.float32(weight)``."""
    return tree_map(lambda a, d: a - weight * d.to(a.dtype), w, delta)


def fold_weight(n_k: np.ndarray, k: int) -> float:
    """Client k's share of the samples seen, rounded to fp32."""
    return float(np.float32(n_k[k] / n_k.sum()))


def train(model: Model, init_params, streams: Sequence[np.ndarray], *,
          steps: int = 40, batch: int = 8, seq: int = 128,
          eta: float = 3e-3, lam: float = 0.1, beta: float = 0.001,
          feature_learning: bool = True, seed: int = 0, device=None,
          log=print) -> Dict[str, Any]:
    """The asynchronous ASO-Fed loop over one client per token stream,
    from the server weights ``init_params`` (on ``device``; ``None``: the
    CUDA card).  Client i draws its batches with
    ``batches_from_tokens(streams[i], batch, seq, seed=i)``; the delays
    come from ``np.random.default_rng(seed)``.  ``log`` (None: silent)
    gets the JAX training script's progress line at step 1 and every 10th.

    Returns ``losses`` (each step's loss, as a float), ``params`` (the
    final server weights), ``clients`` (the client of each step),
    ``sim_t`` (each step's simulated time), ``step_s`` (each step's wall
    seconds, the local step, fold and feature pass, ended by reading the
    loss) and ``wall_s``."""
    dev = resolve_device(device)
    n = len(streams)
    iters = [batches_from_tokens(s, batch, seq, seed=i)
             for i, s in enumerate(streams)]
    delays = np.random.default_rng(seed).uniform(10.0, 100.0, size=n)
    w_server = init_params
    client_params = [w_server] * n
    client_server_copy = [w_server] * n
    slots = [init_slots(w_server) for _ in range(n)]
    n_k = np.full(n, 1.0)
    heap = [(float(delays[k]), k) for k in range(n)]
    heapq.heapify(heap)
    out: Dict[str, List] = {"losses": [], "clients": [], "sim_t": [],
                            "step_s": []}
    t0 = time.perf_counter()
    for it in range(1, steps + 1):
        with trace.span("train.arrival", root=True):
            ts = time.perf_counter()
            with trace.span("train.draw_batch"):
                now, k = heapq.heappop(heap)
                b = {name: torch.from_numpy(v).to(dev)
                     for name, v in next(iters[k]).items()}
            before = client_params[k]
            # the span holds the call, so the step's frame is freed in it
            with trace.span("train.local_step"):
                new_p, slots[k], loss = local_step(
                    model, before, client_server_copy[k], slots[k], b,
                    float(np.float32(delays[k])), lam=lam, beta=beta,
                    eta=eta)
            with torch.no_grad():
                with trace.span("train.fold"):
                    delta = tree_sub(before, new_p)
                    del new_p
                    n_k[k] += batch * seq
                    w_server = server_fold(w_server, delta,
                                           fold_weight(n_k, k))
                    del delta
                if feature_learning:
                    with trace.span("train.feature_pass"):
                        w_server = apply_feature_learning(w_server,
                                                          model.cfg)
            with trace.span("train.read_loss"):
                # the client pulls the fresh central model
                client_params[k] = w_server
                client_server_copy[k] = w_server
                heapq.heappush(heap, (now + float(delays[k]), k))
                out["losses"].append(float(loss))
                out["step_s"].append(time.perf_counter() - ts)
        out["clients"].append(k)
        out["sim_t"].append(now)
        if log is not None and (it % 10 == 0 or it == 1):
            log(f"iter {it:4d} client {k} loss "
                f"{np.mean(out['losses'][-10:]):.4f} sim_t {now:8.1f}s "
                f"wall {time.perf_counter() - t0:6.1f}s")
    return {**out, "params": w_server, "wall_s": time.perf_counter() - t0}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40, help="global iterations")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--eta", type=float, default=3e-3)
    ap.add_argument("--lam", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=0.001)
    ap.add_argument("--no-feature-learning", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    print(f"arch={cfg.name} reduced={args.reduced} vocab={cfg.vocab_size} "
          f"d={cfg.d_model} L={cfg.n_layers}")

    w_server = model.init(torch.Generator(device=dev).manual_seed(args.seed),
                          device=dev)
    n_params = sum(t.numel() for t in tree_leaves(w_server))
    print(f"params: {n_params/1e6:.2f}M")
    streams = federated_token_clients(
        args.clients, cfg.vocab_size, tokens_per_client=200_000,
        seed=args.seed)
    res = train(model, w_server, streams, steps=args.steps,
                batch=args.batch, seq=args.seq, eta=args.eta, lam=args.lam,
                beta=args.beta,
                feature_learning=not args.no_feature_learning,
                seed=args.seed, device=dev)
    losses = res["losses"]
    if args.checkpoint:
        save_checkpoint(args.checkpoint, res["params"], step=args.steps)
        print("saved checkpoint to", args.checkpoint)
    rec = {"final_loss_avg10": float(np.mean(losses[-10:])),
           "first_loss": losses[0]}
    print(json.dumps(rec))
    return {**rec, **res}


if __name__ == "__main__":
    main()

"""ASO-Fed's asynchronous training loop, plain, for its first arrivals.

What the loop does (Chen et al. 2019, Algorithm 2, as the port's
training CLI runs it), worked out again from the same inputs: client i
of n draws batches of ``seq + 1``-token windows from its stream with
``numpy.random.default_rng(i)``; the clients' delays are
``numpy.random.default_rng(seed).uniform(10, 100, n)`` and they arrive
from a heap of (simulated time, client), each again after its delay.
An arrival takes the gradient g of the loss at the client's model w
(the server model of its last pull), then

* Eq. (7): ``gs = g + lam (w - w_pull)``; Eq. (8)-(10): ``zeta = gs - v
  + h``, ``h <- beta h + (1 - beta) v``, ``v <- gs``;
* Eq. (11): the step ``-r eta``, ``r = max(log(max(dbar, 1e-6)), 1)``
  with ``dbar`` the client's mean delay so far;
* Eq. (4): the server folds ``w - w_new`` weighted by the client's share
  of the samples seen (each client starts at 1, an arrival adds batch x
  seq);
* Eq. (5)-(6): the token embedding's rows reweighted by the softmax of
  their magnitudes, each row's norm kept;

and the client pulls the new server model.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.checks import leaf_norms
from perfbench.reference import models
from perfbench.reference.precision import Precision
from perfbench.weights import flat


def client_batches(tokens: np.ndarray, batch: int, seq: int, seed: int):
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        starts = rng.integers(0, max(n, 1), size=batch)
        x = np.stack([tokens[s:s + seq] for s in starts])
        y = np.stack([tokens[s + 1:s + seq + 1] for s in starts])
        yield x.astype(np.int64), y.astype(np.int64)


def feature_pass(w: torch.Tensor) -> torch.Tensor:
    """Eq. (5)-(6) on each row, its L2 norm restored."""
    out = torch.softmax(w.abs(), -1) * w
    keep = torch.linalg.vector_norm(w, dim=-1, keepdim=True) / torch.clamp(
        torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-12)
    return out * keep


def _unflat(leaves: Dict[str, torch.Tensor]):
    out: Dict = {}
    for path, t in leaves.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return out


FAULTS = ("half_batch", "token", "slots")


def run(w0, streams: List[np.ndarray], sz: Dict, layers: int, mix: Dict,
        seed: int, arrivals: int, precision: str = "fp32",
        fault: Optional[str] = None) -> Dict:
    """The first ``arrivals`` arrivals from the server weights ``w0``
    (read, never written; each leaf taken in fp32).  Returns the loss
    and client of each arrival and, after each arrival, each leaf's norm
    of the server model's change from ``w0`` (``changes``) and of the
    arriving client's ``h`` and ``v`` slots (``slots``); ``grad``, the
    first arrival's gradient as the optimizer took it, is its ``v``.

    A client's ``h`` and ``v`` slots are held only once they differ from
    zero (``None`` until then: ``gs - 0 + 0`` and ``beta 0 + (1 - beta)
    v`` round as the dense sums do), and the update runs leaf by leaf,
    so that the loop holds the start, the server models the clients
    pulled, their ``v`` slots and one gradient.

    ``fault`` plants one of the faults the correctness limits are held
    against: ``half_batch`` takes the loss over the first half of each
    batch, ``token`` alters one label token of each batch where the
    batch is drawn, ``slots`` skips the update of the ``h`` and ``v``
    slots (a returning client steps by ``gs`` alone)."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    P = Precision(precision)
    dev = next(iter(flat(w0).values())).device
    n = len(streams)
    batch, seq = mix["batch"], mix["seq"]
    lam, beta, eta = mix["lam"], mix["beta"], mix["eta"]
    iters = [client_batches(s, batch, seq, i) for i, s in enumerate(streams)]
    delays = np.random.default_rng(seed).uniform(10.0, 100.0, size=n)
    start = {k: v.to(torch.float32) for k, v in flat(w0).items()}
    server = dict(start)
    pulled = [server] * n
    slots = [{"h": None, "v": None, "delay_sum": 0.0, "rounds": 0.0}
             for _ in range(n)]
    n_k = np.full(n, 1.0)
    heap = [(float(delays[k]), k) for k in range(n)]
    heapq.heapify(heap)
    out: Dict = {"losses": [], "clients": [], "changes": [], "slots": []}
    for it in range(arrivals):
        now, k = heapq.heappop(heap)
        x, y = next(iters[k])
        if fault == "half_batch":
            x, y = x[:batch // 2], y[:batch // 2]
        elif fault == "token":
            y = y.copy()
            y[0, 0] = (y[0, 0] + 1) % sz["vocab_size"]
        w, st = pulled[k], slots[k]
        p = {name: t.detach().requires_grad_() for name, t in w.items()}
        with torch.enable_grad():
            lv = models.loss(P, _unflat(p), torch.from_numpy(x).to(dev),
                             torch.from_numpy(y).to(dev), sz, layers)
            grads = list(torch.autograd.grad(lv, list(p.values()),
                                             allow_unused=True))
        names = list(p)
        del p
        delay = float(np.float32(delays[k]))
        dbar = (st["delay_sum"] + delay) / max(st["rounds"] + 1.0, 1.0)
        r = max(float(np.log(max(dbar, 1e-6))), 1.0)
        n_k[k] += batch * seq
        share = float(np.float32(n_k[k] / n_k.sum()))
        v, h = st["v"], st["h"]
        new_v, new_h, new_server = {}, {}, {}
        with torch.no_grad():
            for i, name in enumerate(names):
                g, grads[i] = grads[i], None
                if g is None:
                    g = torch.zeros_like(w[name])
                # Eq. (7): the client's model is the server model it
                # pulled, so the prox term is zero, as in the loop
                gs = g + lam * (w[name] - pulled[k][name])
                del g
                zeta = gs if v is None else gs - v[name]
                if h is not None:
                    zeta = zeta + h[name]
                new_w = w[name] + (-r * eta) * zeta
                del zeta
                new_server[name] = server[name] - share * (w[name] - new_w)
                del new_w
                if fault != "slots":
                    if v is not None:
                        new_h[name] = (beta * h[name] + (1.0 - beta) * v[name]
                                       if h is not None
                                       else (1.0 - beta) * v[name])
                        v[name] = None
                    elif h is not None:
                        new_h[name] = beta * h[name]
                    new_v[name] = gs
                del gs
            if fault != "slots":
                st["v"], st["h"] = new_v, (new_h or None)
            del v, h, new_v, new_h
            st["delay_sum"] += delay
            st["rounds"] += 1.0
            server = new_server
            if mix["feature_learning"]:
                server["embed/table"] = feature_pass(server["embed/table"])
            pulled[k] = server
            heapq.heappush(heap, (now + float(delays[k]), k))
            out["losses"].append(float(lv))
            out["clients"].append(k)
            out["changes"].append(leaf_norms(server, start))
            out["slots"].append({
                key: (leaf_norms(st[key]) if st[key] is not None
                      else dict.fromkeys(names, 0.0)) for key in ("h", "v")})
    out["grad"] = out["slots"][0]["v"]
    return out

"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out, each against its
limit from ``perfbench/limits/<cell>.json``."""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch


def leaf_norms(flat: Dict[str, torch.Tensor], base=None,
               chunk: int = 1 << 26) -> Dict[str, float]:
    """Each leaf's L2 norm (of ``leaf - base[name]`` where ``base`` is
    given), its squares summed in fp64 a chunk of elements at a time."""
    out = {}
    with torch.no_grad():
        for name, t in flat.items():
            v = t.reshape(-1)
            b = None if base is None else base[name].reshape(-1)
            acc = torch.zeros((), dtype=torch.float64, device=t.device)
            for s in range(0, v.numel(), chunk):
                x = v[s:s + chunk].to(torch.float64)
                if b is not None:
                    x = x - b[s:s + chunk].to(torch.float64)
                acc += torch.dot(x, x)
            out[name] = float(acc.sqrt())
    return out


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep: Optional[Iterable[str]] = None
                   ) -> Tuple[float, str]:
    """(the largest ``|prog - ref|`` over ``max(ref, median ref)``, its
    leaf) over the leaves in ``keep`` (default: all)."""
    names = sorted(ref if keep is None else keep)
    med = statistics.median(ref[n] for n in names)
    worst = (0.0, "")
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-300)
        if not gap <= worst[0]:  # NaN counts as worst
            worst = (gap, n)
    return worst


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keep: Iterable[str]) -> float:
    """The median over the leaves in ``keep`` of ``|prog - ref|`` over
    ``max(ref, median ref)``."""
    names = sorted(keep)
    med = statistics.median(ref[n] for n in names)
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-300)
                             for n in names)


def moving_leaves(grad: Dict[str, float], frac: float = 1e-3):
    """Leaves whose reference gradient is not nought to rounding: at
    least ``frac`` of the median leaf's."""
    med = statistics.median(grad.values())
    return [n for n, g in grad.items() if g >= frac * med]


def first_return(clients) -> int:
    """The index of the first arrival whose client arrived before."""
    for i, k in enumerate(clients):
        if k in clients[:i]:
            return i
    raise ValueError(f"no client returns among the arrivals {clients}")


def train_numbers(losses, changes, slots, ref) -> Tuple[Dict, Dict]:
    """The training cells' numbers of one side (the program, a control or
    a fault) against the reference, up to and including the first
    returning arrival ``r`` (``first_return``):

    * ``loss_gap``: the largest relative gap of an arrival's loss;
    * ``grad_gap``: the worst leaf's gap between the norms of the first
      arrival's gradient as the optimizer took it (its ``v`` slot), over
      the reference's norm of that leaf or of the median leaf, whichever
      is larger;
    * ``slot_gap``: the worst leaf's gap, so measured, of the returning
      client's ``h`` and ``v`` slots after its step (Eq. 9-10; the
      worst leaf named with ``h/`` or ``v/``);
    * ``change_gap``: the median leaf's gap, so measured, between the
      norms of the server model's change over arrivals 0-``r``, of the
      leaves the reference's gradient moves (``moving_leaves``).

    ``losses``, ``changes`` (each leaf's norm of the server model's
    change after each arrival) and ``slots`` (each leaf's norm of the
    arriving client's ``h`` and ``v`` after each arrival) hold at least
    ``r + 1`` arrivals; ``ref`` is ``reference.loop.run``'s result.
    Returns (the numbers, what the runs print beside them: each
    arrival's loss gap and median-leaf change gap, the worst leaves, the
    leaves left out)."""
    r = first_return(ref["clients"])
    moving = moving_leaves(ref["grad"])
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    change = [median_leaf_gap(c, rc, moving)
              for c, rc in zip(changes, ref["changes"])]
    grad_gap, grad_leaf = worst_leaf_gap(slots[0]["v"], ref["grad"])
    gh, gv = (worst_leaf_gap(slots[r][k], ref["slots"][r][k])
              for k in ("h", "v"))
    which = "h" if math.isnan(gh[0]) or gh[0] > gv[0] else "v"
    slot_gap, slot_leaf = gh if which == "h" else gv
    worst, worst_leaf = worst_leaf_gap(changes[r], ref["changes"][r], moving)
    numbers = {"loss_gap": max(loss[:r + 1]), "grad_gap": grad_gap,
               "slot_gap": slot_gap, "change_gap": change[r]}
    seen = {"first_return": r, "clients": ref["clients"],
            "loss_gaps": loss, "change_gaps": change,
            "worst_gradient_leaf": [grad_leaf, grad_gap],
            "worst_slot_leaf": [f"{which}/{slot_leaf}", slot_gap],
            "worst_change_leaf": [worst_leaf, worst],
            "left_out": sorted(set(ref["grad"]) - set(moving))}
    return numbers, seen


def entry(value: float, limit: float) -> Dict[str, float]:
    return {"value": value, "limit": limit}

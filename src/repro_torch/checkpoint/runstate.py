"""Full-run crash-resume snapshots for the port's async cohort engine.

The JAX package's layout (``repro.checkpoint.runstate``), so a snapshot
written by either package's engine resumes in the other::

    <path>/stacked-<tag>/  device client-state tree (codec-encoded)
                           — device state residency only
    <path>/pool-<tag>/     host client-state pool (one streamed .npy per
                           storage array) — host state residency only
    <path>/server-<tag>/   device server-state tree
    <path>/run.json        host state: scheduler (rng + heap + fault /
                           retry counters + crashed set), per-client
                           stream rngs, the staleness meter, the
                           (t, sim_time) cursor, ``state_residency`` —
                           and ``snapshot_tag``, the <tag> its
                           directories carry

The device trees ride :func:`repro_torch.checkpoint.save_checkpoint`, so
reduced-dtype client state (bf16, int8, int4 codes) round-trips bit for
bit through the manifest's recorded dtypes.  The host pool streams each
storage array to its own ``.npy`` with ``np.save`` on a file handle: no
second copy of the pool is made in RAM.  ``run.json`` is written last
through an atomic rename and names the directories it pairs with; every
payload lands under fresh step-tagged directories, so a crash at any
point, also halfway through snapshot N+1, leaves ``run.json`` naming
complete directories only (snapshot N's).  Superseded directories are
removed after the rename.

The engine captures the host payload on the producer side before
``peek_window`` (no speculation in flight, no stream draw of the next
window consumed) and writes the snapshot on the consumer side right
before that window dispatches, when every earlier window has scattered
back: so a resumed run replays the remaining arrival stream, and the
final weights, bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Tuple

import numpy as np

from repro_torch.checkpoint.checkpoint import load_checkpoint, save_checkpoint


def _save_pool(path: str, pool, step: int) -> None:
    """Stream the pool's storage arrays to ``<path>/<key>.npy``; a
    ``keys`` manifest makes a partial write detectable at load."""
    os.makedirs(path, exist_ok=True)
    keys = []
    for key, arr in pool.flat_items():
        with open(os.path.join(path, f"{key}.npy"), "wb") as f:
            np.save(f, arr, allow_pickle=False)
        keys.append(key)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": keys}, f)


def _load_pool(path: str, pool) -> None:
    manifest = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest):
        raise FileNotFoundError(
            f"no pool manifest at {path!r} (incomplete snapshot write)")
    with open(manifest) as f:
        keys = json.load(f)["keys"]
    # memory-mapped reads: rows stream into the pool's own arrays without
    # a full-size temporary.  A bf16 leaf the JAX package wrote is raw
    # |V2 bytes; this package's pool holds bf16 as int16 patterns
    arrays = {}
    for k in keys:
        a = np.load(os.path.join(path, f"{k}.npy"), mmap_mode="r")
        arrays[k] = a.view(np.int16) if a.dtype == np.dtype("V2") else a
    pool.load_flat(arrays)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def save_run_state(path: str, stacked, server, host: dict,
                   pool=None) -> int:
    """Write one resumable snapshot and return its bytes on disk (the
    files written here, nothing else under ``path``).  ``host`` must be
    JSON-able and carry at least ``t``.  Under host residency pass the
    run's ``HostStatePool`` as ``pool`` (and ``stacked=None``): the
    device block is derived per window and is not part of the run
    state."""
    os.makedirs(path, exist_ok=True)
    step = int(host.get("t", 0))
    tag = f"{step:012d}"
    if pool is not None:
        client_dir = os.path.join(path, f"pool-{tag}")
        _save_pool(client_dir, pool, step)
    else:
        client_dir = os.path.join(path, f"stacked-{tag}")
        save_checkpoint(client_dir, stacked, step=step)
    server_dir = os.path.join(path, f"server-{tag}")
    save_checkpoint(server_dir, server, step=step)
    tmp = os.path.join(path, "run.json.tmp")
    with open(tmp, "w") as f:
        json.dump(dict(host, snapshot_tag=tag), f)
    os.replace(tmp, os.path.join(path, "run.json"))
    nbytes = (_dir_bytes(client_dir) + _dir_bytes(server_dir)
              + os.path.getsize(os.path.join(path, "run.json")))
    # only after the rename committed the new snapshot: drop superseded
    # directories (a crash before this point leaves them; a crash during
    # it is harmless, run.json already names the new tag)
    for name in os.listdir(path):
        if (name.startswith(("stacked-", "server-", "pool-"))
                and not name.endswith(tag)):
            shutil.rmtree(os.path.join(path, name), ignore_errors=True)
    return nbytes


def load_run_state(path: str, stacked_like, server_like, pool=None,
                   device=None) -> Tuple[Optional[object], object, dict]:
    """``(stacked, server, host)`` restored from :func:`save_run_state`.

    ``stacked_like`` / ``server_like`` give the tree structure (the run's
    freshly initialized state); key mismatches fail fast with
    :func:`load_checkpoint`'s readable diff.  ``device``: where the
    loaded leaves go (None: the devices of the ``*_like`` leaves).

    Under host residency pass the run's freshly initialized ``pool`` (and
    ``stacked_like=None``): its arrays are filled in place and the
    returned ``stacked`` is None.  The residency must match the
    snapshot's (the stored payloads are shaped differently): a mismatch
    raises ``ValueError`` with the JAX package's message.
    """
    run_json = os.path.join(path, "run.json")
    if not os.path.exists(run_json):
        raise FileNotFoundError(
            f"no resumable snapshot at {path!r}: run.json missing "
            "(incomplete or interrupted checkpoint write)")
    with open(run_json) as f:
        host = json.load(f)
    tag = host["snapshot_tag"]
    snap_res = host.get("state_residency", "device")
    want_res = "host" if pool is not None else "device"
    if snap_res != want_res:
        raise ValueError(
            f"state-residency mismatch: snapshot at {path!r} was written "
            f"by a state_residency={snap_res!r} run but this run is "
            f"resuming with state_residency={want_res!r} — rerun with "
            f"RunConfig.state_residency={snap_res!r} (the snapshot stores "
            + ("a host client-state pool, not a device stack"
               if snap_res == "host" else
               "a device stacked state, not a host pool") + ")")
    if pool is not None:
        _load_pool(os.path.join(path, f"pool-{tag}"), pool)
        stacked = None
    else:
        stacked, _ = load_checkpoint(os.path.join(path, f"stacked-{tag}"),
                                     stacked_like, device=device)
    server, _ = load_checkpoint(os.path.join(path, f"server-{tag}"),
                                server_like, device=device)
    return stacked, server, host

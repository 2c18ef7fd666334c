"""Pluggable workloads: model spec + loss + metric bundle + stream factory.

The paper evaluates ASO-Fed across four non-IID streaming tasks; the
engine used to string-switch ``RunConfig.task`` between two hardcoded
metric pairs.  A :class:`Workload` packages everything one benchmark task
needs to run end-to-end through the cohort engine:

* the **architecture** (an ``ARCHS`` name plus the per-task feature /
  output / width overrides),
* the **task** string — the traceable loss selector threaded into
  ``model.loss`` batches (``"regression"`` / ``"classification"`` /
  ``"multilabel"``),
* the **metric bundle** — the host-side ``(preds, targets) -> {metric:
  value}`` reduction the evaluator applies (``repro_torch.sim.evaluation``),
* the **synthetic stream factory** — a ``(n_clients, n_per, seed) ->
  [(x_tr, y_tr, x_te, y_te)]`` generator from ``repro_torch.data``.

Workloads register in :data:`WORKLOADS` (``repro_torch.common.registry``); the
engine, reference oracles, benchmarks, and checkpoint helpers resolve
them by name through :func:`get_workload` — registering a new task is one
decorated factory, no engine edits (README "Workloads" cookbook).

Three workloads ship, mirroring the paper's task spread:

* ``lstm_regression``   — Air-Quality/FitRec-like sensor regression
  (single-layer LSTM, MAE/SMAPE);
* ``cnn_classification``— FashionMNIST-like image classification
  (2-conv CNN, F1/precision/recall/BA/accuracy);
* ``lstm_multilabel``   — ExtraSensory-like multi-label activity
  recognition (LSTM trunk + sigmoid multi-label head,
  micro/macro-F1, subset accuracy, Hamming loss).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.registry import Registry
from repro_torch.sim.evaluation import (ReportFn, classification_report,
                                  multilabel_report, regression_report,
                                  task_report)

Quad = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
DataFn = Callable[..., List[Quad]]

WORKLOADS: Registry["Workload"] = Registry("workload")


@dataclasses.dataclass(frozen=True)
class Workload:
    """One benchmark task, end-to-end: arch + loss selector + metrics +
    synthetic stream factory.

    ``data_seed`` is the generator's paper-pinned default seed (each
    synthetic dataset draws from its own stream so client seeds and data
    seeds never alias); ``default_n_per`` sizes smoke/bench runs.
    """

    name: str
    task: str  # traceable loss selector ("regression"|"classification"|...)
    arch: str  # ARCHS registry name ("paper-lstm" / "paper-cnn")
    in_features: int
    out_features: int
    hidden: int
    data_fn: DataFn  # (n_clients, n_per, seed) -> [(xtr, ytr, xte, yte)]
    eval_report: ReportFn
    headline: str  # the metric column benches/tables lead with
    data_seed: int = 0
    default_n_per: int = 64

    # -- model -----------------------------------------------------------
    def model_config(self, *, hidden: Optional[int] = None):
        from repro_torch.configs import get_arch

        return dataclasses.replace(
            get_arch(self.arch), in_features=self.in_features,
            out_features=self.out_features, hidden=hidden or self.hidden,
        )

    def build(self, *, hidden: Optional[int] = None):
        """(cfg_model, model) for this workload's architecture — the
        port's :class:`repro_torch.models.Model`."""
        from repro_torch.models import build_model

        cfg_model = self.model_config(hidden=hidden)
        return cfg_model, build_model(cfg_model)

    # -- data ------------------------------------------------------------
    def make_data(self, n_clients: int, *, n_per: Optional[int] = None,
                  seed: Optional[int] = None) -> List[Quad]:
        return self.data_fn(
            n_clients=n_clients, n_per=n_per or self.default_n_per,
            seed=self.data_seed if seed is None else seed,
        )

    def make_clients(self, n_clients: int, *, n_per: Optional[int] = None,
                     seed: int = 0, data_seed: Optional[int] = None,
                     traces=None, **kw):
        """SimClients over a fresh synthetic dataset (``seed`` drives the
        device profiles + stream rngs, ``data_seed`` the dataset draw)."""
        from repro_torch.sim.profiles import make_sim_clients

        data = self.make_data(n_clients, n_per=n_per, seed=data_seed)
        return make_sim_clients(data, seed=seed, traces=traces, **kw)

    # -- run config ------------------------------------------------------
    def run_config(self, **kw):
        """A ``RunConfig`` with ``task``/``workload`` wired consistently
        (the engine rejects a mismatched pair)."""
        from repro_torch.sim.engine import RunConfig

        return RunConfig(task=self.task, workload=self.name, **kw)


def get_workload(name: str) -> Workload:
    """Resolve a registered workload by name (KeyError lists known names)."""
    return WORKLOADS.get(name)()


def resolve_eval_report(cfg) -> ReportFn:
    """The metric bundle for a run config: the workload's bundle when
    ``cfg.workload`` names one (validating it against ``cfg.task`` — a
    silent mismatch would train one loss and report another task's
    metrics), else the stock bundle for the bare task string."""
    if getattr(cfg, "workload", None):
        wl = get_workload(cfg.workload)
        if cfg.task != wl.task:
            raise ValueError(
                f"RunConfig.task {cfg.task!r} does not match workload "
                f"{wl.name!r} (task {wl.task!r}); build the config via "
                "Workload.run_config() or set task accordingly")
        return wl.eval_report
    return task_report(cfg.task)


# ---------------------------------------------------------------------------
# The registered workloads
# ---------------------------------------------------------------------------


@WORKLOADS.register("lstm_regression")
def _lstm_regression() -> Workload:
    from repro_torch.data import airquality_like

    def data(n_clients, n_per, seed):
        return airquality_like(n_clients=n_clients, n_per=n_per, seed=seed)

    return Workload(
        name="lstm_regression", task="regression", arch="paper-lstm",
        in_features=8, out_features=1, hidden=8,
        data_fn=data, eval_report=regression_report, headline="smape",
        data_seed=1, default_n_per=24,
    )


@WORKLOADS.register("cnn_classification")
def _cnn_classification() -> Workload:
    from repro_torch.data import fmnist_like

    def data(n_clients, n_per, seed):
        # fmnist's partition recipe hands each client two label shards of
        # mean size ~3000 * scale: map the per-client budget onto scale
        return fmnist_like(n_clients=n_clients, scale=n_per / 6000.0,
                           seed=seed)

    return Workload(
        name="cnn_classification", task="classification", arch="paper-cnn",
        in_features=28 * 28, out_features=10, hidden=8,
        data_fn=data, eval_report=classification_report,
        headline="accuracy", data_seed=3, default_n_per=96,
    )


@WORKLOADS.register("lstm_multilabel")
def _lstm_multilabel() -> Workload:
    from repro_torch.data import extrasensory_multilabel_like

    def data(n_clients, n_per, seed):
        return extrasensory_multilabel_like(
            n_clients=n_clients, n_per=n_per, seed=seed)

    return Workload(
        name="lstm_multilabel", task="multilabel", arch="paper-lstm",
        in_features=32, out_features=6, hidden=8,
        data_fn=data, eval_report=multilabel_report, headline="micro_f1",
        data_seed=2, default_n_per=48,
    )

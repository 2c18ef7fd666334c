"""Batched evaluation for the port's cohort engine.

:class:`Evaluator` holds every client's padded test split as one device
tensor and runs one batched predict over it, then reduces with a
**metric bundle** — a plain ``(preds, targets) -> {name: value}``
function supplied by the run's workload (``repro_torch.sim.workloads``).
The three stock bundles (regression / single-label classification /
multi-label classification) live here, as in ``repro.sim.evaluation``.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

Array = np.ndarray
ReportFn = Callable[[Array, Array], Dict[str, float]]


def regression_report(preds: Array, targets: Array) -> Dict[str, float]:
    """MAE / SMAPE over flattened predictions (paper Table 5.1 columns)."""
    from repro_torch.core import metrics as M

    return M.regression_report(
        preds[..., 0] if preds.ndim > 1 else preds, targets)


def classification_report(preds: Array, targets: Array) -> Dict[str, float]:
    """Single-label F1/precision/recall/BA/accuracy from (n, C) logits."""
    from repro_torch.core import metrics as M

    return M.classification_report(preds, targets)


def multilabel_report(preds: Array, targets: Array) -> Dict[str, float]:
    """Multi-label micro/macro-F1, subset accuracy, Hamming loss from
    (n, C) logits against multi-hot targets."""
    from repro_torch.core import metrics as M

    return M.multilabel_report(preds, targets)


TASK_REPORTS: Dict[str, ReportFn] = {
    "regression": regression_report,
    "classification": classification_report,
    "multilabel": multilabel_report,
}


def task_report(task: str) -> ReportFn:
    """The metric bundle for a bare task string (no workload attached)."""
    if task not in TASK_REPORTS:
        raise ValueError(
            f"unknown task {task!r}; expected one of "
            f"{sorted(TASK_REPORTS)} (or set RunConfig.workload to a "
            "registered workload name)")
    return TASK_REPORTS[task]


class Evaluator:
    """Batched eval in two phases: ``predict_device`` runs one padded
    predict over every client's test split and returns the device tensor
    (no host sync); ``metrics_from`` copies it to the host and reduces it
    with the metric bundle — deferred to the end of the run so eval never
    stalls the tick loop.

    ``per_client`` (Local-S): the params are stacked over the K clients,
    and client k's model predicts client k's test block — still one
    device pass, the paper models' stacked forward over ``(K, n_max,
    ...)``."""

    def __init__(self, model, clients: Sequence, report: ReportFn,
                 device: torch.device, per_client: bool = False):
        self.model = model
        self.report = report
        self.per_client = per_client
        self.lens = [len(c.test_x) for c in clients]
        n_max = max(self.lens)
        K = len(clients)
        self.K = K
        x0 = clients[0].test_x
        X = np.zeros((K * n_max,) + x0.shape[1:], x0.dtype)
        for k, c in enumerate(clients):
            X[k * n_max: k * n_max + self.lens[k]] = c.test_x
        self.n_max = n_max
        self.X = torch.tensor(X, device=device)
        self.targets = np.concatenate([c.test_y for c in clients])

    def predict_device(self, params) -> torch.Tensor:
        """(K, n_max, O) predictions of the central model ``params``, or
        of each client's own row of the stacked ``params``."""
        with torch.no_grad():
            if self.per_client:
                return self.model.predict(params, {"x": self.X.reshape(
                    (self.K, self.n_max) + tuple(self.X.shape[1:]))})
            out = self.model.predict(params, {"x": self.X})
        return out.reshape((self.K, self.n_max) + tuple(out.shape[1:]))

    def metrics_from(self, preds_device: torch.Tensor) -> Dict[str, float]:
        preds = preds_device.cpu().numpy()
        pred = np.concatenate([preds[k, :n] for k, n in enumerate(self.lens)])
        return self.report(pred, self.targets)

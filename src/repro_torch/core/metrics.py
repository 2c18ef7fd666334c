"""Evaluation metrics matching the paper's Table 5.1 columns."""
from __future__ import annotations

import numpy as np


def mae(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.mean(np.abs(pred - target)))


def smape(pred: np.ndarray, target: np.ndarray, eps: float = 1e-8) -> float:
    return float(
        np.mean(np.abs(pred - target) / (np.abs(pred) + np.abs(target) + eps))
    )


def accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    return float(np.mean(np.argmax(logits, -1) == labels))


def _prf(logits: np.ndarray, labels: np.ndarray):
    """Macro precision / recall / F1 over present classes."""
    pred = np.argmax(logits, -1)
    classes = np.unique(labels)
    ps, rs, fs = [], [], []
    for c in classes:
        tp = np.sum((pred == c) & (labels == c))
        fp = np.sum((pred == c) & (labels != c))
        fn = np.sum((pred != c) & (labels == c))
        p = tp / max(tp + fp, 1)
        r = tp / max(tp + fn, 1)
        f = 2 * p * r / max(p + r, 1e-9)
        ps.append(p)
        rs.append(r)
        fs.append(f)
    return float(np.mean(ps)), float(np.mean(rs)), float(np.mean(fs))


def precision(logits, labels) -> float:
    return _prf(logits, labels)[0]


def recall(logits, labels) -> float:
    return _prf(logits, labels)[1]


def f1(logits, labels) -> float:
    return _prf(logits, labels)[2]


def balanced_accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    """Mean per-class recall (the paper's BA)."""
    pred = np.argmax(logits, -1)
    accs = []
    for c in np.unique(labels):
        m = labels == c
        accs.append(np.mean(pred[m] == c))
    return float(np.mean(accs))


def classification_report(logits, labels):
    p, r, f = _prf(logits, labels)
    return {
        "f1": f,
        "precision": p,
        "recall": r,
        "ba": balanced_accuracy(logits, labels),
        "accuracy": accuracy(logits, labels),
    }


def regression_report(pred, target):
    return {"mae": mae(pred, target), "smape": smape(pred, target)}


# ---------------------------------------------------------------------------
# Multi-label classification (ExtraSensory-like workloads): predictions are
# per-class sigmoid decisions over (n, C) logits against multi-hot targets.
# ---------------------------------------------------------------------------


def _multilabel_counts(logits: np.ndarray, targets: np.ndarray):
    pred = logits >= 0.0  # sigmoid(z) >= 0.5 decided in logit space
    tgt = np.asarray(targets) >= 0.5
    tp = np.sum(pred & tgt, axis=0).astype(np.float64)
    fp = np.sum(pred & ~tgt, axis=0).astype(np.float64)
    fn = np.sum(~pred & tgt, axis=0).astype(np.float64)
    return pred, tgt, tp, fp, fn


def _micro_f1(tp, fp, fn) -> float:
    tp_, fp_, fn_ = tp.sum(), fp.sum(), fn.sum()
    return float(2 * tp_ / max(2 * tp_ + fp_ + fn_, 1.0))


def _macro_f1(tgt, tp, fp, fn) -> float:
    present = tgt.any(axis=0)
    if not present.any():
        return 0.0
    f = 2 * tp / np.maximum(2 * tp + fp + fn, 1.0)
    return float(np.mean(f[present]))


def micro_f1(logits: np.ndarray, targets: np.ndarray) -> float:
    """F1 over the pooled per-(sample, class) decisions — dominated by
    frequent labels, robust to classes absent from a client's split."""
    _, _, tp, fp, fn = _multilabel_counts(logits, targets)
    return _micro_f1(tp, fp, fn)


def macro_f1(logits: np.ndarray, targets: np.ndarray) -> float:
    """Mean per-class F1 over classes present in the targets (the
    non-IID-sensitive view: rare activities weigh as much as common ones).
    """
    _, tgt, tp, fp, fn = _multilabel_counts(logits, targets)
    return _macro_f1(tgt, tp, fp, fn)


def subset_accuracy(logits: np.ndarray, targets: np.ndarray) -> float:
    """Fraction of samples whose full label set is predicted exactly."""
    pred, tgt, *_ = _multilabel_counts(logits, targets)
    return float(np.mean(np.all(pred == tgt, axis=-1)))


def hamming_loss(logits: np.ndarray, targets: np.ndarray) -> float:
    """Fraction of wrong per-(sample, class) decisions (lower is better)."""
    pred, tgt, *_ = _multilabel_counts(logits, targets)
    return float(np.mean(pred != tgt))


def multilabel_report(logits, targets):
    # one thresholding + count pass feeds all four metrics
    pred, tgt, tp, fp, fn = _multilabel_counts(logits, targets)
    return {
        "micro_f1": _micro_f1(tp, fp, fn),
        "macro_f1": _macro_f1(tgt, tp, fp, fn),
        "subset_accuracy": float(np.mean(np.all(pred == tgt, axis=-1))),
        "hamming": float(np.mean(pred != tgt)),
    }

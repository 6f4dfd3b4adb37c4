"""Metrics and run-result reporting.

Parity surface of the reference ``src/metrics.py``: ``History`` accumulators
(``:11-21``), ``get_metrics`` acc/f1/precision/recall/auc with binary-vs-macro
dispatch (``:190-202``), and ``save_result``'s text + pickle outputs
(``:171-236``) — without the matplotlib figure factories by default (plots
are optional so headless training never imports a GUI stack).
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class History:
    """Reference ``metrics.History`` fields (``src/metrics.py:11-21``), plus
    ``prob_auc_per_epoch``: AUC scored on class PROBABILITIES (extension —
    the reference's ``auc_per_epoch`` scores hard 0/1 predictions, see
    :func:`prob_scored_auc`; the parity field is unchanged)."""

    errors_per_batch: list = dataclasses.field(default_factory=list)
    error_per_epoch: list = dataclasses.field(default_factory=list)
    nll_per_batch: list = dataclasses.field(default_factory=list)
    nll_per_epoch: list = dataclasses.field(default_factory=list)
    acc_per_epoch: list = dataclasses.field(default_factory=list)
    auc_per_epoch: list = dataclasses.field(default_factory=list)
    combined_acc_auc_per_epoch: list = dataclasses.field(default_factory=list)
    distribution_per_epoch: list = dataclasses.field(default_factory=list)
    prob_auc_per_epoch: list = dataclasses.field(default_factory=list)


def _ratio(num, den):
    """num/den elementwise, 0 where den == 0 (sklearn's ``zero_division=0``)."""
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den > 0)


def precision_recall_f1(y_true, y_pred, average="binary"):
    """(precision, recall, f1) with ``zero_division=0``.

    ``average="binary"`` scores label 1 as the positive class;
    ``"macro"`` averages the per-label scores over every label that occurs
    in ``y_true`` or ``y_pred``.  F1 is ``2·tp / (2·tp + fp + fn)``."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    labels = [1] if average == "binary" else np.union1d(y_true, y_pred)
    scores = []
    for c in labels:
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        scores.append((_ratio(tp, tp + fp), _ratio(tp, tp + fn),
                       _ratio(2 * tp, 2 * tp + fp + fn)))
    return tuple(float(np.mean(s)) for s in zip(*scores))


def binary_auc(y_true, scores):
    """ROC-AUC of ``scores`` for the larger of two labels (rank statistic,
    ties count one half).  Raises ValueError unless ``y_true`` holds exactly
    two labels."""
    y_true = np.asarray(y_true).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.unique(y_true)
    if len(labels) != 2:
        raise ValueError(f"binary AUC needs two labels, got {labels}")
    pos = y_true == labels[1]
    _, inv, counts = np.unique(scores, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]  # average ranks
    n_pos = pos.sum()
    n_neg = len(pos) - n_pos
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def ovr_auc(y_true, probs):
    """Macro one-vs-rest AUC: column c of ``probs`` scores label c.  NaN
    when a label is missing from ``y_true`` (its AUC is undefined)."""
    y_true = np.asarray(y_true).ravel()
    probs = np.asarray(probs, dtype=np.float64)
    per_class = [binary_auc(y_true == c, probs[:, c])
                 if 0 < np.sum(y_true == c) < len(y_true) else np.nan
                 for c in range(probs.shape[1])]
    return float(np.mean(per_class))


def get_metrics(y_true, y_predict, class_titles):
    """acc/f1/precision/recall/auc; binary vs macro by number of classes
    (reference ``get_metrics``, ``src/metrics.py:190-202``; like the
    reference, AUC uses hard predictions and is 0 for multiclass)."""
    y_true = np.asarray(y_true).ravel()
    y_predict = np.asarray(y_predict).ravel()
    acc = float(np.mean(y_true == y_predict))
    if len(class_titles) == 2:
        precision, recall, f1 = precision_recall_f1(y_true, y_predict, "binary")
        auc = _safe_auc(y_true, y_predict)
    else:
        precision, recall, f1 = precision_recall_f1(y_true, y_predict, "macro")
        auc = 0.0
    return acc, f1, precision, recall, auc


def _safe_auc(y_true, scores):
    try:
        return binary_auc(y_true, scores)
    except ValueError:  # single-class y_true
        return 0.0


def prob_scored_auc(y_true, probs):
    """ROC-AUC from class probabilities (flag-free extension).

    The reference scores AUC on HARD 0/1 predictions
    (``src/metrics.py:196`` — for binary labels that equals balanced
    accuracy); probability scoring is the standard ROC protocol and
    strictly more informative.  ``probs``: (B, C) class probabilities —
    binary uses column 1, multiclass macro one-vs-rest over rows
    normalised to sum to 1 (where the reference pins AUC to 0,
    ``src/metrics.py:201``).  0 when ``y_true`` lacks a class.
    """
    y_true = np.asarray(y_true).ravel()
    p = np.asarray(probs, dtype=np.float64)
    try:
        if p.shape[1] == 2:
            out = binary_auc(y_true, p[:, 1])
        else:
            if len(np.unique(y_true)) != p.shape[1]:
                raise ValueError("y_true lacks a class")
            p = p / np.clip(p.sum(axis=1, keepdims=True), 1e-12, None)
            out = ovr_auc(y_true, p)
        return float(out) if np.isfinite(out) else 0.0
    except ValueError:  # single-class y_true / missing classes in y_true
        return 0.0


def accuracy_and_auc(y_true, y_pred):
    """Reference RBM eval pairs accuracy with label-based AUC
    (``src/ClassificationRBM.py:251-294``)."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    return float(np.mean(y_true == y_pred)), _safe_auc(y_true, y_pred)


def get_result_as_txt(
    acc, f1, precision, recall, auc_score, num_classes, input_dim, n_output_nodes,
    n_hidden_nodes, batch_size, epochs, optimizer, learning_rate,
    qpu_time_used="-", beta_eff="-",
):
    """Reference result text format (``src/metrics.py:171-188``)."""
    return (
        f"Accuracy: {acc}\n"
        f"AUC ROC score: {auc_score}\n"
        f"F1 Score: {f1}\n"
        f"Precision: {precision}\n"
        f"Recall: {recall}\n"
        f"Classes: {num_classes}\n"
        f"Input Dimension: {input_dim}\n"
        f"Number of Output Nodes: {n_output_nodes}\n"
        f"Number of Hidden Nodes: {n_hidden_nodes}\n"
        f"Batch Size: {batch_size}\n"
        f"Epochs: {epochs}\n"
        f"Optimizer: {optimizer}\n"
        f"Learning Rate: {learning_rate}\n"
        f"QPU Time Used: {qpu_time_used}\n"
        f"Beta Eff: {beta_eff}\n"
    )


def save_result(
    file_path: str,
    model,
    history: History,
    trained_params,
    y_true,
    y_predict,
    class_titles,
    batch_size,
    epochs,
    optimizer,
    learning_rate,
    qpu_time_used="-",
    save=True,
    make_plots=False,
):
    """One-stop result emitter (reference ``save_result``,
    ``src/metrics.py:205-236``): weights pickle + ``*_result.txt`` +
    ``*acc_auc.pkl`` + history pickles (+ figures when requested)."""
    acc, f1, precision, recall, auc = get_metrics(y_true, y_predict, class_titles)
    # the reference fills the "Classes:" slot with the class-title LIST
    # (``src/metrics.py:209``), not a count — keep result.txt diffable
    result_txt = get_result_as_txt(
        acc, f1, precision, recall, auc,
        class_titles,
        getattr(model, "dim_input", "-"),
        getattr(model, "n_output_nodes", "-"),
        getattr(model, "n_hidden_nodes", "-"),
        batch_size, epochs, optimizer, learning_rate,
        qpu_time_used=qpu_time_used,
        beta_eff=getattr(model, "beta_eff", "-"),
    )
    file_path = str(file_path)
    if save:
        Path(file_path).parent.mkdir(parents=True, exist_ok=True)
        with open(file_path + ".pkl", "wb") as f:
            pickle.dump(trained_params, f)
        with open(file_path + "_result.txt", "w") as f:
            f.write(result_txt)
        save_history(file_path, history)
        with open(file_path + "acc_auc.pkl", "wb") as f:
            pickle.dump((acc, auc), f)
    if make_plots:
        from qbmx.utils import plots

        Path(file_path).parent.mkdir(parents=True, exist_ok=True)
        plots.save_all(file_path, history, y_true, y_predict, class_titles)
    return acc, f1, precision, recall, auc


def save_history(file_path_and_name: str, history: History):
    """Reference per-series history pickles (``src/metrics.py:239-259``)."""
    series = {
        "loss_per_batch.pkl": history.errors_per_batch,
        "loss_per_epoch.pkl": history.error_per_epoch,
        "nll_per_batch.pkl": history.nll_per_batch,
        "nll_per_epoch.pkl": history.nll_per_epoch,
        "acc_per_epoch.pkl": history.acc_per_epoch,
        "auc_per_epoch.pkl": history.auc_per_epoch,
        "combined_acc_auc_per_epoch.pkl": history.combined_acc_auc_per_epoch,
    }
    for name, data in series.items():
        with open(file_path_and_name + name, "wb") as f:
            pickle.dump(data, f)


def load_history(file_path_and_name: str) -> History:
    """Load every series ``save_history`` wrote.  (The reference's version
    crashes — it builds ``History`` with 4 of 7 ctor args,
    ``src/metrics.py:278``; fixed here, SURVEY.md §2c.10.)"""
    names = [
        "loss_per_batch.pkl", "loss_per_epoch.pkl", "nll_per_batch.pkl",
        "nll_per_epoch.pkl", "acc_per_epoch.pkl", "auc_per_epoch.pkl",
        "combined_acc_auc_per_epoch.pkl",
    ]
    loaded = []
    for name in names:
        p = Path(file_path_and_name + name)
        if p.exists():
            with open(p, "rb") as f:
                loaded.append(pickle.load(f))
        else:
            loaded.append([])
    return History(*loaded)

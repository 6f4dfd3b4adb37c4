"""The numpy metrics in ``qbmx.utils.metrics`` against scikit-learn (which
the training path no longer imports): accuracy, binary/macro
precision/recall/F1 with ``zero_division=0``, and rank AUC with ties."""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import pytest

from qbmx.utils import metrics


def _cases(seed, classes, n_max=40, count=60):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        n = int(rng.integers(1, n_max))
        yield rng.integers(0, classes, n), rng.integers(0, classes, n), rng


@pytest.mark.parametrize("classes", [2, 3, 5])
def test_prf_and_accuracy_match_sklearn(classes):
    sk = pytest.importorskip("sklearn.metrics")
    avg = "binary" if classes == 2 else "macro"
    for yt, yp, _ in _cases(classes, classes):
        want = (sk.precision_score(yt, yp, average=avg, zero_division=0),
                sk.recall_score(yt, yp, average=avg, zero_division=0),
                sk.f1_score(yt, yp, average=avg, zero_division=0))
        np.testing.assert_allclose(
            metrics.precision_recall_f1(yt, yp, avg), want, atol=1e-12)
        acc, f1, p, r, _ = metrics.get_metrics(yt, yp, list(range(classes)))
        assert acc == pytest.approx(sk.accuracy_score(yt, yp))
        np.testing.assert_allclose((p, r, f1), want, atol=1e-12)


@pytest.mark.parametrize("rounding", [1, 2, None])
def test_binary_auc_matches_sklearn_with_ties(rounding):
    """Rounded scores create ties (counted one half); hard 0/1 predictions
    are the reference's own AUC input."""
    sk = pytest.importorskip("sklearn.metrics")
    for yt, yp, rng in _cases(10 + (rounding or 0), 2):
        s = rng.random(len(yt))
        s = np.round(s, rounding) if rounding else s
        for score in (s, yp):
            if len(np.unique(yt)) < 2:
                with pytest.raises(ValueError):
                    metrics.binary_auc(yt, score)
                assert metrics.accuracy_and_auc(yt, yp)[1] == 0.0
                continue
            assert metrics.binary_auc(yt, score) == pytest.approx(
                sk.roc_auc_score(yt, score), abs=1e-12)


@pytest.mark.parametrize("classes", [2, 3, 4])
def test_prob_scored_auc_matches_sklearn(classes):
    sk = pytest.importorskip("sklearn.metrics")
    for yt, _, rng in _cases(20 + classes, classes):
        P = rng.random((len(yt), classes))
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                if classes == 2:
                    want = sk.roc_auc_score(yt, P[:, 1])
                else:
                    Pn = P / P.sum(axis=1, keepdims=True)
                    want = sk.roc_auc_score(yt, Pn, multi_class="ovr",
                                            average="macro")
            want = want if np.isfinite(want) else 0.0
        except ValueError:
            want = 0.0
        assert metrics.prob_scored_auc(yt, P) == pytest.approx(want, abs=1e-12)


def test_ovr_auc_matches_sklearn_label_binarize():
    """The CDQBM CLI's multiclass AUC: per-class columns of a one-hot
    target, macro-averaged (NaN when a class is absent)."""
    sk = pytest.importorskip("sklearn.metrics")
    from sklearn.preprocessing import label_binarize

    for yt, _, rng in _cases(30, 3):
        P = rng.random((len(yt), 3))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                want = sk.roc_auc_score(label_binarize(yt, classes=[0, 1, 2]), P,
                                        average="macro")
            except ValueError:
                want = np.nan
        got = metrics.ovr_auc(yt, P)
        assert (np.isnan(got) and np.isnan(want)) or got == pytest.approx(want)


def test_training_path_does_not_import_sklearn():
    import subprocess
    import sys

    code = ("import sys; import qbmx.utils.metrics, qbmx.train.loop, "
            "qbmx.train.sweep, qbmx.cli.qbm_main, qbmx.cli.cdqbm_main; "
            "print('sklearn' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(Path(__file__).resolve().parent.parent))
    assert out.stdout.strip().splitlines()[-1] == "False", out.stderr[-2000:]

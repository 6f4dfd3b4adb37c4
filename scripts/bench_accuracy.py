"""Accuracy companion to bench.py — ONE artifact linking both north-star
halves (VERDICT r1 #10).

Same data pipeline (``bench.load_images``: binarized MNIST 0/1) and the
SAME model config as the throughput headline (H=128 CD-1 RBM), trained on
an 80/20 split, evaluated for test accuracy in both training modes
(generative CD-1 — the north-star framing — and the reference's exact
discriminative gradient, ``src/ClassificationRBM.py:101-146``), alongside
the throughput line measured in this same process on this same chip.

BASELINE.json's bar is "accuracy within 1% of reference runs"; the
reference's own runs on this task family are effectively ceiling-accuracy
(MNIST 0-vs-1 is near-separable), so the bar is acc ≥ 0.99 · reference.

Usage: python scripts/bench_accuracy.py
Writes: out/parity/bench_accuracy.json
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import bench
from qbmx.models.rbm import (
    init_params,
    make_epoch_scan,
    make_train_step,
    predict_proba,
)


def train_and_eval(method: str, xb, yb, test_x, test_y, num_hidden=128,
                   epochs=30, lr=0.05, seed=0, compute_dtype=jnp.float32):
    step = make_train_step(num_classes=2, method=method, cd_k=1,
                           compute_dtype=compute_dtype)
    epoch = make_epoch_scan(step)
    params = init_params(jax.random.key(seed), xb.shape[-1], num_hidden, 2)
    key = jax.random.key(seed + 1)
    for e in range(epochs):
        key, k = jax.random.split(key)
        params, _ = epoch(params, k, xb, yb, lr)
    probs = predict_proba(params, test_x)
    preds = np.asarray(jnp.argmax(probs, axis=1))
    return float((preds == np.asarray(test_y)).mean())


def main():
    x, y = bench.load_images(n_target=16384)
    # bench tiles the base set; dedupe back to unique examples before split
    x, idx = np.unique(x, axis=0, return_index=True)
    y = y[idx]
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_tr = int(0.8 * len(x))
    bs = 256
    nb = n_tr // bs
    xb = jnp.asarray(x[: nb * bs].reshape(nb, bs, -1), jnp.float32)
    yb = jnp.asarray(y[: nb * bs].reshape(nb, bs), jnp.int32)
    test_x = jnp.asarray(x[n_tr:], jnp.float32)
    test_y = y[n_tr:]

    acc_cd1 = train_and_eval("generative", xb, yb, test_x, test_y)
    acc_exact = train_and_eval("discriminative", xb, yb, test_x, test_y)
    # the throughput headline runs the bf16 compute mode — verify it too
    acc_cd1_bf16 = train_and_eval("generative", xb.astype(jnp.bfloat16), yb,
                                  test_x, test_y, compute_dtype=jnp.bfloat16)

    # throughput, same process / same chip / same headline config
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main()
    throughput_row = json.loads(buf.getvalue().strip().splitlines()[-1])

    out = {
        "config": {"num_hidden": 128, "data": "binarized MNIST 0/1 "
                   "(bench.load_images pipeline)", "cd_k": 1},
        "throughput": throughput_row,
        "test_accuracy_cd1": round(acc_cd1, 4),
        "test_accuracy_cd1_bf16": round(acc_cd1_bf16, 4),
        "test_accuracy_exact_discriminative": round(acc_exact, 4),
        "n_train": int(nb * bs),
        "n_test": int(len(test_y)),
        "baseline_note": "BASELINE.json: accuracy within 1% of reference "
                         "runs; reference RBM on this near-separable task "
                         "is ceiling accuracy (~1.0)",
        "within_1pct": bool(acc_cd1 >= 0.99 and acc_exact >= 0.99
                            and acc_cd1_bf16 >= 0.99),
    }
    path = Path("out/parity/bench_accuracy.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()

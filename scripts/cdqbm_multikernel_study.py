"""Multi-kernel CDQBM exact-gradient study (VERDICT r4 #2).

Question: the CDQBM family has never beaten the flat Disc_QBM on MedMNIST
(PARITY.md §4), but every prior variant kept the reference's SINGLE shared
conv kernel (``src/model/cdqbm.py:289-381``).  Does the obvious capacity
lever — multiple conv channels (``--n_kernels``, flag-gated, default 1 =
parity) — change that, or is the family architecturally closed?

Method (same harness as ``cdqbm_breast_exact_study.py``): real 28×28
breastmnist AND pneumoniamnist, EXACT NLL gradients — p(y=1|x) by full
Boltzmann enumeration of the unclamped QUBO (clamped pixels never enter the
QUBO, so real images are enumerable while the hidden stack stays ≤ 15
variables) — Adam, no sampling noise.  Channels are compared BOTH ways:

* widening C at fixed per-channel geometry (7 → 11 → 15 QUBO vars), and
* a MATCHED-BUDGET control at 11 vars (C=2 seq[2] vs C=1 seq[6]): does a
  second channel beat the same variables spent on sequential width?

Flat Disc_QBM rows (h=5 / h=10) anchor the family comparison.

Usage:  JAX_PLATFORMS=cpu python scripts/cdqbm_multikernel_study.py
        (or on a GPU — pure jitted enumeration math)
Writes: out/parity/cdqbm_multikernel_study.md
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
import optax

from qbmx.data import loaders
from qbmx.models.cdqbm import CDQBM
from qbmx.models.dqbm import DiscQBM, unclamped_qubo
from qbmx.samplers.api import GibbsSampler
from qbmx.samplers.exact import exact_boltzmann
from qbmx.utils.metrics import _safe_auc

TRAIN_SUBSAMPLE = 160
STEPS = 300
LR = 0.05


def load_medmnist(name, rng):
    (tr_x, tr_y), _, (te_x, te_y) = loaders.get_medmnist(f"medmnist/{name}.npz")
    keep = []
    for cls in (0, 1):
        idx = np.where(tr_y == cls)[0]
        n = round(TRAIN_SUBSAMPLE * len(idx) / len(tr_y))
        keep.append(rng.choice(idx, size=n, replace=False))
    keep = rng.permutation(np.concatenate(keep))
    return tr_x[keep], tr_y[keep].astype(np.float32), te_x, te_y.astype(np.float32)


def cdqbm_p1(model, params, x_img):
    Q = model.unclamped_qubo(params, x_img)
    _, _, marg, _ = exact_boltzmann(Q, beta=1.0)
    return marg[model.geo.n_hidden]


def dqbm_p1(params, x_flat):
    Q = unclamped_qubo(params, x_flat, 1.0)
    _, _, marg, _ = exact_boltzmann(Q, beta=1.0)
    return marg[0]


def train_exact(p1_fn, params, X, Y, steps=STEPS, lr=LR):
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)

    def loss_fn(p):
        p1 = jax.vmap(lambda x: p1_fn(p, x))(Xj)
        p1 = jnp.clip(p1, 1e-7, 1 - 1e-7)
        return -(Yj * jnp.log(p1) + (1 - Yj) * jnp.log(1 - p1)).mean()

    opt = optax.adam(lr)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        l, g = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(g, s, p)
        return optax.apply_updates(p, updates), s, l

    for _ in range(steps):
        params, state, l = step(params, state)
    return params, float(l)


def eval_metrics(p1_fn, params, X, Y, chunk=64):
    outs = []
    for i in range(0, len(X), chunk):
        outs.append(np.asarray(
            jax.vmap(lambda x: p1_fn(params, x))(jnp.asarray(X[i:i + chunk]))))
    p1 = np.concatenate(outs)
    acc = float(((p1 > 0.5).astype(np.float32) == Y).mean())
    return acc, float(_safe_auc(Y, p1))


def run_cdqbm(name, data, **model_kw):
    Xtr, Ytr, Xte, Yte = data
    m = CDQBM(
        image_shape=(28, 28), num_label_nodes=1, seed=7, sample_count=8,
        sampler=GibbsSampler(num_warmup=2), hidden_bias_type="shared",
        pool_select="absmax", **model_kw,
    )
    assert m.geo.n_total <= 15, f"{name}: {m.geo.n_total} vars too large"
    # signed inputs — the fullstack family config every prior study used
    Xtr, Xte = Xtr * 2.0 - 1.0, Xte * 2.0 - 1.0
    params, nll = train_exact(lambda p, x: cdqbm_p1(m, p, x), m.params, Xtr, Ytr)
    acc_tr, _ = eval_metrics(lambda p, x: cdqbm_p1(m, p, x), params, Xtr, Ytr)
    acc_te, auc_te = eval_metrics(lambda p, x: cdqbm_p1(m, p, x), params, Xte, Yte)
    return dict(name=name, vars=m.geo.n_total, nll=nll,
                acc_train=acc_tr, acc_test=acc_te, auc_test=auc_te)


def run_dqbm(name, data, *, n_hidden, lr=LR):
    Xtr, Ytr, Xte, Yte = data
    m = DiscQBM(dim_input=784, num_classes=2, n_hidden_nodes=n_hidden,
                seed=7, beta_eff=1.0, sampler=GibbsSampler(num_warmup=2))
    flat = lambda X: X.reshape(len(X), -1)
    params, nll = train_exact(dqbm_p1, m.params, flat(Xtr), Ytr, lr=lr)
    acc_tr, _ = eval_metrics(dqbm_p1, params, flat(Xtr), Ytr)
    acc_te, auc_te = eval_metrics(dqbm_p1, params, flat(Xte), Yte)
    return dict(name=name, vars=1 + n_hidden, nll=nll,
                acc_train=acc_tr, acc_test=acc_te, auc_test=auc_te)


DET = dict(kernel_size=7, stride=7, pooling_size=2,
           pooling_type="deterministic")


def variants(data):
    return [
        lambda: run_cdqbm("C=1 k7s7 pool2 seq[2] (parity family)", data,
                          n_kernels=1, sequential_layer_sizes=[2], **DET),
        lambda: run_cdqbm("C=2 k7s7 pool2 seq[2]", data,
                          n_kernels=2, sequential_layer_sizes=[2], **DET),
        lambda: run_cdqbm("C=3 k7s7 pool2 seq[2]", data,
                          n_kernels=3, sequential_layer_sizes=[2], **DET),
        # matched 11-var budget: second channel vs wider sequential layer
        lambda: run_cdqbm("C=1 k7s7 pool2 seq[6] (11-var control)", data,
                          n_kernels=1, sequential_layer_sizes=[6], **DET),
        # channels without the seq bottleneck (pool fed straight to output)
        lambda: run_cdqbm("C=3 k7s7 pool2 seq[] (no seq layer)", data,
                          n_kernels=3, sequential_layer_sizes=[], **DET),
        lambda: run_dqbm("flat Disc_QBM h=5", data, n_hidden=5),
        lambda: run_dqbm("flat Disc_QBM h=10, lr 0.01", data, n_hidden=10,
                         lr=0.01),
    ]


def main():
    out_lines = [
        "# Multi-kernel CDQBM exact-gradient study (VERDICT r4 #2)",
        "",
        f"Stratified {TRAIN_SUBSAMPLE}-image train subsample, full test",
        f"split; exact NLL gradients by Boltzmann enumeration; {STEPS} Adam",
        f"steps, lr {LR}; signed inputs + absmax pooling (the fullstack",
        "family config of PARITY.md §4).  n_kernels=1 rows are the prior",
        "single-kernel family; the flat Disc_QBM rows are the bar.",
    ]
    for ds in ("breastmnist", "pneumoniamnist"):
        rng = np.random.default_rng(0)
        data = load_medmnist(ds, rng)
        maj = float(max((data[3] == 1).mean(), (data[3] == 0).mean()))
        out_lines += [
            "",
            f"## {ds} (majority-class test baseline {maj:.4f} acc / 0.50 AUC)",
            "",
            "| variant | QUBO vars | train NLL | train acc | test acc | test AUC |",
            "|---|---|---|---|---|---|",
        ]
        for i, v in enumerate(variants(data)):
            t0 = time.time()
            r = v()
            line = (f"| {r['name']} | {r['vars']} | {r['nll']:.4f} | "
                    f"{r['acc_train']:.3f} | {r['acc_test']:.3f} | "
                    f"{r['auc_test']:.3f} |")
            out_lines.append(line)
            print(f"[{ds} {i + 1}] {line} ({time.time() - t0:.0f}s)",
                  flush=True)
    out = Path("out/parity/cdqbm_multikernel_study.md")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(out_lines) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

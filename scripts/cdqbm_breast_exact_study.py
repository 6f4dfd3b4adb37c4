"""Exact-enumeration CDQBM-vs-flat-DQBM study on REAL breastmnist (VERDICT r2 #4).

Question: every sampled-path CDQBM run on breastmnist caps at the
majority-class prediction (0.7308 acc / 0.50 AUC) even with the full fix
stack (absmax + signed + grad_clip + repeated re-init,
``out/parity/cdqbm_breast_fullstack_r3.log``).  Is that a training/sampling
artifact, or does the convolutional architecture itself cap there — i.e. is
"the flat Disc_QBM is the right family for noisy MedMNIST" a measurement or
an assertion?

Method: the clamped input image never enters the QUBO — only hidden/pool/
output units do — so REAL 28x28 breastmnist images are directly usable with
full Boltzmann enumeration as long as the hidden stack stays <= ~14
variables.  Train with EXACT NLL gradients (p(y=1|x) by enumeration of the
unclamped QUBO — no sampling noise, no annealing mismatch, no init-basin
luck): whatever exact training cannot reach is an architectural ceiling.
The flat Disc_QBM (``qbmx/models/dqbm.py``) is trained the same way at a
MATCHED QUBO-variable budget (h=5 -> 6 vars, h=10 -> 11 vars, vs the CDQBM
variants' 7-14), so the comparison isolates the model family: dense
per-pixel visible->hidden couplings vs shared conv kernel + pooling
bottleneck.

Reference relation: the reference publishes no CDQBM numbers on any dataset
(SURVEY.md §6) and its flat Disc_QBM is the model behind its MedMNIST
results (``src/qbm_main.py``); this study is the push-beyond evidence for
which family fits noisy MedMNIST tasks.

Usage:  JAX_PLATFORMS=cpu python scripts/cdqbm_breast_exact_study.py
Writes: out/parity/cdqbm_breast_exact_study.md
"""

from __future__ import annotations

import sys
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

TRAIN_SUBSAMPLE = 160  # stratified; full-batch exact grads over 2^14 states
STEPS = 300
LR = 0.05


def load_breast(rng):
    (tr_x, tr_y), _, (te_x, te_y) = loaders.get_medmnist("medmnist/breastmnist.npz")
    # stratified subsample of the train split, preserving the 73/27 imbalance
    keep = []
    for cls in (0, 1):
        idx = np.where(tr_y == cls)[0]
        n = round(TRAIN_SUBSAMPLE * len(idx) / len(tr_y))
        keep.append(rng.choice(idx, size=n, replace=False))
    keep = rng.permutation(np.concatenate(keep))
    return tr_x[keep], tr_y[keep].astype(np.float32), te_x, te_y.astype(np.float32)


# -- exact p(y=1|x) ----------------------------------------------------------


def cdqbm_p1(model, params, x_img):
    Q = model.unclamped_qubo(params, x_img)
    _, _, marg, _ = exact_boltzmann(Q, beta=1.0)
    return marg[model.geo.n_hidden]


def dqbm_p1(params, x_flat):
    Q = unclamped_qubo(params, x_flat, 1.0)
    _, _, marg, _ = exact_boltzmann(Q, beta=1.0)
    return marg[0]  # single output node leads the (out, hidden) layout


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


def metrics(p1_fn, params, X, Y):
    p1 = np.asarray(jax.vmap(lambda x: p1_fn(params, x))(jnp.asarray(X)))
    acc = float(((p1 > 0.5).astype(np.float32) == Y).mean())
    return acc, float(_safe_auc(Y, p1))


def run_cdqbm(name, data, *, signed=False, **model_kw):
    Xtr, Ytr, Xte, Yte = data
    m = CDQBM(
        image_shape=(28, 28), num_label_nodes=1, seed=7, sample_count=8,
        sampler=GibbsSampler(num_warmup=2), hidden_bias_type="shared", **model_kw,
    )
    assert m.geo.n_total <= 15, f"{name}: {m.geo.n_total} vars too large"
    if signed:
        Xtr, Xte = Xtr * 2.0 - 1.0, Xte * 2.0 - 1.0
    params, nll = train_exact(lambda p, x: cdqbm_p1(m, p, x), m.params, Xtr, Ytr)
    acc_tr, _ = metrics(lambda p, x: cdqbm_p1(m, p, x), params, Xtr, Ytr)
    acc_te, auc_te = metrics(lambda p, x: cdqbm_p1(m, p, x), params, Xte, Yte)
    return dict(name=name, vars=m.geo.n_total, nll=nll,
                acc_train=acc_tr, acc_test=acc_te, auc_test=auc_te)


def run_dqbm(name, data, *, n_hidden, lr=LR):
    Xtr, Ytr, Xte, Yte = data
    m = DiscQBM(dim_input=784, num_classes=2, n_hidden_nodes=n_hidden,
                seed=7, beta_eff=1.0, sampler=GibbsSampler(num_warmup=2))
    flat = lambda X: X.reshape(len(X), -1)
    params, nll = train_exact(dqbm_p1, m.params, flat(Xtr), Ytr, lr=lr)
    acc_tr, _ = metrics(dqbm_p1, params, flat(Xtr), Ytr)
    acc_te, auc_te = metrics(dqbm_p1, params, flat(Xte), Yte)
    return dict(name=name, vars=1 + n_hidden, nll=nll,
                acc_train=acc_tr, acc_test=acc_te, auc_test=auc_te)


def main():
    rng = np.random.default_rng(0)
    data = load_breast(rng)
    maj_te = float(max((data[3] == 1).mean(), (data[3] == 0).mean()))

    det = dict(pooling_size=2, pooling_type="deterministic",
               sequential_layer_sizes=[2])
    variants = [
        lambda: run_cdqbm("CDQBM parity (argmin pool, raw)", data,
                          kernel_size=7, stride=7, **det),
        lambda: run_cdqbm("CDQBM absmax + signed (fullstack family)", data,
                          signed=True, pool_select="absmax", kernel_size=7,
                          stride=7, **det),
        lambda: run_cdqbm("CDQBM absmax + signed, k4 (9 windows)", data,
                          signed=True, pool_select="absmax", kernel_size=4,
                          stride=4, **det),
        lambda: run_cdqbm("CDQBM absmax + signed, k4, seq[4]", data,
                          signed=True, pool_select="absmax", kernel_size=4,
                          stride=4, pooling_size=2,
                          pooling_type="deterministic",
                          sequential_layer_sizes=[4]),
        lambda: run_cdqbm("CDQBM no pooling, k9, signed", data,
                          signed=True, kernel_size=9, stride=9, pooling_size=0,
                          pooling_type="deterministic",
                          sequential_layer_sizes=[2]),
        lambda: run_cdqbm("CDQBM prob pooling, LEARNED pen, k9, signed", data,
                          signed=True, kernel_size=9, stride=9, pooling_size=2,
                          pooling_type="probabilistic",
                          sequential_layer_sizes=[2], learn_penalty=True),
        lambda: run_dqbm("flat Disc_QBM h=5 (production config)", data,
                         n_hidden=5),
        lambda: run_dqbm("flat Disc_QBM h=10", data, n_hidden=10),
        # h=10 diverges at the shared lr 0.05 (784x10 couplings blow up:
        # train NLL 4.28, stuck at majority) — that is an optimizer
        # artifact, not an architecture measurement; rerun at a stable lr
        lambda: run_dqbm("flat Disc_QBM h=10, lr 0.01", data, n_hidden=10,
                         lr=0.01),
    ]
    rows = []
    for i, v in enumerate(variants):
        import time
        t0 = time.time()
        r = v()
        rows.append(r)
        print(f"[{i + 1}/{len(variants)}] {r['name']}: vars={r['vars']} "
              f"test acc {r['acc_test']:.3f} auc {r['auc_test']:.3f} "
              f"({time.time() - t0:.0f}s)", flush=True)

    lines = [
        "# CDQBM vs flat DQBM on REAL breastmnist — exact-enumeration study",
        "",
        f"Real 28x28 breastmnist (stratified {TRAIN_SUBSAMPLE}-image train subsample,",
        "full 156-image test split); EXACT NLL gradients — p(y=1|x) by full",
        "Boltzmann enumeration of the unclamped QUBO (clamped pixels never enter",
        f"the QUBO, so real images are enumerable); {STEPS} Adam steps, lr {LR}.",
        f"Majority-class test baseline: **{maj_te:.4f}** acc / 0.50 AUC.",
        "AUC is probability-scored from the exact p(y=1|x).",
        "",
        "| variant | QUBO vars | train NLL | train acc | test acc | test AUC |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['vars']} | {r['nll']:.4f} | {r['acc_train']:.3f} "
            f"| {r['acc_test']:.3f} | {r['auc_test']:.3f} |"
        )
        print(lines[-1], flush=True)
    out = Path("out/parity/cdqbm_breast_exact_study.md")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

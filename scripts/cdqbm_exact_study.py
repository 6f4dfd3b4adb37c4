"""Exact-enumeration capacity study of the CDQBM (VERDICT r1 #2).

Question: does the reference architecture's deterministic argmin pooling
(``src/model/layers.py:65-84``) cap discriminative power, or does qbmx have
a builder bug?  (The builder is now proven element-wise identical to the
reference's — ``tests/test_ref_builder_parity.py`` — so any cap is the
architecture's.)

Method: tiny CDQBMs (≤14 QUBO variables) on a cleanly separable bars task,
trained with EXACT gradients — p(y|x) computed by full Boltzmann
enumeration of the unclamped QUBO (no sampling noise, no annealing
mismatch), NLL minimized with Adam.  Whatever accuracy exact training
cannot reach is an architectural ceiling, not a training artifact.

Variants compared (all flag-gated in qbmx, defaults = reference parity):
  * parity           — deterministic argmin pooling on raw [0,1] inputs
  * signed-input     — same model, inputs remapped to {-1,+1}
  * center-fmap      — per-image zero-mean feature map before pooling
  * absmax-pool      — pick the strongest-|response| unit per window
  * probabilistic    — reference's penalty-based pooling
  * no-pooling       — all conv units in the QUBO

Also reports the input-sensitivity of the pooled conv biases (std across
the dataset, averaged over windows): the mechanism by which argmin pooling
on non-negative fmaps erases input information.

Usage:  JAX_PLATFORMS=cpu python scripts/cdqbm_exact_study.py
Writes: out/parity/cdqbm_exact_study.md
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax

from qbmx.models.cdqbm import CDQBM
from qbmx.samplers.api import GibbsSampler
from qbmx.samplers.exact import exact_boltzmann


def make_bars(rng, n_per_class=40, side=6, noise=0.05):
    """Horizontal-bar (y=0) vs vertical-bar (y=1) images with pixel noise."""
    X, Y = [], []
    for y in (0, 1):
        for _ in range(n_per_class):
            img = np.zeros((side, side), dtype=np.float32)
            pos = rng.integers(0, side)
            if y == 0:
                img[pos, :] = 1.0
            else:
                img[:, pos] = 1.0
            flip = rng.uniform(size=img.shape) < noise
            img = np.where(flip, 1.0 - img, img)
            X.append(img)
            Y.append(y)
    idx = rng.permutation(len(X))
    return np.stack(X)[idx], np.asarray(Y, np.float32)[idx]


def exact_p1(model, params, x_img, beta=1.0):
    """Exact Boltzmann p(y=1|x) of the unclamped QUBO (binary label node)."""
    Q = model.unclamped_qubo(params, x_img)
    _, _, marg, _ = exact_boltzmann(Q, beta=beta)
    return marg[model.geo.n_hidden]  # the single output variable


def train_exact(model, X, Y, steps=400, lr=0.05, beta=1.0, seed=0):
    params = model.params
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)

    def loss_fn(p):
        p1 = jax.vmap(lambda x: exact_p1(model, p, x, beta))(Xj)
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


def evaluate(model, params, X, Y, beta=1.0):
    p1 = jax.vmap(lambda x: exact_p1(model, params, jnp.asarray(x), beta))(jnp.asarray(X))
    pred = (np.asarray(p1) > 0.5).astype(np.float32)
    return float((pred == Y).mean())


def pooled_bias_sensitivity(model, params, X):
    """Std across the dataset of each conv-diagonal bias, averaged — the
    amount of input information the QUBO actually carries in its conv block."""

    def biases(x):
        fmap, pooled, _ = model._context(params, jnp.asarray(x))
        return model._conv_linear_terms(params, fmap, pooled)

    b = np.asarray(jax.vmap(biases)(jnp.asarray(X)))  # (N, conv_active)
    return float(b.std(axis=0).mean())


def run_variant(name, X, Y, Xt, Yt, *, signed=False, steps=400, **model_kw):
    m = CDQBM(
        image_shape=X.shape[1:], num_label_nodes=1, seed=7,
        sample_count=8, sampler=GibbsSampler(num_warmup=2), **model_kw,
    )
    n_total = m.geo.n_total
    assert n_total <= 16, f"{name}: {n_total} vars too large for enumeration"
    Xs = X * 2.0 - 1.0 if signed else X
    Xts = Xt * 2.0 - 1.0 if signed else Xt
    params, nll = train_exact(m, Xs, Y, steps=steps)
    acc_tr = evaluate(m, params, Xs, Y)
    acc_te = evaluate(m, params, Xts, Yt)
    sens = pooled_bias_sensitivity(m, params, Xs)
    return dict(name=name, vars=n_total, nll=nll, acc_train=acc_tr,
                acc_test=acc_te, sensitivity=sens)


def main():
    rng = np.random.default_rng(0)
    X, Y = make_bars(rng, n_per_class=40)
    Xt, Yt = make_bars(rng, n_per_class=40)

    det = dict(kernel_size=3, pooling_size=2, pooling_type="deterministic",
               sequential_layer_sizes=[2], hidden_bias_type="shared")
    rows = [
        run_variant("parity (argmin pool, raw input)", X, Y, Xt, Yt, **det),
        run_variant("signed input (x→2x−1)", X, Y, Xt, Yt, signed=True, **det),
        run_variant("center_fmap=True", X, Y, Xt, Yt, center_fmap=True, **det),
        run_variant("pool_select=absmax", X, Y, Xt, Yt, pool_select="absmax", **det),
        run_variant("absmax + signed", X, Y, Xt, Yt, signed=True,
                    pool_select="absmax", **det),
        run_variant(
            "probabilistic pooling", X, Y, Xt, Yt,
            kernel_size=4, pooling_size=2, pooling_type="probabilistic",
            sequential_layer_sizes=[2], hidden_bias_type="shared",
        ),
        run_variant(
            "no pooling", X, Y, Xt, Yt,
            kernel_size=4, pooling_size=0, pooling_type="deterministic",
            sequential_layer_sizes=[2], hidden_bias_type="shared",
        ),
    ]
    # penalty-strength sweep: the reference hardcodes 0.8225 — how much of
    # the probabilistic-pooling cap is a weakly-binding penalty?
    for pen in (0.25, 2.0, 5.0, 10.0):
        rows.append(run_variant(
            f"prob pooling, penalty={pen}", X, Y, Xt, Yt,
            kernel_size=4, pooling_size=2, pooling_type="probabilistic",
            sequential_layer_sizes=[2], hidden_bias_type="shared",
            prob_penalty=pen,
        ))
    # per-window LEARNED penalties (ROADMAP r2 lead): pen becomes a trained
    # parameter vector — exact gradients flow through the penalty basis
    for pen0 in (0.8225, 5.0):
        rows.append(run_variant(
            f"prob pooling, LEARNED per-window pen (init={pen0})", X, Y, Xt, Yt,
            kernel_size=4, pooling_size=2, pooling_type="probabilistic",
            sequential_layer_sizes=[2], hidden_bias_type="shared",
            prob_penalty=pen0, learn_penalty=True,
        ))
    rows.append(run_variant(
        "prob pooling, LEARNED pen + signed input", X, Y, Xt, Yt, signed=True,
        kernel_size=4, pooling_size=2, pooling_type="probabilistic",
        sequential_layer_sizes=[2], hidden_bias_type="shared",
        prob_penalty=0.8225, learn_penalty=True,
    ))

    lines = [
        "# CDQBM exact-enumeration capacity study",
        "",
        "Bars task (6×6, horizontal vs vertical, 5% pixel noise, 80 train / 80 test);",
        "exact NLL gradients (full Boltzmann enumeration of the unclamped QUBO),",
        "400 Adam steps. `sensitivity` = std across the dataset of the conv-block",
        "QUBO biases (how much input information the QUBO carries), mean over units.",
        "",
        "| variant | QUBO vars | train NLL | train acc | test acc | bias sensitivity |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['vars']} | {r['nll']:.4f} | {r['acc_train']:.3f} "
            f"| {r['acc_test']:.3f} | {r['sensitivity']:.4f} |"
        )
        print(lines[-1])
    out = Path("out/parity/cdqbm_exact_study.md")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

"""Discriminative RBM, in JAX.

Capability parity with the reference ``ClassificationRBM``
(``src/ClassificationRBM.py``): a Larochelle-style discriminative RBM over
(visible, hidden, class) units with

  * the **exact** discriminative gradient — the reference's training path
    (``discriminative_training``, ``src/ClassificationRBM.py:101-146``; its
    ``k`` parameter is stored but never used, SURVEY.md §2c.1).  Here the
    closed-form conditional ``p(y|x)`` is differentiated with ``jax.grad``,
    which is mathematically identical to the reference's hand-derived
    positive/negative phase (the loss is an explicit function of params).
  * a **CD-k / PCD generative** path (Gibbs chains with on-device PRNG) —
    the north-star extension (BASELINE.json: "CD-1 RBM training on binarized
    MNIST ≥ 100k images/sec/chip") plus a hybrid objective mixing both.

Everything is jitted; ``train_epoch_scan`` runs a whole epoch as one
``lax.scan`` on device for maximum throughput.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RBMParams:
    weights: jax.Array  # (V, H)
    visible_bias: jax.Array  # (V,)
    hidden_bias: jax.Array  # (H,)
    class_bias: jax.Array  # (C,)
    class_weights: jax.Array  # (C, H)


def init_params(key: jax.Array, num_visible: int, num_hidden: int, num_classes: int) -> RBMParams:
    """Reference init (``src/ClassificationRBM.py:26-30``): weights ~
    0.1·N(0,1); visible bias 0.5; hidden/class biases and class weights 0."""
    return RBMParams(
        weights=0.1 * jax.random.normal(key, (num_visible, num_hidden), jnp.float32),
        visible_bias=0.5 * jnp.ones((num_visible,), jnp.float32),
        hidden_bias=jnp.zeros((num_hidden,), jnp.float32),
        class_bias=jnp.zeros((num_classes,), jnp.float32),
        class_weights=jnp.zeros((num_classes, num_hidden), jnp.float32),
    )


# ---------------------------------------------------------------------------
# Exact discriminative path
# ---------------------------------------------------------------------------


def class_logits(params: RBMParams, x: jax.Array) -> jax.Array:
    """log p(y|x) + const for a batch: (B, C).

    ``logit_y = d_y + Σ_j softplus(c_j + x·W_j + U_yj)`` — the exact
    free-energy form the reference computes with Python loops over classes
    and hidden units (``sample_class_given_x``,
    ``src/ClassificationRBM.py:62-86``), here one broadcasted softplus.
    """
    pre = x @ params.weights + params.hidden_bias  # (B, H)
    act = pre[:, None, :] + params.class_weights[None, :, :]  # (B, C, H)
    return params.class_bias[None, :] + jax.nn.softplus(act).sum(axis=-1)


def predict_proba(params: RBMParams, x: jax.Array) -> jax.Array:
    return jax.nn.softmax(class_logits(params, x), axis=-1)


def discriminative_nll(params: RBMParams, x: jax.Array, y: jax.Array) -> jax.Array:
    logits = class_logits(params, x)
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.take_along_axis(logp, y[:, None].astype(jnp.int32), axis=1).mean()


# ---------------------------------------------------------------------------
# Generative CD-k path
# ---------------------------------------------------------------------------


def _hidden_prob(params, v, y_onehot):
    return jax.nn.sigmoid(v @ params.weights + params.hidden_bias + y_onehot @ params.class_weights)


def _visible_prob(params, h):
    return jax.nn.sigmoid(h @ params.weights.T + params.visible_bias)


def _class_prob(params, h):
    return jax.nn.softmax(h @ params.class_weights.T + params.class_bias, axis=-1)


def cd_stats(params: RBMParams, key, v0, y_onehot, k: int, v_init=None, y_init=None,
             compute_dtype=jnp.float32, persistent: bool = False):
    """CD-k positive/negative statistics.

    Returns ``(pos, neg, (vk, yk), recon)``: (pos, neg) are
    RBMParams-shaped expected sufficient statistics (batch-meaned, always
    float32), (vk, yk) is the final chain state for PCD, and ``recon`` is
    the visible reconstruction probability of the last step (a free
    reconstruction-error signal for the caller).

    Standard Hinton recipe (*A Practical Guide to Training RBMs*, §3):
    binary hidden samples drive the chain; the FINAL update is mean-field —
    the visible/class reconstructions enter the negative statistics as
    probabilities, not samples, and the paired hidden term is the
    probability computed from them.  Intermediate chain steps (k > 1)
    sample everything.  Besides the variance reduction, skipping the final
    visible/class draws removes ~6/7 of the RNG work of CD-1 (784 visible
    bits vs 128 hidden bits per image on the bench config).

    ``persistent=True`` (PCD) keeps the classical fully-sampled chain: the
    fantasy particles must stay binary to carry across steps, and the
    negative statistics come from those samples (paired with their hidden
    probabilities).

    ``compute_dtype=jnp.bfloat16`` is the throughput mode (bench.py): the
    Gibbs chain's binary states and the statistics matmul inputs run at
    bf16, halving the HBM traffic of the bandwidth-bound CD-1 benchmark
    with measured accuracy unchanged (out/parity/bench_accuracy.json).
    Default float32 keeps the moment matmuls at precision="highest"
    (CLAUDE.md invariant)."""
    dt = compute_dtype
    prec = "highest" if dt == jnp.float32 else None
    B = v0.shape[0]
    v0 = v0.astype(dt)
    y_onehot = y_onehot.astype(dt)
    ph0 = _hidden_prob(params, v0, y_onehot).astype(dt)

    v, y = (v0, y_onehot) if v_init is None else (v_init.astype(dt), y_init.astype(dt))

    def gibbs(carry, k_step):
        v, y = carry
        kh, kv, ky = jax.random.split(k_step, 3)
        h = jax.random.bernoulli(kh, _hidden_prob(params, v, y)).astype(dt)
        pv = _visible_prob(params, h)
        v = jax.random.bernoulli(kv, pv).astype(dt)
        py = _class_prob(params, h)
        y = jax.nn.one_hot(
            jax.random.categorical(ky, jnp.log(py + 1e-12)), py.shape[-1], dtype=dt
        )
        return (v, y), None

    def stats(v, y, ph):
        return RBMParams(
            weights=(jnp.matmul(v.T, ph, precision=prec) / B).astype(jnp.float32),
            visible_bias=v.mean(axis=0).astype(jnp.float32),
            hidden_bias=ph.mean(axis=0).astype(jnp.float32),
            class_bias=y.mean(axis=0).astype(jnp.float32),
            class_weights=(jnp.matmul(y.T, ph, precision=prec) / B).astype(jnp.float32),
        )

    pos = stats(v0, y_onehot, ph0)

    if persistent:
        (vk, yk), _ = jax.lax.scan(gibbs, (v, y), jax.random.split(key, k))
        phk = _hidden_prob(params, vk, yk).astype(dt)
        recon = _visible_prob(params, phk).astype(dt)
        return pos, stats(vk, yk, phk), (vk, yk), recon

    if k > 1:  # intermediate steps fully sampled
        keys = jax.random.split(key, k)
        (v, y), _ = jax.lax.scan(gibbs, (v, y), keys[:-1])
        key = keys[-1]
    # final mean-field update
    h = jax.random.bernoulli(key, _hidden_prob(params, v, y)).astype(dt)
    pv = _visible_prob(params, h).astype(dt)
    py = _class_prob(params, h).astype(dt)
    phk = _hidden_prob(params, pv, py).astype(dt)
    return pos, stats(pv, py, phk), (pv, py), pv


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------


def make_train_step(
    num_classes: int,
    method: str = "discriminative",
    cd_k: int = 1,
    sparse_constant: float = 0.0,
    generative_factor: float = 0.0,
    compute_dtype=jnp.float32,
):
    """Build a jitted step: (params, key, x, y, lr[, chain]) → (params, loss[, chain]).

    method: 'discriminative' (exact gradient, reference behavior),
    'generative' (CD-k), 'pcd' (persistent CD — the Gibbs chain carries over
    between steps instead of restarting at the data), or 'hybrid'
    (disc + generative_factor · CD-k, the reference CLI's
    documented-but-unimplemented mode).  ``compute_dtype`` threads into the
    CD statistics (see :func:`cd_stats`); parameters and updates stay f32.
    """
    if method not in ("discriminative", "generative", "pcd", "hybrid"):
        # an unknown string would otherwise silently no-op (zero updates,
        # constant-0 loss) — the run "succeeds" with an untrained model
        raise ValueError(
            f"unknown method {method!r}: expected 'discriminative', "
            "'generative', 'pcd', or 'hybrid'")
    persistent = method == "pcd"

    def step(params: RBMParams, key, x, y, lr, chain=None):
        updates = jax.tree.map(jnp.zeros_like, params)
        loss = jnp.float32(0.0)
        new_chain = chain
        if method in ("discriminative", "hybrid"):
            nll, grad = jax.value_and_grad(discriminative_nll)(params, x, y)
            updates = jax.tree.map(lambda u, g: u - g, updates, grad)
            loss = nll
        if method in ("generative", "hybrid", "pcd"):
            factor = generative_factor if method == "hybrid" else 1.0
            y_onehot = jax.nn.one_hot(y.astype(jnp.int32), num_classes)
            v_init, y_init = (chain if persistent and chain is not None else (None, None))
            pos, neg, new_chain, recon = cd_stats(params, key, x, y_onehot, cd_k,
                                                  v_init=v_init, y_init=y_init,
                                                  compute_dtype=compute_dtype,
                                                  persistent=persistent)
            updates = jax.tree.map(lambda u, p, n: u + factor * (p - n), updates, pos, neg)
            if method == "generative":
                # reconstruction error from the CD chain itself — no extra
                # forward pass (a data-mean-field recon would cost two more
                # (B,784)x(784,H) matmuls per step just for reporting)
                loss = jnp.mean((x.astype(recon.dtype) - recon) ** 2).astype(jnp.float32)
            elif method == "pcd":
                # fantasy-particle recon says nothing about x; report the
                # data mean-field reconstruction error instead
                loss = jnp.mean((x - _visible_prob(params, _hidden_prob(params, x, y_onehot))) ** 2)
        new = jax.tree.map(lambda p, u: p + lr * u, params, updates)
        # sparsity shrinkage on biases, reference ``update_weights``
        # (``src/ClassificationRBM.py:96-99``)
        if sparse_constant:
            new = dataclasses.replace(
                new,
                visible_bias=new.visible_bias - sparse_constant,
                hidden_bias=new.hidden_bias - sparse_constant,
                class_bias=new.class_bias - sparse_constant,
            )
        if persistent:
            return new, loss, new_chain
        return new, loss

    return jax.jit(step)


def make_epoch_scan(step_fn):
    """Whole-epoch driver: pre-batched (N_b, B, V) / (N_b, B) arrays scanned
    on device — the throughput path for the CD-1 MNIST benchmark."""

    @jax.jit
    def epoch(params: RBMParams, key, xb, yb, lr):
        def body(carry, xy):
            params, key = carry
            key, k = jax.random.split(key)
            x, y = xy
            params, loss = step_fn(params, k, x, y, lr)
            return (params, key), loss

        (params, key), losses = jax.lax.scan(body, (params, key), (xb, yb))
        return params, losses.mean()

    return epoch


# ---------------------------------------------------------------------------
# Stateful wrapper (reference API surface)
# ---------------------------------------------------------------------------


class ClassificationRBM:
    def __init__(
        self,
        num_visible: int,
        num_hidden: int,
        k: int = 1,
        num_classes: int = 2,
        learning_rate: float = 0.05,
        sparse_constant: float = 0.0,
        seed: int = 42,
        method: str = "discriminative",
        generative_factor: float = 0.0,
    ):
        self.num_visible = num_visible
        self.num_hidden = num_hidden
        self.k = k
        self.num_classes = num_classes
        self.learning_rate = learning_rate
        self.seed = seed
        self.method = method
        self.key = jax.random.key(seed)
        self.key, init_key = jax.random.split(self.key)
        self.params = init_params(init_key, num_visible, num_hidden, num_classes)
        self._step = make_train_step(
            num_classes, method=method, cd_k=k, sparse_constant=sparse_constant,
            generative_factor=generative_factor,
        )
        self._chain = None  # persistent (v, y) fantasy particles for PCD
        self.acc_per_epoch_list: list[float] = []
        self.auc_per_epoch_list: list[float] = []
        # cumulative per-epoch nll — lives on the model (like acc/auc) so
        # checkpoints written after a resume carry ALIGNED full-history
        # series, not just the post-resume epochs
        self.nll_per_epoch_list: list[float] = []
        # flatline-recovery counter; checkpointed + restored so a resumed
        # run continues at attempt N+1 instead of re-drawing a consumed basin
        self._reinit_attempt = 0

    def reinit_params(self, attempt: int = 1) -> None:
        """Re-draw parameters and PRNG stream from a fresh deterministic
        fold of the seed key — see ``DiscQBM.reinit_params`` (flatline
        recovery, PARITY.md §4).  Resets any PCD chain."""
        self.key = jax.random.fold_in(jax.random.key(self.seed), attempt)
        self.key, init_key = jax.random.split(self.key)
        self.params = init_params(
            init_key, self.num_visible, self.num_hidden, self.num_classes)
        self._chain = None

    def train_rbm(self, train_x, train_y, epochs, batch_size, test_x=None, test_y=None,
                  shuffle=True, reinit_on_collapse: int = 0,
                  checkpoint_every: int = 0, checkpoint_path=None,
                  start_epoch: int = 0):
        """Epoch loop with per-epoch test accuracy/AUC, like the reference
        ``train_rbm`` (``src/ClassificationRBM.py:159-205``).

        ``reinit_on_collapse`` (flag-gated, 0 = off, needs ``test_x``):
        every N epochs, if the per-epoch accuracy stayed at or below the
        majority-class fraction for the whole window, re-draw the
        parameters via :meth:`reinit_params` with a fresh attempt number
        (never after the final epoch).

        ``checkpoint_every`` (VERDICT r3 Missing #3): every N epochs write
        a full-state npz (params + PRNG + acc/auc lists + epoch) to
        ``checkpoint_path``; resuming with ``start_epoch`` from
        ``qbmx.utils.checkpoint.load_checkpoint`` continues bit-identically
        (not supported for PCD — the persistent fantasy chain is not in
        the checkpoint)."""
        from qbmx.utils.metrics import accuracy_and_auc

        if checkpoint_every and self.method == "pcd":
            raise ValueError("checkpoint_every does not support method='pcd'"
                             " (persistent chain state is not checkpointed)")

        x = jnp.asarray(train_x, jnp.float32).reshape(len(train_x), -1)
        y = jnp.asarray(np.asarray(train_y))
        n = x.shape[0]
        loss_list, nll_list = [], []  # run-local (the return value)
        is_pcd = self.method == "pcd"
        if is_pcd:
            epoch_fn = None
        else:
            # cached on the instance: a fresh closure per call would force a
            # full retrace/recompile of the whole-epoch scan on every
            # train_rbm invocation (resume loops, repeated short runs)
            epoch_fn = getattr(self, "_epoch_fn", None)
            if epoch_fn is None:
                epoch_fn = self._epoch_fn = make_epoch_scan(self._step)
        for epoch_i in range(start_epoch + 1, epochs + 1):
            if shuffle:
                self.key, kp = jax.random.split(self.key)
                perm = jax.random.permutation(kp, n)
                xs, ys = x[perm], y[perm]
            else:
                xs, ys = x, y
            nb = n // batch_size
            if nb == 0 and is_pcd:
                raise ValueError(
                    f"batch_size={batch_size} exceeds the {n}-example "
                    "training set and method='pcd' skips ragged batches — "
                    "nothing would train; lower batch_size")
            if nb:
                xb = xs[: nb * batch_size].reshape(nb, batch_size, -1)
                yb = ys[: nb * batch_size].reshape(nb, batch_size)
            self.key, ke = jax.random.split(self.key)
            if is_pcd:
                # chain state carries across batches (fixed batch shape).
                # Deviation: the ragged tail batch is SKIPPED here — the
                # persistent chain has batch_size rows and cannot step a
                # smaller batch; with per-epoch reshuffling the skipped
                # examples vary.  The non-PCD branch below trains it.
                losses = []
                for b in range(nb):
                    ke, k = jax.random.split(ke)
                    self.params, loss, self._chain = self._step(
                        self.params, k, xb[b], yb[b], self.learning_rate, self._chain
                    )
                    losses.append(float(loss))
                mean_loss = float(np.mean(losses)) if losses else float("nan")
            else:
                if nb:
                    self.params, mean_loss = epoch_fn(
                        self.params, ke, xb, yb, self.learning_rate)
                # remainder batch (reference trains it too); when the batch
                # size exceeds the dataset (nb == 0) the WHOLE set is the
                # remainder and its loss is the epoch loss
                if n % batch_size:
                    self.key, kr = jax.random.split(self.key)
                    self.params, rloss = self._step(
                        self.params, kr, xs[nb * batch_size :], ys[nb * batch_size :],
                        self.learning_rate,
                    )
                    if nb == 0:
                        mean_loss = rloss
            loss_list.append(float(mean_loss))
            nll_list.append(float(mean_loss))
            self.nll_per_epoch_list.append(float(mean_loss))
            if test_x is not None:
                preds = self.predict(test_x)
                acc, auc = accuracy_and_auc(np.asarray(test_y), preds)
                self.acc_per_epoch_list.append(acc)
                self.auc_per_epoch_list.append(auc)
                if (reinit_on_collapse and epoch_i % reinit_on_collapse == 0
                        and epoch_i < epochs):
                    ty = np.asarray(test_y)
                    maj = max(float(np.mean(ty == c)) for c in np.unique(ty))
                    window = self.acc_per_epoch_list[-reinit_on_collapse:]
                    if max(window) <= maj + 1e-9:
                        self._reinit_attempt += 1
                        self.reinit_params(attempt=self._reinit_attempt)
            if (checkpoint_every and checkpoint_path
                    and epoch_i % checkpoint_every == 0):
                from qbmx.utils.checkpoint import save_checkpoint
                from qbmx.utils.metrics import History

                h = History()
                h.acc_per_epoch = list(self.acc_per_epoch_list)
                h.auc_per_epoch = list(self.auc_per_epoch_list)
                # full cumulative series, index-aligned with acc/auc even
                # after a resume (nll_list alone holds only this run's epochs)
                h.nll_per_epoch = list(self.nll_per_epoch_list)
                save_checkpoint(checkpoint_path, self, h, epoch_i)
        return loss_list, self, nll_list

    def predict(self, x):
        # accept image-shaped input like train_rbm does
        x = jnp.asarray(x, jnp.float32).reshape(len(x), -1)
        probs = predict_proba(self.params, x)
        return np.asarray(jnp.argmax(probs, axis=-1))

    def run_test_set(self, x, y):
        from qbmx.utils.metrics import accuracy_and_auc

        preds = self.predict(x)
        return accuracy_and_auc(np.asarray(y), preds)

    def get_num_params(self):
        return sum(int(np.prod(p.shape)) for p in jax.tree.leaves(self.params))

    # -- weight checkpoints (pickle list, ordering fixed below) --------------
    # The reference RBM never pickles weights (``rbm_main.py`` keeps only
    # acc/auc pickles), so this format is qbmx's own: the RBMParams leaves
    # in ctor order.  It is what the seed-parallel RBM sweep's best-epoch
    # capture writes and what ``load_params`` reads back.

    def weight_objects(self, params: RBMParams | None = None):
        p = params if params is not None else self.params
        return [
            np.asarray(p.weights),
            np.asarray(p.visible_bias),
            np.asarray(p.hidden_bias),
            np.asarray(p.class_bias),
            np.asarray(p.class_weights),
        ]

    def save_weights(self, title: str, path: str = "out"):
        from qbmx.models.base import save_weight_pickle

        save_weight_pickle(self.weight_objects(), title, path)

    def load_params(self, file_path):
        from qbmx.models.base import load_weight_pickle

        w, vb, hb, cb, cw = load_weight_pickle(file_path)
        self.params = RBMParams(
            weights=jnp.asarray(w, jnp.float32),
            visible_bias=jnp.asarray(vb, jnp.float32),
            hidden_bias=jnp.asarray(hb, jnp.float32),
            class_bias=jnp.asarray(cb, jnp.float32),
            class_weights=jnp.asarray(cw, jnp.float32),
        )

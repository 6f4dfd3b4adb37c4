"""Flat discriminative Quantum Boltzmann Machine (Disc_QBM), in JAX.

Same capability as the reference's ``Disc_QBM`` (``src/model/faster_dqbm.py``):
label node(s) + clamped analog input (values in [0,1]) + H hidden units,
trained with clamped/unclamped two-phase Boltzmann learning over QUBO
samples.  The design is functional: parameters are a pytree, the QUBO
builders and moment estimators are pure functions vmapped over the batch,
and one training iteration — both phases' QUBO builds, all SA chains, moment
estimation, and the SGD update — is a single jitted computation.  The
reference instead loops examples in Python and fans SA out to a process pool
(2·N pickled sampler invocations per epoch, SURVEY.md §3.2).

QUBO layout parity (``src/model/faster_dqbm.py:225-284``):
  * clamped (H×H): diag = hidden biases + (concat(label, x) @ W_vh);
    strictly-upper = hidden-hidden couplings (iff not restricted); ÷ beta_eff.
  * unclamped ((O+H)×(O+H)): output block first — diag outputs =
    output biases + x @ W_vo, diag hiddens = hidden biases + x @ W_vh[input
    rows]; upper blocks = output-output couplings, label-row W_vh as the
    output→hidden block, hidden-hidden couplings; ÷ beta_eff.

Moment estimation implements the mathematically correct vectorized form.
The reference's batched estimator has wrong-block bugs (writes unclamped
visible→hidden stats into ``[:dim_input, :dim_input]`` and double-counts
output-output stats in the hidden-hidden branch,
``src/model/faster_dqbm.py:754-848``) — documented deviation per
SURVEY.md §2c.3: we match the *correct* per-example semantics
(``src/model/faster_dqbm.py:688-752``) extended with the proper unclamped
label-row statistic E[y_o h_j].
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from qbmx.models.base import EpochLaunchMixin, QBMModel, load_weight_pickle
from qbmx.samplers.api import Sampler, get_sampler, sampler_sample_groups
from qbmx.samplers.api import sampler_jit_safe as _jit_safe

Pytree = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DQBMParams:
    """Parameter pytree. Shapes follow ``init_weights_for_supervised``
    (``src/model/faster_dqbm.py:192-223``); ``w_hh`` is all-zero (and kept
    frozen) when the model is restricted, so the pytree is jit-stable."""

    w_vh: jax.Array  # (n_out + dim_input, H): rows = [label nodes..., input...]
    w_vo: jax.Array  # (dim_input, n_out)
    w_oo: jax.Array  # (n_out, n_out), strictly upper
    b_h: jax.Array  # (H,)
    b_o: jax.Array  # (n_out,)
    w_hh: jax.Array  # (H, H), strictly upper; zeros if restricted


def init_params(
    key: jax.Array, dim_input: int, n_hidden: int, n_out: int, restricted: bool
) -> DQBMParams:
    """U(-1, 1) init, matching the reference's distribution (not its numpy
    RNG stream — parity is statistical, SURVEY.md §7)."""
    ks = jax.random.split(key, 6)
    u = lambda k, shape: jax.random.uniform(k, shape, jnp.float32, -1.0, 1.0)
    H = n_hidden
    w_hh = jnp.triu(u(ks[5], (H, H)), k=1) if not restricted else jnp.zeros((H, H))
    return DQBMParams(
        w_vh=u(ks[0], (n_out + dim_input, H)),
        w_vo=u(ks[1], (dim_input, n_out)),
        w_oo=jnp.triu(u(ks[2], (n_out, n_out)), k=1),
        b_h=u(ks[3], (H,)),
        b_o=u(ks[4], (n_out,)),
        w_hh=w_hh,
    )


# ---------------------------------------------------------------------------
# QUBO builders (pure, vmappable)
# ---------------------------------------------------------------------------


def clamped_qubo(params: DQBMParams, x: jax.Array, y_vec: jax.Array, beta_eff: float):
    """(H, H) QUBO over hidden units with visibles clamped to (label, x)."""
    v = jnp.concatenate([y_vec, x])  # label rows first, as in the weight matrix
    diag = params.b_h + jnp.dot(v, params.w_vh, precision="highest")
    Q = jnp.diag(diag) + jnp.triu(params.w_hh, k=1)
    return Q / beta_eff


def unclamped_qubo(params: DQBMParams, x: jax.Array, beta_eff: float):
    """((O+H), (O+H)) QUBO over (outputs, hiddens) with input clamped to x."""
    n_out = params.b_o.shape[0]
    H = params.b_h.shape[0]
    diag_o = params.b_o + jnp.dot(x, params.w_vo, precision="highest")
    diag_h = params.b_h + jnp.dot(x, params.w_vh[n_out:], precision="highest")
    Q = jnp.zeros((n_out + H, n_out + H))
    Q = Q.at[jnp.arange(n_out), jnp.arange(n_out)].set(diag_o)
    Q = Q.at[n_out + jnp.arange(H), n_out + jnp.arange(H)].set(diag_h)
    Q = Q.at[:n_out, :n_out].add(jnp.triu(params.w_oo, k=1))
    Q = Q.at[:n_out, n_out:].add(params.w_vh[:n_out])
    Q = Q.at[n_out:, n_out:].add(jnp.triu(params.w_hh, k=1))
    return Q / beta_eff


clamped_qubo_batch = jax.vmap(clamped_qubo, in_axes=(None, 0, 0, None))
unclamped_qubo_batch = jax.vmap(unclamped_qubo, in_axes=(None, 0, None))


# Structured (shared-coupling) forms of the same builders: the couplings
# and biases come from the parameters only, while the clamped visibles
# enter as per-example LINEAR terms — so ``<phase>_qubo(params, x, ...) ==
# <phase>_qubo_shared(params, ...) + diag(<phase>_fields(params, x, ...))``
# exactly (pinned by tests/test_dqbm.py).  Samplers exploit this through
# sampler_sample_groups (the anneal kernel — qbmx/samplers/anneal_kernel.py).


def clamped_qubo_shared(params: DQBMParams, beta_eff: float):
    """(H, H) example-independent part of the clamped QUBO."""
    Q = jnp.diag(params.b_h) + jnp.triu(params.w_hh, k=1)
    return Q / beta_eff


def clamped_fields(params: DQBMParams, x: jax.Array, y_vec: jax.Array,
                   beta_eff: float):
    """(B, H) per-example linear terms of the clamped QUBO."""
    v = jnp.concatenate([y_vec, x], axis=-1)  # (B, O+D)
    return jnp.dot(v, params.w_vh, precision="highest") / beta_eff


def unclamped_qubo_shared(params: DQBMParams, beta_eff: float):
    """((O+H), (O+H)) example-independent part of the unclamped QUBO."""
    n_out = params.b_o.shape[0]
    H = params.b_h.shape[0]
    Q = jnp.diag(jnp.concatenate([params.b_o, params.b_h]))
    Q = Q.at[:n_out, :n_out].add(jnp.triu(params.w_oo, k=1))
    Q = Q.at[:n_out, n_out:].add(params.w_vh[:n_out])
    Q = Q.at[n_out:, n_out:].add(jnp.triu(params.w_hh, k=1))
    return Q / beta_eff


def unclamped_fields(params: DQBMParams, x: jax.Array, beta_eff: float):
    """(B, O+H) per-example linear terms of the unclamped QUBO."""
    n_out = params.b_o.shape[0]
    f = jnp.concatenate([jnp.dot(x, params.w_vo, precision="highest"),
                         jnp.dot(x, params.w_vh[n_out:], precision="highest")],
                        axis=-1)
    return f / beta_eff


# ---------------------------------------------------------------------------
# Moment estimation (correct vectorized math)
# ---------------------------------------------------------------------------


def clamped_moments(s_h: jax.Array, x: jax.Array, y_vec: jax.Array) -> DQBMParams:
    """Per-example clamped-phase statistics.

    s_h: (B, R, H) hidden samples; x: (B, D); y_vec: (B, O).
    Returns a DQBMParams-shaped pytree of per-example-averaged statistics
    (already averaged over reads, still summed over nothing — per example).
    """
    Eh = s_h.mean(axis=1)  # (B, H)
    Ehh = jnp.einsum("brh,brk->bhk", s_h, s_h, precision="highest") / s_h.shape[1]
    v = jnp.concatenate([y_vec, x], axis=1)  # (B, O+D)
    g_wvh = v[:, :, None] * Eh[:, None, :]  # (B, O+D, H)
    g_wvo = x[:, :, None] * y_vec[:, None, :]  # (B, D, O)
    g_woo = jnp.triu(y_vec[:, :, None] * y_vec[:, None, :], k=1)
    return DQBMParams(
        w_vh=g_wvh,
        w_vo=g_wvo,
        w_oo=g_woo,
        b_h=Eh,
        b_o=y_vec,
        w_hh=jnp.triu(Ehh, k=1),
    )


def unclamped_moments(s: jax.Array, x: jax.Array, n_out: int) -> DQBMParams:
    """Per-example unclamped-phase statistics.

    s: (B, R, O+H) samples over (outputs, hiddens); x: (B, D).
    """
    R = s.shape[1]
    y_s = s[:, :, :n_out]  # (B, R, O)
    h_s = s[:, :, n_out:]  # (B, R, H)
    Ey = y_s.mean(axis=1)
    Eh = h_s.mean(axis=1)
    Eyh = jnp.einsum("bro,brh->boh", y_s, h_s, precision="highest") / R
    Eyy = jnp.einsum("bro,brp->bop", y_s, y_s, precision="highest") / R
    Ehh = jnp.einsum("brh,brk->bhk", h_s, h_s, precision="highest") / R
    g_wvh = jnp.concatenate([Eyh, x[:, :, None] * Eh[:, None, :]], axis=1)
    g_wvo = x[:, :, None] * Ey[:, None, :]
    return DQBMParams(
        w_vh=g_wvh,
        w_vo=g_wvo,
        w_oo=jnp.triu(Eyy, k=1),
        b_h=Eh,
        b_o=Ey,
        w_hh=jnp.triu(Ehh, k=1),
    )


def _masked_mean(tree: Pytree, mask: jax.Array) -> Pytree:
    """Average per-example stats over the batch, honoring a validity mask
    (padded tail of the final partial batch contributes zero)."""
    denom = jnp.maximum(mask.sum(), 1.0)

    def avg(leaf):
        m = mask.reshape((-1,) + (1,) * (leaf.ndim - 1))
        return (leaf * m).sum(axis=0) / denom

    return jax.tree.map(avg, tree)


# ---------------------------------------------------------------------------
# Loss / prediction helpers (reference semantics)
# ---------------------------------------------------------------------------


def output_probs_from_samples(s_u: jax.Array, n_out: int, one_hot: bool):
    """Unclamped samples → class probabilities.

    Binary single-node: p1 = E[output node], probs = [1-p1, p1]
    (``src/model/faster_dqbm.py:980-981``).  One-hot: normalized marginals
    (``src/train/pipeline.py:24-27``).
    """
    marg = s_u[:, :, :n_out].mean(axis=1)  # (B, O)
    if not one_hot:
        p1 = jnp.clip(marg[:, 0], 1e-12, 1 - 1e-12)
        return jnp.stack([1.0 - p1, p1], axis=1)
    tot = marg.sum(axis=1, keepdims=True)
    return jnp.where(tot > 0, marg / tot, 1.0 / n_out)


def nll_from_probs(probs: jax.Array, y: jax.Array, mask: jax.Array) -> jax.Array:
    """Mean −log p(y) over valid examples (``compute_nll``,
    ``src/model/faster_dqbm.py:972-994``)."""
    p = jnp.take_along_axis(probs, y[:, None].astype(jnp.int32), axis=1)[:, 0]
    nll = -jnp.log(p + 1e-12)
    return (nll * mask).sum() / jnp.maximum(mask.sum(), 1.0)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class DiscQBM(EpochLaunchMixin, QBMModel):
    """Stateful wrapper with the reference's API surface
    (train_model / predict / save_weights / load_savepoint) around the
    functional core above."""

    def __init__(
        self,
        dim_input: int,
        num_classes: int = 2,
        n_hidden_nodes: int = 4,
        seed: int = 77,
        solver: str = "SA",
        restricted: bool = False,
        sample_count: int = 20,
        anneal_steps: int = 20,
        beta_eff: float = 1.0,
        use_one_hot_encoding: bool = False,
        sampler: Sampler | None = None,
        load_path: str = "",
        use_linear_shortcut: bool = False,
        grad_clip: float = 0.0,
        sampler_kwargs: dict | None = None,
    ):
        """``use_linear_shortcut``: when the model is restricted, the clamped
        QUBO is diagonal and its ground state is closed-form — skip sampling
        that phase entirely (the reference's QPU path does this,
        ``solve_linear_qubo``, ``src/model/faster_dqbm.py:41-54, 660-663``;
        its SA path still sampled).  Off by default for SA-path parity.

        ``grad_clip``: >0 clips the moment-diff gradient's global L2 norm
        (flag-gated stability extension, see
        :func:`qbmx.models.base.clip_by_global_norm`; 0 = reference parity)."""
        self.dim_input = dim_input
        self.num_classes = num_classes
        self.n_hidden_nodes = n_hidden_nodes
        self.n_output_nodes = num_classes if use_one_hot_encoding else 1
        self.use_one_hot_encoding = use_one_hot_encoding
        self.restricted = restricted
        self.use_linear_shortcut = use_linear_shortcut and restricted
        self.sample_count = sample_count
        self.anneal_steps = anneal_steps
        self.beta_eff = float(beta_eff)
        self.seed = seed
        self.grad_clip = float(grad_clip)
        self.solver_string = solver
        # sampler_kwargs threads solver-specific knobs through the registry
        # (e.g. ``copies=k`` for the QPU adapter's parallel-QA packing — the
        # reference reaches get_parallel_qa_samples straight from its CLIs,
        # ``src/model/faster_dqbm.py:674-679``, so the knob must be
        # CLI-reachable here too, not constructor-only).
        self.sampler = sampler if sampler is not None else get_sampler(
            solver, num_sweeps=anneal_steps, **(sampler_kwargs or {}))

        self.key = jax.random.key(seed)
        self.key, init_key = jax.random.split(self.key)
        self.params = init_params(
            init_key, dim_input, n_hidden_nodes, self.n_output_nodes, restricted
        )
        if load_path:
            self.load_savepoint(load_path)

        self._step = self._build_step()
        self._predict_probs = self._build_predict()

    # -- jitted computations -------------------------------------------------

    def _build_step(self):
        sampler = self.sampler
        n_out = self.n_output_nodes
        beta_eff = self.beta_eff
        reads = self.sample_count
        restricted = self.restricted
        one_hot = self.use_one_hot_encoding
        grad_clip = self.grad_clip

        linear_shortcut = self.use_linear_shortcut
        maybe_jit = jax.jit if _jit_safe(sampler) else (lambda f: f)

        @maybe_jit
        def step(params: DQBMParams, x, y, mask, lr, key):
            y_vec = (
                jax.nn.one_hot(y.astype(jnp.int32), n_out)
                if one_hot
                else y.astype(jnp.float32)[:, None]
            )
            kc, ku = jax.random.split(key)
            B = x.shape[0]
            H = params.b_h.shape[0]
            Qu_sh = unclamped_qubo_shared(params, beta_eff)
            hu = unclamped_fields(params, x, beta_eff)  # (B, n_u)
            n_u = Qu_sh.shape[-1]
            if linear_shortcut:
                # restricted clamped QUBO is diagonal: ground state in closed
                # form, replicated across reads like the reference's
                # solve_linear_qubo (ties broken randomly)
                Qc = clamped_qubo_batch(params, x, y_vec, beta_eff)
                diag = jnp.diagonal(Qc, axis1=-2, axis2=-1)  # (B, H)
                coin = jax.random.bernoulli(kc, 0.5, diag.shape).astype(jnp.float32)
                gs = jnp.where(diag < 0, 1.0, jnp.where(diag > 0, 0.0, coin))
                s_c = jnp.broadcast_to(gs[:, None, :], (B, reads, H))
                s_u = sampler_sample_groups(
                    sampler, ku, Qu_sh[None], hu[None], reads
                )[0]
            else:
                # fuse both phases into ONE sampler invocation as TWO
                # shared-coupling GROUPS (couplings come from the params;
                # the clamped visibles are per-example linear terms — the
                # structured form samplers exploit, anneal_kernel.py).  The
                # clamped group is zero-padded to the unclamped size
                # (padding variables couple to nothing — harmless, sliced
                # off).  Dense-fallback samplers see the identical
                # [clamped..., unclamped...] 2B-problem batch as before.
                Qc_sh = clamped_qubo_shared(params, beta_eff)
                hc = clamped_fields(params, x, y_vec, beta_eff)  # (B, H)
                Qc_pad = jnp.zeros((n_u, n_u), Qc_sh.dtype).at[:H, :H].set(Qc_sh)
                Q2 = jnp.stack([Qc_pad, Qu_sh])  # (2, n_u, n_u)
                h2 = jnp.stack(
                    [jnp.pad(hc, ((0, 0), (0, n_u - H))), hu]
                )  # (2, B, n_u)
                s_all = sampler_sample_groups(sampler, ku, Q2, h2, reads)
                s_c = s_all[0, :, :, :H]
                s_u = s_all[1]

            mc = clamped_moments(s_c, x, y_vec)
            mu = unclamped_moments(s_u, x, n_out)
            diff = jax.tree.map(lambda a, b: a - b, mc, mu)
            grad = _masked_mean(diff, mask)
            if restricted:
                grad = dataclasses.replace(grad, w_hh=jnp.zeros_like(grad.w_hh))
            if grad_clip > 0.0:
                from qbmx.models.base import clip_by_global_norm

                grad = clip_by_global_norm(grad, grad_clip)
            # gradient DESCENT on (clamped − unclamped), reference
            # ``src/model/faster_dqbm.py:1051-1059``
            new_params = jax.tree.map(lambda p, g: p - lr * g, params, grad)

            probs = output_probs_from_samples(s_u, n_out, one_hot)
            nll = nll_from_probs(probs, y, mask)
            err_out = (grad.b_o).mean()
            return new_params, nll, err_out

        return step

    def _build_predict(self):
        sampler = self.sampler
        n_out = self.n_output_nodes
        beta_eff = self.beta_eff
        reads = self.sample_count
        one_hot = self.use_one_hot_encoding
        maybe_jit = jax.jit if _jit_safe(sampler) else (lambda f: f)

        @maybe_jit
        def predict_probs(params: DQBMParams, x, key):
            Qu_sh = unclamped_qubo_shared(params, beta_eff)
            hu = unclamped_fields(params, x, beta_eff)
            s_u = sampler_sample_groups(sampler, key, Qu_sh[None], hu[None],
                                        reads)[0]
            marg = s_u[:, :, :n_out].mean(axis=1)
            probs = output_probs_from_samples(s_u, n_out, one_hot)
            return marg, probs

        return predict_probs

    # epoch-launch machinery (scan / unrolled segments / device-data cache)
    # comes from EpochLaunchMixin; only the QUBO side length is ours
    def _sampler_call_groups(self) -> int:
        """The linear-shortcut step samples only the unclamped phase (one
        structured group); the normal step fuses both phases (two).  The
        epoch-scan decision must probe the step's REAL call shapes
        (EpochLaunchMixin.supports_epoch_scan)."""
        return 1 if self.use_linear_shortcut else 2

    def _qubo_n(self) -> int:
        return self.n_output_nodes + self.n_hidden_nodes

    def train_for_one_iteration(self, x_batch, y_batch, learning_rate, mask=None):
        x = jnp.asarray(x_batch, dtype=jnp.float32)
        y = jnp.asarray(y_batch)
        if mask is None:
            mask = jnp.ones((x.shape[0],), dtype=jnp.float32)
        self.key, k = jax.random.split(self.key)
        self.params, nll, err = self._step(self.params, x, y, mask, learning_rate, k)
        # device scalars: callers float() them lazily, so an epoch of batches
        # costs one host sync instead of two per batch
        return err, nll

    def predict(self, data):
        """Single-example prediction, reference semantics
        (``src/model/faster_dqbm.py:1227-1241``): unclamped output marginal,
        rounded (binary) or argmaxed (one-hot)."""
        preds, _ = self.predict_batch(np.asarray(data)[None])
        return int(preds[0])

    def predict_batch(self, X):
        x = self._cached_device_input(X)
        self.key, k = jax.random.split(self.key)
        marg, probs = self._predict_probs(self.params, x, k)
        marg = np.asarray(marg)
        if self.use_one_hot_encoding:
            preds = np.argmax(marg, axis=1)
        else:
            preds = np.round(marg[:, 0]).astype(int)
        return preds, np.asarray(probs)

    def get_result_distribution(self, samples_of_output_list, all_possible_patterns):
        """Empirical distribution over output-node bit patterns (reference
        ``get_result_distribution``, ``src/model/faster_dqbm.py:1243-1265``)."""
        from collections import Counter

        if self.use_one_hot_encoding:
            keys = ["".join(str(int(v)) for v in s) for s in samples_of_output_list]
        else:
            keys = [str(int(v)) for v in np.asarray(samples_of_output_list).ravel()]
        counts = Counter(keys)
        total = sum(counts.values())
        probs = {k: v / total for k, v in counts.items()} if total else {}
        return [probs.get(p, 0.0) for p in all_possible_patterns]

    def sample_output_patterns(self, X):
        """Unclamped output-node samples for each input — feeds
        get_result_distribution / the distribution bar plots."""
        x = jnp.asarray(X, dtype=jnp.float32)
        self.key, k = jax.random.split(self.key)
        Qu = unclamped_qubo_batch(self.params, x, self.beta_eff)
        s_u = self.sampler.sample_batch(k, Qu, self.sample_count)
        return np.asarray(s_u[:, :, : self.n_output_nodes]).reshape(-1, self.n_output_nodes)

    # -- checkpointing (reference pickle format compatible) ------------------

    def weight_objects(self, params: DQBMParams | None = None):
        """Reference ``weight_objects`` ordering
        (``src/model/faster_dqbm.py:90-94``).  ``params`` defaults to the
        live parameters; sweeps pass per-seed best-epoch snapshots."""
        p = params if params is not None else self.params
        objs = [
            np.asarray(p.w_vh),
            np.asarray(p.w_vo),
            np.asarray(p.b_h),
            np.asarray(p.b_o),
            np.asarray(p.w_oo),
        ]
        if not self.restricted:
            objs.append(np.asarray(p.w_hh))
        return objs

    def reinit_params(self, attempt: int = 1) -> None:
        """Re-draw parameters and PRNG stream from a fresh deterministic
        fold of the seed key (``fold_in(key(seed), attempt)``) — the
        single-model counterpart of ``SeedParallelCDQBM.reinit_seeds``
        (flatline recovery is an init-basin property, PARITY.md §4)."""
        self.key = jax.random.fold_in(jax.random.key(self.seed), attempt)
        self.key, init_key = jax.random.split(self.key)
        self.params = init_params(
            init_key, self.dim_input, self.n_hidden_nodes,
            self.n_output_nodes, self.restricted,
        )

    # save_weights comes from QBMModel (shared pickle-list format)

    def load_savepoint(self, savepoint):
        """Load reference-format checkpoints: 5-tuple (restricted) or 6-tuple
        (fully connected), ``src/model/faster_dqbm.py:169-190``."""
        loaded = load_weight_pickle(savepoint, "Savepoint file not found")
        if len(loaded) not in (5, 6):
            raise ValueError(f"expected 5- or 6-tuple checkpoint, got {len(loaded)}")
        w_vh, w_vo, b_h, b_o, w_oo = loaded[:5]
        # surface config/pickle mismatches here with the knobs that fix them,
        # instead of as an opaque shape error deep inside the jitted step
        # (ADVICE r4: reload scripts hardcoding hnodes/restricted)
        want_vh = (self.n_output_nodes + self.dim_input, self.n_hidden_nodes)
        got_vh = np.shape(w_vh)
        if tuple(got_vh) != want_vh:
            raise ValueError(
                f"{savepoint}: visible->hidden weights are {tuple(got_vh)} but this "
                f"model expects {want_vh} (dim_input={self.dim_input}, "
                f"n_hidden_nodes={self.n_hidden_nodes}, "
                f"n_output_nodes={self.n_output_nodes}) — construct the model with "
                "the hyperparameters the pickle was trained with")
        if len(loaded) == 6 and self.restricted:
            raise ValueError(
                f"{savepoint} is a 6-tuple (fully connected, hidden-hidden "
                "couplings present) but this model is restricted=True — "
                "pass restricted=False to load it")
        w_hh = loaded[5] if len(loaded) == 6 else np.zeros((self.n_hidden_nodes,) * 2)
        self.params = DQBMParams(
            w_vh=jnp.asarray(w_vh, jnp.float32),
            w_vo=jnp.asarray(w_vo, jnp.float32),
            w_oo=jnp.asarray(w_oo, jnp.float32),
            b_h=jnp.asarray(b_h, jnp.float32),
            b_o=jnp.asarray(b_o, jnp.float32),
            w_hh=jnp.asarray(w_hh, jnp.float32),
        )

"""Convolutional Deep discriminative QBM (CDQBM), in JAX.

Capability parity with the reference's modular generation
(``src/model/cdqbm_state.py`` + ``src/model/{geometry,layers,inference}.py``
+ ``src/qubo/builder.py`` + ``src/train/train.py``): one shared k×k conv
kernel slid over the image (each conv unit = one patch), pooling windows
over the conv feature map — deterministic (per-window argmin unit enters the
QUBO) or probabilistic (dedicated pool variables with at-most-one + OR-link
QUBO penalties, constant 0.8225) — dense "sequential" hidden layers, and
label node(s), trained with clamped/unclamped moment matching.

Accelerator-first design decisions:
  * All geometry is static (``StackGeometry``); the data-dependent pooling
    choice is an argmin + gather with fixed shapes, so the whole train step
    is a single jitted computation vmapped over the batch (the reference
    builds Python-list QUBOs per example, ``src/qubo/builder.py:21-110``).
  * The conv feature map is computed from a per-unit patch gather table;
    the same gathered patches serve the kernel gradient (patch × E[h]
    accumulation, reference ``src/train/train.py:188-192``).
  * Probabilistic-pooling penalties are a constant matrix added once.

Documented deviations from reference bugs:
  * per-unit hidden biases are actually applied (the reference's
    ``_conv_linear_terms`` silently drops them, ``src/qubo/builder.py:8-10``);
  * for probabilistic pooling, kernel gradients and per-unit conv-bias
    gradients use the conv-unit marginals (mathematically correct; the
    reference indexes patch tables with pool-var indices — its own
    "TODO: not working with probabilistic pooling",
    ``src/train/train.py:186``).
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from qbmx.models.base import (
    EpochLaunchMixin,
    QBMModel,
    load_weight_pickle,
    pad_rows,
)
from qbmx.models.geometry import StackGeometry, patch_index_grid
from qbmx.samplers.api import Sampler, get_sampler

# Probabilistic pooling penalty strength, hard-coded in both reference
# generations (``src/model/cdqbm.py:69``, ``src/qubo/builder.py:26-27``).
PROB_POOL_PENALTY = 0.8225


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CDQBMParams:
    kernel: jax.Array  # (n_kernels, k, k); n_kernels=1 = reference parity
    w_seq: tuple  # per layer: (prev_active, size)
    w_seq_intra: tuple  # per layer: (size, size) strictly upper; zeros if restricted
    w_h2o: jax.Array  # (last_hidden, n_out)
    w_oo: jax.Array  # (n_out, n_out) strictly upper
    b_conv: jax.Array  # (1,) shared | (conv_units_total,) per-unit | (1,) zeros for "none"
    b_seq: jax.Array  # (sum(seq),)
    b_o: jax.Array  # (n_out,)
    # learned per-window probabilistic-pooling penalties (flag-gated
    # extension, ``learn_penalty``): (n_windows,) strengths replacing the
    # constant 0.8225 the reference hardcodes; None when the flag is off
    # (reference parity — None is an empty pytree subtree, so every
    # tree.map/grad path is oblivious)
    pen: jax.Array | None = None


def init_params(key, geo: StackGeometry, hidden_bias_type: str, restricted: bool,
                learn_penalty: bool = False,
                prob_penalty: float = PROB_POOL_PENALTY) -> CDQBMParams:
    """U(-1,1) init following ``Conv_Deep_QBM.init_weights``/``init_biases``
    (``src/model/cdqbm_state.py:140-190``).  ``learn_penalty``: start the
    per-window penalty vector at the reference constant."""
    ks = iter(jax.random.split(key, 8 + 2 * len(geo.seq_sizes)))
    u = lambda shape: jax.random.uniform(next(ks), shape, jnp.float32, -1.0, 1.0)
    k = geo.kernel_size

    w_seq, w_seq_intra = [], []
    prev = geo.n_pooled
    for size in geo.seq_sizes:
        w_seq.append(u((prev, size)))
        w_seq_intra.append(
            jnp.triu(u((size, size)), k=1) if not restricted else jnp.zeros((size, size))
        )
        prev = size

    if hidden_bias_type == "shared":
        b_conv = u((1,))
    elif hidden_bias_type == "none":
        b_conv = jnp.zeros((1,))
    else:  # per-unit (one bias per conv unit per channel)
        b_conv = u((geo.conv_units_total,))

    pen = None
    if learn_penalty:
        if geo.pooling_type != "probabilistic" or not geo.has_pooling:
            raise ValueError("learn_penalty requires probabilistic pooling")
        pen = jnp.full((len(geo.pool_windows),), prob_penalty, jnp.float32)

    return CDQBMParams(
        kernel=u((geo.n_kernels, k, k)),
        w_seq=tuple(w_seq),
        w_seq_intra=tuple(w_seq_intra),
        w_h2o=u((geo.last_hidden_size, geo.n_out)),
        w_oo=jnp.triu(u((geo.n_out, geo.n_out)), k=1),
        b_conv=b_conv,
        b_seq=u((sum(geo.seq_sizes),)) if geo.seq_sizes else jnp.zeros((0,)),
        b_o=u((geo.n_out,)),
        pen=pen,
    )


# ---------------------------------------------------------------------------
# Static penalty matrix (probabilistic pooling)
# ---------------------------------------------------------------------------


def build_penalty_basis(geo: StackGeometry) -> np.ndarray:
    """(n_windows, n_hidden, n_hidden) unit-strength per-window penalty
    patterns (upper-triangular, diagonal = linear terms): pairwise
    at-most-one within the window (``add_at_most_one_penalty_upper``,
    ``src/qubo/builder.py:116-124``) and the OR-link between the window's
    conv units and its pool variable (``add_link_penalty_upper``,
    ``src/qubo/builder.py:127-147``).  The reference scales every window by
    the same hard-coded 0.8225; the flag-gated ``learn_penalty`` extension
    scales window ``w`` by the learned ``params.pen[w]`` instead."""
    if geo.pooling_type != "probabilistic" or not geo.has_pooling:
        return np.zeros((0, geo.n_hidden, geo.n_hidden), dtype=np.float32)
    windows = geo.pool_windows
    p_start = geo.conv_active  # first pool-var index
    basis = np.zeros((len(windows), geo.n_hidden, geo.n_hidden), dtype=np.float32)
    for g, ids in enumerate(windows):
        ids = np.asarray(ids, dtype=int)
        M = basis[g]
        # at-most-one among the window's conv units
        ii, jj = np.triu_indices(len(ids), k=1)
        M[ids[ii], ids[jj]] += 1.0
        # OR-link: pool var on iff some unit on
        pv = p_start + g
        M[pv, pv] += 1.0
        M[ids, ids] += 1.0
        M[ids, pv] += -2.0  # ids < pv always (conv block precedes pool vars)
    return basis


def build_penalty_matrix(geo: StackGeometry, penalty: float = PROB_POOL_PENALTY) -> np.ndarray:
    """(n_hidden, n_hidden) constant upper-triangular penalty terms — every
    window at the same strength (reference parity)."""
    basis = build_penalty_basis(geo)
    if not basis.shape[0]:
        return np.zeros((geo.n_hidden, geo.n_hidden), dtype=np.float32)
    return np.float32(penalty) * basis.sum(axis=0)


# ---------------------------------------------------------------------------
# Per-example context + QUBO assembly (pure jax, vmappable)
# ---------------------------------------------------------------------------


class CDQBM(EpochLaunchMixin, QBMModel):
    """Stateful model holding static geometry + parameter pytree, with the
    reference API surface (train via qbmx.train.loop, predict, save/load).
    Whole-epoch device launches come from EpochLaunchMixin."""

    def __init__(
        self,
        image_shape=(28, 28),
        num_label_nodes: int = 1,
        seed: int = 77,
        kernel_size: int = 3,
        pooling_size: int = 0,
        pooling_type: str = "deterministic",
        stride: int = 1,
        sequential_layer_sizes=None,
        is_restricted: bool = False,
        hidden_bias_type: str = "none",
        solver: str = "SA",
        anneal: int = 1000,
        sample_count: int = 100,
        beta_eff: float = 1.0,
        sampler: Sampler | None = None,
        load_path: str = "",
        num_classes: int = 2,
        pool_select: str = "min",
        center_fmap: bool = False,
        prob_penalty: float = PROB_POOL_PENALTY,
        grad_clip: float = 0.0,
        learn_penalty: bool = False,
        sampler_kwargs: dict | None = None,
        n_kernels: int = 1,
    ):
        """``pool_select`` / ``center_fmap`` are flag-gated extensions (OFF
        by default = reference parity).  The exact-enumeration study
        (``scripts/cdqbm_exact_study.py``, PARITY.md §4) shows the parity
        architecture's deterministic argmin pooling on non-negative fmaps
        selects a near-input-independent unit, capping separability;
        ``pool_select="absmax"`` (strongest-|response| unit) and
        ``center_fmap=True`` (zero-mean fmap per image) both restore it.
        ``prob_penalty`` exposes the probabilistic-pooling penalty strength
        the reference hardcodes at 0.8225 (``src/qubo/builder.py:26-27``);
        the exact study shows the default binds weakly.
        ``grad_clip`` > 0 clips the moment-diff gradient's global L2 norm
        (flag-gated stability extension, see
        :func:`qbmx.models.base.clip_by_global_norm`; 0 = reference parity).
        ``learn_penalty`` (flag-gated, probabilistic pooling only) makes the
        pooling penalty a LEARNED per-window parameter vector initialized at
        ``prob_penalty`` and trained by the same moment-matching rule as
        every other weight (the ROADMAP r2 "per-window learned penalties"
        lead; the exact study showed a single global strength caps the
        architecture).
        ``n_kernels`` (flag-gated, VERDICT r4 #2) widens the conv layer to
        that many independent kernels/channels — the capacity lever the
        reference's single shared k×k kernel never had
        (``src/model/cdqbm.py:289-381``); 1 = reference parity (pinned by
        the ref-builder parity tests).
        """
        if pool_select not in ("min", "max", "absmax"):
            raise ValueError(f"unknown pool_select {pool_select!r}")
        self.geo = StackGeometry(
            image_shape=tuple(image_shape),
            kernel_size=kernel_size,
            stride=stride,
            pooling_size=pooling_size,
            pooling_type=pooling_type,
            seq_sizes=tuple(sequential_layer_sizes or []),
            n_out=num_label_nodes,
            n_kernels=int(n_kernels),
        )
        self.seed = seed
        self.num_classes = num_classes
        self.n_output_nodes = num_label_nodes
        self.n_hidden_nodes = self.geo.n_hidden
        self.dim_input = image_shape[0] * image_shape[1]
        self.use_one_hot_encoding = num_label_nodes > 1
        self.is_restricted = is_restricted
        self.hidden_bias_type = hidden_bias_type
        self.sample_count = sample_count
        self.beta_eff = float(beta_eff)
        self.pool_select = pool_select
        self.center_fmap = bool(center_fmap)
        self.prob_penalty = float(prob_penalty)
        self.grad_clip = float(grad_clip)
        self.learn_penalty = bool(learn_penalty)
        self.solver_string = solver
        # sampler_kwargs threads solver-specific knobs (e.g. the QPU
        # adapter's ``copies`` parallel-QA packing) through the registry —
        # see qbmx/models/dqbm.py for the reference-CLI-reachability rationale.
        self.sampler = sampler if sampler is not None else get_sampler(
            solver, num_sweeps=anneal, **(sampler_kwargs or {}))

        # static tables
        self.patch_idx = jnp.asarray(patch_index_grid(image_shape, kernel_size, stride))
        self.windows = jnp.asarray(self.geo.pool_windows) if self.geo.has_pooling else None
        self.penalty_hidden = jnp.asarray(build_penalty_matrix(self.geo, self.prob_penalty))
        if self.learn_penalty:
            basis = build_penalty_basis(self.geo)
            self.pen_basis = jnp.asarray(basis)  # (W, nh, nh) upper-tri
            self.pen_basis_diag = jnp.asarray(
                np.diagonal(basis, axis1=1, axis2=2).copy())  # (W, nh)
            self.pen_basis_upper = jnp.asarray(
                np.triu(basis, k=1))  # (W, nh, nh) strict upper

        self.key = jax.random.key(seed)
        self.key, init_key = jax.random.split(self.key)
        self.params = init_params(init_key, self.geo, hidden_bias_type,
                                  is_restricted, self.learn_penalty,
                                  self.prob_penalty)
        if load_path:
            self.load_params(load_path)

        # host-bound samplers (QPU adapter, native off-CPU) declare
        # jit_safe=False: the step then runs eagerly on concrete arrays
        from qbmx.samplers.api import sampler_jit_safe

        maybe_jit = jax.jit if sampler_jit_safe(self.sampler) else (lambda f: f)
        self._step = maybe_jit(self._step_fn)
        self._predict_probs = maybe_jit(self._predict_fn)
        self.training_history = None

    # -- context -------------------------------------------------------------

    def _context(self, params: CDQBMParams, x_img: jax.Array):
        """fmap + pooled indices + gathered patches for one image (the
        jax-native ``prepare_context``, ``src/model/inference.py:16-44``)."""
        geo = self.geo
        patches = x_img.reshape(-1)[self.patch_idx]  # (num_conv, k, k)
        # (C, u) per-channel feature maps, flattened CHANNEL-MAJOR to match
        # the conv-block variable layout (StackGeometry.pool_windows offsets)
        fmap = jnp.einsum("ukl,ckl->cu", patches, params.kernel,
                          precision="highest")
        if self.center_fmap:
            fmap = fmap - fmap.mean(axis=1, keepdims=True)
        fmap_flat = fmap.reshape(-1)
        if geo.pooling_type == "deterministic" and geo.has_pooling:
            wf = fmap_flat[self.windows]  # (n_win, p*p)
            if self.pool_select == "max":
                score = -wf
            elif self.pool_select == "absmax":
                score = -jnp.abs(wf)
            else:  # "min" — reference parity (src/model/layers.py:77-84)
                score = wf
            amin = jnp.argmin(score, axis=1)
            pooled_idx = self.windows[jnp.arange(self.windows.shape[0]), amin]
        else:
            pooled_idx = jnp.arange(geo.conv_units_total)
        return fmap_flat, pooled_idx, patches

    def _conv_linear_terms(self, params: CDQBMParams, fmap_flat, pooled_idx):
        """Linear biases for the conv block (``_conv_linear_terms``,
        ``src/qubo/builder.py:3-19``; per-unit biases actually applied here)."""
        geo = self.geo
        if geo.pooling_type == "deterministic" and geo.has_pooling:
            base = fmap_flat[pooled_idx]
            if self.hidden_bias_type == "shared":
                base = base + params.b_conv[0]
            elif self.hidden_bias_type == "per-unit":
                base = base + params.b_conv[pooled_idx]
            return base
        base = fmap_flat
        if self.hidden_bias_type == "shared":
            base = base + params.b_conv[0]
        elif self.hidden_bias_type == "per-unit":
            base = base + params.b_conv
        return base

    # -- QUBO builders -------------------------------------------------------

    def _hidden_block(self, params: CDQBMParams, conv_bias: jax.Array) -> jax.Array:
        """Shared (n_hidden, n_hidden) upper-triangular hidden-block assembly
        (conv diag, sequential inter/intra-layer weights, sequential biases,
        probabilistic-pooling penalties)."""
        geo = self.geo
        n = geo.n_hidden
        Q = jnp.zeros((n, n))
        if self.learn_penalty:
            # learned per-window strengths scale the static unit patterns
            Q = Q + jnp.einsum("w,wij->ij", params.pen, self.pen_basis,
                               precision="highest")
        else:
            Q = Q + self.penalty_hidden
        cs = geo.conv_slice
        Q = Q.at[jnp.arange(cs.start, cs.stop), jnp.arange(cs.start, cs.stop)].add(conv_bias)

        prev_sl = geo.pool_slice
        for li, cur_sl in enumerate(geo.seq_slices):
            Q = Q.at[prev_sl, cur_sl].add(params.w_seq[li])
            if not self.is_restricted:
                Q = Q.at[cur_sl, cur_sl].add(jnp.triu(params.w_seq_intra[li], k=1))
            prev_sl = cur_sl

        if geo.seq_sizes:
            seq_start = geo.conv_active + geo.n_pool_vars
            idx = jnp.arange(seq_start, seq_start + sum(geo.seq_sizes))
            Q = Q.at[idx, idx].add(params.b_seq)
        return Q

    def clamped_qubo(self, params: CDQBMParams, x_img, label_vec):
        """(n_hidden, n_hidden) QUBO with the label clamped
        (``build_clamped_qubo``, ``src/qubo/builder.py:74-110``)."""
        geo = self.geo
        fmap_flat, pooled_idx, _ = self._context(params, x_img)
        Q = self._hidden_block(params, self._conv_linear_terms(params, fmap_flat, pooled_idx))
        eff = (params.w_h2o @ label_vec.reshape(-1, 1)).reshape(-1)
        ls = geo.last_hidden_slice
        idx = jnp.arange(ls.start, ls.stop)
        Q = Q.at[idx, idx].add(eff)
        return Q / self.beta_eff

    def unclamped_qubo(self, params: CDQBMParams, x_img):
        """(n_total, n_total) QUBO with free label nodes
        (``build_unclamped_qubo``, ``src/qubo/builder.py:21-71``)."""
        geo = self.geo
        fmap_flat, pooled_idx, _ = self._context(params, x_img)
        Qh = self._hidden_block(params, self._conv_linear_terms(params, fmap_flat, pooled_idx))
        n = geo.n_total
        Q = jnp.zeros((n, n))
        Q = Q.at[: geo.n_hidden, : geo.n_hidden].add(Qh)
        Q = Q.at[geo.last_hidden_slice, geo.out_slice].add(params.w_h2o)
        Q = Q.at[geo.out_slice, geo.out_slice].add(jnp.triu(params.w_oo, k=1))
        oidx = jnp.arange(geo.n_hidden, n)
        Q = Q.at[oidx, oidx].add(params.b_o)
        return Q / self.beta_eff

    # Structured (shared-coupling) forms: the stack's couplings (penalties,
    # sequential weights, w_h2o, w_oo) and parameter biases are example-
    # independent; the image enters only through the conv linear terms and
    # the clamped label only through the last-hidden effective fields.  So
    # ``<phase>_qubo(params, x, …) == <phase>_qubo_shared(params) +
    # diag(<phase>_fields(params, x, …))`` exactly (pinned by
    # tests/test_cdqbm.py) — the contract sampler_sample_groups / the anneal
    # kernel (qbmx/samplers/anneal_kernel.py) exploit.

    def _zero_conv_bias(self):
        cs = self.geo.conv_slice
        return jnp.zeros(cs.stop - cs.start)

    def clamped_qubo_shared(self, params: CDQBMParams):
        """(n_hidden, n_hidden) example-independent clamped-QUBO part."""
        return self._hidden_block(params, self._zero_conv_bias()) / self.beta_eff

    def clamped_fields(self, params: CDQBMParams, x_img, label_vec):
        """(n_hidden,) per-example linear terms of the clamped QUBO."""
        geo = self.geo
        fmap_flat, pooled_idx, _ = self._context(params, x_img)
        cb = self._conv_linear_terms(params, fmap_flat, pooled_idx)
        cs = geo.conv_slice
        h = jnp.zeros(geo.n_hidden).at[jnp.arange(cs.start, cs.stop)].add(cb)
        eff = (params.w_h2o @ label_vec.reshape(-1, 1)).reshape(-1)
        ls = geo.last_hidden_slice
        h = h.at[jnp.arange(ls.start, ls.stop)].add(eff)
        return h / self.beta_eff

    def unclamped_qubo_shared(self, params: CDQBMParams):
        """(n_total, n_total) example-independent unclamped-QUBO part."""
        geo = self.geo
        Qh = self._hidden_block(params, self._zero_conv_bias())
        n = geo.n_total
        Q = jnp.zeros((n, n))
        Q = Q.at[: geo.n_hidden, : geo.n_hidden].add(Qh)
        Q = Q.at[geo.last_hidden_slice, geo.out_slice].add(params.w_h2o)
        Q = Q.at[geo.out_slice, geo.out_slice].add(jnp.triu(params.w_oo, k=1))
        oidx = jnp.arange(geo.n_hidden, n)
        Q = Q.at[oidx, oidx].add(params.b_o)
        return Q / self.beta_eff

    def unclamped_fields(self, params: CDQBMParams, x_img):
        """(n_total,) per-example linear terms of the unclamped QUBO."""
        geo = self.geo
        fmap_flat, pooled_idx, _ = self._context(params, x_img)
        cb = self._conv_linear_terms(params, fmap_flat, pooled_idx)
        cs = geo.conv_slice
        h = jnp.zeros(geo.n_total).at[jnp.arange(cs.start, cs.stop)].add(cb)
        return h / self.beta_eff

    # -- moment estimation ---------------------------------------------------

    def _moments(self, params, samples, x_img, label_vec=None):
        """Per-example expected sufficient statistics, shaped like the params
        (modular reference ``get_average_configuration_single``,
        ``src/train/train.py:135-253``, with the correct probabilistic-pooling
        semantics — see module docstring)."""
        geo = self.geo
        unclamped = label_vec is None
        R = samples.shape[0]
        _, pooled_idx, patches = self._context(params, x_img)

        full = samples  # (R, n_hidden [+ n_out])
        stats = full[:, geo.stats_drop :]  # drop conv cols for probabilistic
        E = stats.mean(axis=0)  # (n_stats_hidden [+ n_out],)
        nsh = geo.n_stats_hidden
        sizes, starts = geo.sizes_active, geo.stats_starts

        # conv-unit marginals for kernel/per-unit-bias gradients, laid out
        # over the FULL channel-major conv grid (inactive det-pooled units
        # scatter to zero — they are absent from the QUBO, so their
        # marginal contribution is exactly zero)
        if geo.n_pool_vars:
            Econv_full = full[:, : geo.conv_units_total].mean(axis=0)
        else:
            Econv_full = jnp.zeros((geo.conv_units_total,)).at[pooled_idx].add(
                E[: geo.n_pooled])

        # per-channel kernel gradient: channel c sees the same patch table,
        # weighted by its own units' marginals (patch × E[h] accumulation,
        # reference ``src/train/train.py:188-192``, one kernel per channel)
        g_kernel = jnp.einsum(
            "ukl,cu->ckl", patches,
            Econv_full.reshape(geo.n_kernels, geo.num_conv_units),
            precision="highest")

        if self.hidden_bias_type == "shared":
            # ∂E/∂b_shared = Σ over the conv units the bias actually touches
            # (for probabilistic pooling that is ALL conv units, not the pool
            # variables the reference sums — src/train/train.py:177)
            g_b_conv = jnp.sum(Econv_full).reshape(1)
        elif self.hidden_bias_type == "none":
            g_b_conv = jnp.zeros_like(params.b_conv)
        else:  # per-unit
            g_b_conv = Econv_full

        g_b_seq = E[geo.n_pooled : nsh] if geo.seq_sizes else jnp.zeros((0,))

        g_w_seq, g_w_intra = [], []
        for li in range(len(geo.seq_sizes)):
            prev_b = stats[:, starts[li] : starts[li] + sizes[li]]
            cur_b = stats[:, starts[li + 1] : starts[li + 1] + sizes[li + 1]]
            g_w_seq.append(
                jnp.einsum("rp,rc->pc", prev_b, cur_b, precision="highest") / R
            )
            intra = jnp.einsum("rc,rd->cd", cur_b, cur_b, precision="highest") / R
            g_w_intra.append(jnp.triu(intra, k=1))

        last = stats[:, nsh - geo.last_hidden_size : nsh]
        if unclamped:
            ys = stats[:, nsh:]
            g_w_h2o = jnp.einsum("rh,ro->ho", last, ys, precision="highest") / R
            g_b_o = ys.mean(axis=0)
            g_w_oo = jnp.triu(
                jnp.einsum("ro,rp->op", ys, ys, precision="highest") / R, k=1
            )
        else:
            g_w_h2o = last.mean(axis=0)[:, None] * label_vec[None, :]
            g_b_o = label_vec
            g_w_oo = jnp.triu(label_vec[:, None] * label_vec[None, :], k=1)

        if self.learn_penalty:
            # expected per-window penalty feature E[f_w] = E[sᵀ M_w s] with
            # the diagonal carrying the linear terms (s_i² = s_i): the
            # sufficient statistic of pen_w, so pen trains by the same
            # clamped−unclamped moment rule as every other weight
            hid = full[:, : geo.n_hidden]
            g_pen = (
                jnp.einsum("wi,i->w", self.pen_basis_diag, hid.mean(axis=0),
                           precision="highest")
                + jnp.einsum("ri,wij,rj->w", hid, self.pen_basis_upper, hid,
                             precision="highest") / R
            )
        else:
            g_pen = None

        return CDQBMParams(
            kernel=g_kernel,
            w_seq=tuple(g_w_seq),
            w_seq_intra=tuple(g_w_intra),
            w_h2o=g_w_h2o,
            w_oo=g_w_oo,
            b_conv=g_b_conv,
            b_seq=g_b_seq,
            b_o=g_b_o,
            pen=g_pen,
        )

    # -- training / prediction ----------------------------------------------

    def _step_fn(self, params, x_imgs, y, mask, lr, key):
        geo = self.geo
        y_vec = (
            jax.nn.one_hot(y.astype(jnp.int32), geo.n_out)
            if self.use_one_hot_encoding
            else y.astype(jnp.float32)[:, None]
        )
        kc, ku = jax.random.split(key)
        # fuse both phases into one sampler call as two shared-coupling
        # GROUPS (structured form — see the builders above; the clamped
        # group is zero-padded by n_out variables which couple to nothing
        # and are sliced off).  Dense-fallback samplers see the identical
        # [clamped…, unclamped…] 2B batch the dense path built.
        B = x_imgs.shape[0]
        nh, nt = geo.n_hidden, geo.n_total
        Qc_sh = self.clamped_qubo_shared(params)
        Qu_sh = self.unclamped_qubo_shared(params)
        hc = jax.vmap(lambda xi, yi: self.clamped_fields(params, xi, yi))(x_imgs, y_vec)
        hu = jax.vmap(lambda xi: self.unclamped_fields(params, xi))(x_imgs)
        Qc_pad = jnp.zeros((nt, nt), Qc_sh.dtype).at[:nh, :nh].set(Qc_sh)
        from qbmx.samplers.api import sampler_sample_groups

        s_all = sampler_sample_groups(
            self.sampler, ku,
            jnp.stack([Qc_pad, Qu_sh]),
            jnp.stack([jnp.pad(hc, ((0, 0), (0, nt - nh))), hu]),
            self.sample_count,
        )
        s_c = s_all[0, :, :, :nh]
        s_u = s_all[1]

        mc = jax.vmap(lambda s, xi, yi: self._moments(params, s, xi, yi))(s_c, x_imgs, y_vec)
        mu = jax.vmap(lambda s, xi: self._moments(params, s, xi))(s_u, x_imgs)
        diff = jax.tree.map(lambda a, b: a - b, mc, mu)

        denom = jnp.maximum(mask.sum(), 1.0)

        def avg(leaf):
            m = mask.reshape((-1,) + (1,) * (leaf.ndim - 1))
            return (leaf * m).sum(axis=0) / denom

        grad = jax.tree.map(avg, diff)
        if self.is_restricted:
            grad = dataclasses.replace(
                grad, w_seq_intra=tuple(jnp.zeros_like(w) for w in grad.w_seq_intra)
            )
        if self.hidden_bias_type == "none":
            grad = dataclasses.replace(grad, b_conv=jnp.zeros_like(grad.b_conv))
        if self.grad_clip > 0.0:
            from qbmx.models.base import clip_by_global_norm

            grad = clip_by_global_norm(grad, self.grad_clip)
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grad)

        # NLL from unclamped output marginals (``nll_from_probs_binary``,
        # ``src/train/train.py:7-10``)
        probs = self._probs_from_samples(s_u)
        p = jnp.take_along_axis(probs, y[:, None].astype(jnp.int32), axis=1)[:, 0]
        nll = (-jnp.log(p + 1e-12) * mask).sum() / denom
        err = grad.b_o.mean()
        return new_params, nll, err

    def _probs_from_samples(self, s_u):
        geo = self.geo
        marg = s_u[:, :, geo.n_hidden :].mean(axis=1)  # (B, n_out)
        if not self.use_one_hot_encoding:
            p1 = jnp.clip(marg[:, 0], 1e-12, 1 - 1e-12)
            return jnp.stack([1.0 - p1, p1], axis=1)
        tot = marg.sum(axis=1, keepdims=True)
        return jnp.where(tot > 0, marg / tot, 1.0 / geo.n_out)

    def _predict_fn(self, params, x_imgs, key):
        from qbmx.samplers.api import sampler_sample_groups

        Qu_sh = self.unclamped_qubo_shared(params)
        hu = jax.vmap(lambda xi: self.unclamped_fields(params, xi))(x_imgs)
        s_u = sampler_sample_groups(self.sampler, key, Qu_sh[None], hu[None],
                                    self.sample_count)[0]
        probs = self._probs_from_samples(s_u)
        return probs

    # -- functional pipeline API (reference src/train/pipeline.py parity) ----

    def run_unclamped(self, x_img, num_reads=None, key=None):
        """Single-image unclamped run → (samples, probs), mirroring
        ``run_unclamped`` (``src/train/pipeline.py:13-29``)."""
        reads = num_reads or self.sample_count
        if key is None:
            self.key, key = jax.random.split(self.key)
        x = jnp.asarray(x_img, dtype=jnp.float32)
        Qu = self.unclamped_qubo(self.params, x)[None]
        s = self.sampler.sample_batch(key, Qu, reads)
        probs = self._probs_from_samples(s)
        return np.asarray(s[0]), np.asarray(probs[0])

    def run_clamped(self, x_img, label_vec, num_reads=None, key=None):
        """Single-image clamped run → samples, mirroring ``run_clamped``
        (``src/train/pipeline.py:31-36``)."""
        reads = num_reads or self.sample_count
        if key is None:
            self.key, key = jax.random.split(self.key)
        x = jnp.asarray(x_img, dtype=jnp.float32)
        Qc = self.clamped_qubo(self.params, x, jnp.asarray(label_vec, jnp.float32))[None]
        s = self.sampler.sample_batch(key, Qc, reads)
        return np.asarray(s[0])

    def _qubo_n(self) -> int:
        return self.geo.n_total

    def _prepare_inputs(self, x: np.ndarray) -> np.ndarray:
        if x.ndim == 2:  # flattened input
            return x.reshape((-1,) + self.geo.image_shape)
        return x

    def train_for_one_iteration(self, x_batch, y_batch, learning_rate, mask=None):
        x = jnp.asarray(x_batch, dtype=jnp.float32)
        if x.ndim == 2:  # flattened input
            x = x.reshape((-1,) + self.geo.image_shape)
        y = jnp.asarray(np.asarray(y_batch))
        if mask is None:
            mask = jnp.ones((x.shape[0],), dtype=jnp.float32)
        self.key, k = jax.random.split(self.key)
        self.params, nll, err = self._step(self.params, x, y, mask, learning_rate, k)
        # device scalars: callers float() them lazily, so an epoch of batches
        # costs one host sync instead of two per batch
        return err, nll

    def predict_batch(self, X, chunk: int = 32):
        """Chunked batched prediction: bound each sampling launch to
        ``chunk`` examples (hundreds of 700-variable anneals in one launch
        would hold all their dense QUBOs at once).  The device copy is
        cached weakref-keyed on the host object (per-epoch validation
        re-sends the same array otherwise)."""
        x = self._cached_device_input(X)  # _prepare_inputs reshapes flat → image
        n = x.shape[0]
        outs = []
        for i in range(0, n, chunk):
            self.key, k = jax.random.split(self.key)
            xb = pad_rows(x[i : i + chunk], chunk)  # ragged tail
            outs.append(np.asarray(self._predict_probs(self.params, xb, k)))
        probs = np.concatenate(outs, axis=0)[:n]
        preds = np.argmax(probs, axis=1)
        return preds, probs

    def predict(self, data):
        preds, _ = self.predict_batch(np.asarray(data)[None])
        return int(preds[0])

    def get_last_hidden_embedding(self, X, chunk: int = 64):
        """Mean last-hidden-block activations per example, for coreset
        selection (reference ``get_last_hidden_embedding``,
        ``src/model/cdqbm.py:1725-1736``)."""
        geo = self.geo
        x = jnp.asarray(X, dtype=jnp.float32)
        if x.ndim == 2:
            x = x.reshape((-1,) + geo.image_shape)
        out = []
        ls = geo.last_hidden_slice
        n = x.shape[0]
        for i in range(0, n, chunk):
            xb = pad_rows(x[i : i + chunk], chunk)  # ragged tail
            self.key, k = jax.random.split(self.key)
            Qu = jax.vmap(lambda xi: self.unclamped_qubo(self.params, xi))(xb)
            s_u = self.sampler.sample_batch(k, Qu, self.sample_count)
            out.append(np.asarray(s_u[:, :, ls.start : ls.stop].mean(axis=1)))
        return np.concatenate(out, axis=0)[:n]

    # -- checkpointing -------------------------------------------------------

    def weight_objects(self, params: "CDQBMParams | None" = None):
        """Reference ``weight_objects`` ordering
        (``src/model/cdqbm_state.py:40-47``).  ``params`` defaults to the
        live parameters; sweeps pass per-seed best-epoch snapshots."""
        p = params if params is not None else self.params
        objs = [
            # n_kernels=1 checkpoints keep the reference's (k, k) kernel
            # shape; multi-channel models store (C, k, k)
            np.asarray(p.kernel[0] if self.geo.n_kernels == 1 else p.kernel),
            [np.asarray(w) for w in p.w_seq],
            np.asarray(p.w_h2o),
            np.asarray(p.w_oo),
            None if self.is_restricted else [np.asarray(w) for w in p.w_seq_intra],
            np.asarray(p.b_conv),
            np.asarray(p.b_seq),
            np.asarray(p.b_o),
        ]
        if p.pen is not None:
            objs.append(np.asarray(p.pen))  # 9th entry iff learn_penalty
        return objs

    def reinit_params(self, attempt: int = 1) -> None:
        """Re-draw parameters and PRNG stream from a fresh deterministic
        fold of the seed key — see ``DiscQBM.reinit_params`` (flatline
        recovery, PARITY.md §4)."""
        self.key = jax.random.fold_in(jax.random.key(self.seed), attempt)
        self.key, init_key = jax.random.split(self.key)
        self.params = init_params(
            init_key, self.geo, self.hidden_bias_type, self.is_restricted,
            self.learn_penalty, self.prob_penalty,
        )

    # save_weights comes from QBMModel (shared pickle-list format)

    def load_params(self, file_path):
        loaded = load_weight_pickle(file_path)
        pen = None
        if len(loaded) == 9:  # learn_penalty checkpoints carry a 9th entry
            *loaded, pen_arr = loaded
            pen = jnp.asarray(pen_arr, jnp.float32)
        (kernel, w_seq, w_h2o, w_oo, w_intra, b_conv, b_seq, b_o) = loaded
        kernel = np.asarray(kernel, np.float32)
        if kernel.ndim == 2:  # reference-format single-channel checkpoint
            kernel = kernel[None]
        if kernel.shape[0] != self.geo.n_kernels:
            raise ValueError(
                f"savepoint has {kernel.shape[0]} conv kernel(s) but the "
                f"model was built with n_kernels={self.geo.n_kernels}")
        self.params = CDQBMParams(
            pen=pen,
            kernel=jnp.asarray(kernel, jnp.float32),
            w_seq=tuple(jnp.asarray(w, jnp.float32) for w in w_seq),
            w_seq_intra=(
                tuple(jnp.asarray(w, jnp.float32) for w in w_intra)
                if w_intra is not None
                else tuple(jnp.zeros((s, s)) for s in self.geo.seq_sizes)
            ),
            w_h2o=jnp.asarray(w_h2o, jnp.float32),
            w_oo=jnp.asarray(w_oo, jnp.float32),
            b_conv=jnp.asarray(b_conv, jnp.float32),
            b_seq=jnp.asarray(b_seq, jnp.float32),
            b_o=jnp.asarray(b_o, jnp.float32),
        )

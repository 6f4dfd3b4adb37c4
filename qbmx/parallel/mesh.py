"""Multi-device training: shard_map over a device mesh.

The reference's only parallel axes are SA-chain fan-out (a 10-worker process
pool re-sampling the same QUBO, ``src/model/faster_dqbm.py:578-596``) and
replicated-problem chip partitioning on the QPU (``src/embedding.py``).
The device mapping (SURVEY.md §2d):

  * **dp** — data parallelism: the example batch is sharded across chips;
    each chip builds QUBOs and anneals chains for its shard only.
  * **chains** — chain parallelism: each chip anneals ``reads / n_chains``
    independent chains per example with a distinct folded PRNG key (the
    reference reused one seed across all 10 workers — SURVEY.md §2c.4).

Cross-chip traffic is just the moment-statistic sums (a few KB), reduced
with ``psum`` over both axes; parameters are replicated (models are ≤ ~16k
parameters — no tensor parallelism is warranted, SURVEY.md §2d).
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from qbmx.models import cdqbm as cdqbm_mod
from qbmx.models import dqbm as dqbm_mod


def make_mesh(dp: int | None = None, chains: int = 1, devices=None) -> Mesh:
    """Build a (dp, chains) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // chains
    if dp < 1 or chains < 1 or dp * chains > n:
        raise ValueError(
            f"dp*chains = {dp}*{chains} does not fit {n} device(s) "
            "(each axis needs at least 1 device)")
    dev_array = np.asarray(devices[: dp * chains]).reshape(dp, chains)
    return Mesh(dev_array, axis_names=("dp", "chains"))


def _tree_psum_over(tree, axes):
    return jax.tree.map(lambda leaf: jax.lax.psum(leaf, axes), tree)


def make_dqbm_sharded_step(model: "dqbm_mod.DiscQBM", mesh: Mesh):
    """Sharded training step for the flat Disc_QBM.

    Signature matches ``DiscQBM._step``: (params, x, y, mask, lr, key) →
    (params, nll, err).  Batch dims are sharded over 'dp'; each device
    anneals ``sample_count / chains`` reads; moment sums ride the interconnect via
    a single psum over ('dp', 'chains').

    Deviation from the single-device step: the restricted-mode analytic
    linear-QUBO shortcut (``dqbm.py`` ``use_linear_shortcut``) is not
    taken here — clamped QUBOs are always sampled.  Statistically
    equivalent (the shortcut is exact sampling of the same linear
    problem); only the per-step cost differs.
    """
    n_chains = mesh.shape["chains"]
    reads_local = max(model.sample_count // n_chains, 1)
    n_out = model.n_output_nodes
    beta_eff = model.beta_eff
    one_hot = model.use_one_hot_encoding
    restricted = model.restricted
    sampler = model.sampler

    def local_step(params, x, y, mask, lr, key):
        dp_idx = jax.lax.axis_index("dp")
        ch_idx = jax.lax.axis_index("chains")
        key = jax.random.fold_in(jax.random.fold_in(key, dp_idx), ch_idx)
        y_vec = (
            jax.nn.one_hot(y.astype(jnp.int32), n_out)
            if one_hot
            else y.astype(jnp.float32)[:, None]
        )
        # structured shared-coupling call, exactly like the single-device
        # step (dqbm.py _build_step): couplings from the params, per-shard
        # examples as linear terms, both phases fused as TWO groups — so
        # the anneal kernel serves the multi-device path too (a dense
        # materialization would make the epoch-scan decision probe a
        # different route than the step took).  Reference role: replicated
        # problems per anneal, ``src/embedding.py:193-223``.
        H = params.b_h.shape[0]
        Qu_sh = dqbm_mod.unclamped_qubo_shared(params, beta_eff)
        hu = dqbm_mod.unclamped_fields(params, x, beta_eff)
        n_u = Qu_sh.shape[-1]
        Qc_sh = dqbm_mod.clamped_qubo_shared(params, beta_eff)
        hc = dqbm_mod.clamped_fields(params, x, y_vec, beta_eff)
        Qc_pad = jnp.zeros((n_u, n_u), Qc_sh.dtype).at[:H, :H].set(Qc_sh)
        Q2 = jnp.stack([Qc_pad, Qu_sh])  # (2, n_u, n_u)
        h2 = jnp.stack([jnp.pad(hc, ((0, 0), (0, n_u - H))), hu])  # (2, B, n_u)
        from qbmx.samplers.api import sampler_sample_groups

        s_all = sampler_sample_groups(sampler, key, Q2, h2, reads_local)
        s_c = s_all[0, :, :, :H]
        s_u = s_all[1]

        mc = dqbm_mod.clamped_moments(s_c, x, y_vec)
        mu = dqbm_mod.unclamped_moments(s_u, x, n_out)
        diff = jax.tree.map(lambda a, b: a - b, mc, mu)

        # local masked SUM over the batch shard (mean taken after psum)
        def wsum(leaf):
            m = mask.reshape((-1,) + (1,) * (leaf.ndim - 1))
            return (leaf * m).sum(axis=0)

        local_sums = jax.tree.map(wsum, diff)
        # chains average + dp batch-sum in one reduction
        global_sums = _tree_psum_over(local_sums, ("dp", "chains"))
        denom = jax.lax.psum(mask.sum(), "dp") * n_chains
        grad = jax.tree.map(lambda s: s / jnp.maximum(denom, 1.0), global_sums)
        if restricted:
            grad = dataclasses.replace(grad, w_hh=jnp.zeros_like(grad.w_hh))
        if model.grad_clip > 0.0:
            # replicated grad (post-psum) → safe to clip per-device
            from qbmx.models.base import clip_by_global_norm

            grad = clip_by_global_norm(grad, model.grad_clip)
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grad)

        probs = dqbm_mod.output_probs_from_samples(s_u, n_out, one_hot)
        p = jnp.take_along_axis(probs, y[:, None].astype(jnp.int32), axis=1)[:, 0]
        nll_sum = jax.lax.psum((-jnp.log(p + 1e-12) * mask).sum(), ("dp", "chains"))
        nll = nll_sum / jnp.maximum(denom, 1.0)
        return new_params, nll, grad.b_o.mean()

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P("dp"), P("dp"), P("dp"), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_cdqbm_sharded_step(model: "cdqbm_mod.CDQBM", mesh: Mesh):
    """Sharded training step for the CDQBM — same (dp, chains) layout."""
    n_chains = mesh.shape["chains"]
    reads_local = max(model.sample_count // n_chains, 1)
    geo = model.geo
    sampler = model.sampler
    one_hot = model.use_one_hot_encoding

    def local_step(params, x_imgs, y, mask, lr, key):
        dp_idx = jax.lax.axis_index("dp")
        ch_idx = jax.lax.axis_index("chains")
        key = jax.random.fold_in(jax.random.fold_in(key, dp_idx), ch_idx)
        y_vec = (
            jax.nn.one_hot(y.astype(jnp.int32), geo.n_out)
            if one_hot
            else y.astype(jnp.float32)[:, None]
        )
        # structured shared-coupling call, like cdqbm.py's _step_fn: the
        # (at the 717-var CDQBM shape) ~2 MB/example of redundant dense J
        # never materializes, and the anneal kernel serves the
        # multi-device path too
        nh, nt = geo.n_hidden, geo.n_total
        Qc_sh = model.clamped_qubo_shared(params)  # (nh, nh)
        Qu_sh = model.unclamped_qubo_shared(params)  # (nt, nt)
        hc = jax.vmap(lambda xi, yi: model.clamped_fields(params, xi, yi))(x_imgs, y_vec)
        hu = jax.vmap(lambda xi: model.unclamped_fields(params, xi))(x_imgs)
        Qc_pad = jnp.zeros((nt, nt), Qc_sh.dtype).at[:nh, :nh].set(Qc_sh)
        Q2 = jnp.stack([Qc_pad, Qu_sh])  # (2, nt, nt)
        h2 = jnp.stack([jnp.pad(hc, ((0, 0), (0, nt - nh))), hu])  # (2, B, nt)
        from qbmx.samplers.api import sampler_sample_groups

        s_all = sampler_sample_groups(sampler, key, Q2, h2, reads_local)
        s_c = s_all[0, :, :, :nh]
        s_u = s_all[1]
        mc = jax.vmap(lambda s, xi, yi: model._moments(params, s, xi, yi))(s_c, x_imgs, y_vec)
        mu = jax.vmap(lambda s, xi: model._moments(params, s, xi))(s_u, x_imgs)
        diff = jax.tree.map(lambda a, b: a - b, mc, mu)

        def wsum(leaf):
            m = mask.reshape((-1,) + (1,) * (leaf.ndim - 1))
            return (leaf * m).sum(axis=0)

        global_sums = _tree_psum_over(jax.tree.map(wsum, diff), ("dp", "chains"))
        denom = jax.lax.psum(mask.sum(), "dp") * n_chains
        grad = jax.tree.map(lambda s: s / jnp.maximum(denom, 1.0), global_sums)
        if model.is_restricted:
            grad = dataclasses.replace(
                grad, w_seq_intra=tuple(jnp.zeros_like(w) for w in grad.w_seq_intra)
            )
        if model.hidden_bias_type == "none":
            grad = dataclasses.replace(grad, b_conv=jnp.zeros_like(grad.b_conv))
        if model.grad_clip > 0.0:
            # replicated grad (post-psum) → safe to clip per-device
            from qbmx.models.base import clip_by_global_norm

            grad = clip_by_global_norm(grad, model.grad_clip)
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grad)

        probs = model._probs_from_samples(s_u)
        p = jnp.take_along_axis(probs, y[:, None].astype(jnp.int32), axis=1)[:, 0]
        nll_sum = jax.lax.psum((-jnp.log(p + 1e-12) * mask).sum(), ("dp", "chains"))
        nll = nll_sum / jnp.maximum(denom, 1.0)
        return new_params, nll, grad.b_o.mean()

    sharded = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P("dp"), P("dp"), P("dp"), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def shard_model(model, mesh: Mesh):
    """Swap the model's single-device step for a mesh-sharded one, in place.
    Training code (qbmx.train.loop) is oblivious — it keeps calling
    ``train_for_one_iteration``; batch rows must be divisible by the dp size."""
    from qbmx.samplers.api import sampler_jit_safe

    if not sampler_jit_safe(model.sampler):
        raise TypeError(
            "sharded steps trace the sampler inside jit; the model's sampler "
            "declares jit_safe=False (host-bound)"
        )
    if isinstance(model, dqbm_mod.DiscQBM):
        # the sharded step never takes the restricted linear shortcut (see
        # make_dqbm_sharded_step) — it always fuses both phases as TWO
        # structured groups, so the epoch-scan decision must probe groups=2.
        # Shadow the probe hook on the INSTANCE rather than rewriting the
        # user-visible use_linear_shortcut flag (the model's configuration
        # must survive sharding intact; only the step's route changed)
        model._sampler_call_groups = lambda: 2
        model._step = make_dqbm_sharded_step(model, mesh)
    elif isinstance(model, cdqbm_mod.CDQBM):
        model._step = make_cdqbm_sharded_step(model, mesh)
    else:
        raise TypeError(f"no sharded step for {type(model)!r}")
    # whole-epoch launch closures capture _step — drop any built before the
    # swap so train_epoch re-derives them over the sharded step
    for attr in ("_epoch_scan_fn", "_epoch_unrolled"):
        if hasattr(model, attr):
            delattr(model, attr)
    model.mesh = mesh
    return model

"""Coreset selection: k-center-greedy subsampling, in JAX.

Capability parity with the reference ``src/coreset.py`` (torch-based
``k_center_greedy``, ``:28-106``; ``downsample_kcenter_with_light_model``,
``:109-121``; ``random_downsampling``, ``:123-140``) — rebuilt as a jitted
``lax.fori_loop`` over the budget with an O(N) running min-distance vector
instead of the reference's O(budget × N) distance matrix rows.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("num_new",))
def _k_center_greedy_jax(emb: jax.Array, num_new: int, seeds: jax.Array) -> jax.Array:
    """Greedy max-min selection: returns ``num_new`` NEW indices into
    ``emb``, maximally spread relative to the ``seeds`` centers and to each
    other (running O(N) min-distance vector)."""
    n = emb.shape[0]
    sq = jnp.sum(emb * emb, axis=1)

    def dist_to(idx):
        c = emb[idx]
        d2 = sq + jnp.dot(c, c) - 2.0 * (emb @ c)
        return jnp.sqrt(jnp.clip(d2, 1e-12))

    def seed_body(i, mins):
        s = seeds[i]
        return jnp.minimum(mins, dist_to(s)).at[s].set(-jnp.inf)

    mins0 = jax.lax.fori_loop(
        0, seeds.shape[0], seed_body, jnp.full((n,), jnp.inf, jnp.float32))
    selected0 = jnp.zeros((num_new,), dtype=jnp.int32)

    def body(i, carry):
        mins, selected = carry
        p = jnp.argmax(mins)
        selected = selected.at[i].set(p.astype(jnp.int32))
        mins = jnp.minimum(mins, dist_to(p)).at[p].set(-jnp.inf)
        return mins, selected

    _, selected = jax.lax.fori_loop(0, num_new, body, (mins0, selected0))
    return selected


def k_center_greedy(embedding_matrix, budget: int, random_seed=None, index=None,
                    already_selected=None):
    """Greedy k-center selection over row embeddings.

    Returns exactly ``min(budget, n)`` sorted indices (through ``index`` if
    given) — the reference's net behavior: its internal ``budget += 1``
    (``src/coreset.py:41``) is consumed by the ``mins[select_mask] = +inf``
    quirk (``:91``) that makes the first greedy argmax re-pick an existing
    center, so it too ends with exactly ``budget`` distinct points.  ALL
    ``already_selected`` entries count as centers (distance-initialized and
    included in the result), matching the reference's ``select_mask``
    handling; if they already meet the budget they are returned as-is.
    """
    emb = jnp.asarray(np.asarray(embedding_matrix), dtype=jnp.float32)
    n = emb.shape[0]
    budget = min(budget, n)
    if index is not None:
        index = np.asarray(index)
        assert len(index) == n
    else:
        index = np.arange(n)
    rng = np.random.default_rng(random_seed)
    if already_selected:
        seeds = sorted({int(s) for s in already_selected})
    else:
        seeds = [int(rng.integers(0, n))]
    num_new = budget - len(seeds)
    if num_new <= 0:
        return index[np.asarray(seeds)]
    sel = np.asarray(_k_center_greedy_jax(
        emb, num_new, jnp.asarray(seeds, dtype=jnp.int32)))
    return index[np.unique(np.concatenate([np.asarray(seeds), sel]))]


def downsample_kcenter_with_light_model(qbm, train_x, train_y, budget: int, random_seed: int):
    """Select a coreset in the model's last-hidden embedding space
    (reference ``src/coreset.py:109-121``)."""
    emb = qbm.get_last_hidden_embedding(train_x)
    idx = k_center_greedy(emb, budget=budget, random_seed=random_seed)
    return np.asarray(train_x)[idx], np.asarray(train_y)[idx]


def random_downsampling(x, y, downsample_size: int, seed: int = 42):
    if len(x) < downsample_size:
        raise ValueError(
            "Downsample size must be less than the number of samples in the dataset."
        )
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(x), downsample_size, replace=False)
    return np.asarray(x)[idx], np.asarray(y)[idx]

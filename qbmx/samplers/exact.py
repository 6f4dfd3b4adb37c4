"""Exact Boltzmann oracle for small QUBOs, plus the analytic linear solve.

The reference has no tests; its de-facto oracle is dwave-neal itself.  Here
the oracle is exact enumeration of all 2^n states for n ≤ ~20, which every
approximate sampler (SA, Gibbs, the anneal kernel) is validated against
(SURVEY.md §4 "implication for the rebuild").

``solve_linear_qubo`` replicates the reference's analytic shortcut for
purely-linear QUBOs (``src/model/faster_dqbm.py:41-54`` and
``src/qubo/sampler.py:10-17``): the ground state of a diagonal QUBO is
``s_i = 1 iff h_i < 0`` (ties broken uniformly at random).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from qbmx.core.qubo import qubo_energies


def enumerate_states(n: int) -> jax.Array:
    """All 2^n binary configurations as a (2^n, n) float32 array."""
    if n > 22:
        raise ValueError(f"enumeration of 2^{n} states is not tractable")
    idx = jnp.arange(2**n, dtype=jnp.uint32)
    bits = (idx[:, None] >> jnp.arange(n, dtype=jnp.uint32)[None, :]) & 1
    return bits.astype(jnp.float32)


def exact_boltzmann(Q: jax.Array, beta: float = 1.0):
    """Exact Boltzmann distribution of a QUBO at inverse temperature beta.

    Returns ``(states, probs, marginals, pair_moments)`` where
    ``marginals[i] = E[s_i]`` and ``pair_moments[i, j] = E[s_i s_j]``.
    """
    n = Q.shape[-1]
    states = enumerate_states(n)
    E = qubo_energies(Q, states)
    logp = -beta * E
    logp = logp - jax.scipy.special.logsumexp(logp)
    probs = jnp.exp(logp)
    # Oracle moments: explicit highest precision — the default matmul mode
    # truncates inputs to bf16 (even on CPU), and these marginals gate the
    # hardware-validation asserts (CLAUDE.md precision invariant).
    marginals = jnp.matmul(probs, states, precision="highest")
    pair = jnp.einsum("m,mi,mj->ij", probs, states, states,
                      precision="highest")
    return states, probs, marginals, pair


def exact_sample(key: jax.Array, Q: jax.Array, num_reads: int, beta: float = 1.0) -> jax.Array:
    """Draw ``num_reads`` exact Boltzmann samples (enumeration + categorical)."""
    states, probs, _, _ = exact_boltzmann(Q, beta)
    idx = jax.random.categorical(key, jnp.log(probs + 1e-30), shape=(num_reads,))
    return states[idx]


def solve_linear_qubo(key: jax.Array, h: jax.Array, num_reads: int) -> jax.Array:
    """Ground state of a linear (diagonal) QUBO, replicated ``num_reads`` times.

    Mirrors the reference semantics: s=1 for negative bias, s=0 for positive,
    uniform random for exact zeros — ONE shared coin per variable, broadcast
    across the reads, exactly like the reference's single random draw
    (``src/model/faster_dqbm.py:41-54``) and like ``DiscQBM``'s restricted
    clamped shortcut (``qbmx/models/dqbm.py`` linear_shortcut branch).
    """
    coin = jax.random.bernoulli(key, 0.5, h.shape).astype(jnp.float32)
    base = jnp.where(h < 0, 1.0, jnp.where(h > 0, 0.0, coin)).astype(jnp.float32)
    return jnp.broadcast_to(base[None], (num_reads,) + h.shape).astype(jnp.float32)

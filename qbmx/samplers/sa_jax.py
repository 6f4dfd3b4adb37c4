"""Batched simulated annealing in pure JAX.

JAX replacement for dwave-neal's C++ ``SimulatedAnnealingSampler``
(invoked at ``src/model/faster_dqbm.py:299-313`` and
``src/qubo/sampler.py:26-33`` in the reference).  Design per SURVEY.md §7
"hard parts": single-spin Metropolis is sequential *within* a sweep, so
parallelism comes from running all chains (reads) of all problems in a batch
simultaneously — every sequential step updates one variable across the whole
``(batch, reads)`` block at once, instead of the reference's 10-process
fan-out of identical chains (which even reused one seed for all workers,
``src/model/faster_dqbm.py:580-589``; here every chain folds its own PRNG
key).

The schedule is a geometric beta ramp like neal's; parity target is matched
sample statistics, not bitwise-equal streams (SURVEY.md §7).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from qbmx.core.qubo import default_beta_range, geometric_beta_schedule, split_qubo


def _metropolis_sweep(s, u, beta, h, J):
    """One full sweep: sequentially Metropolis-update each variable across all chains.

    s: (R, n) current states in {0,1}; u: (n, R) per-variable uniforms;
    beta: scalar inverse temperature; h: (n,), J: (n, n) symmetric, zero diag.

    Acceptance uses the log-threshold form: ``u < exp(-beta*max(delta,0))``
    is exactly ``delta < -log(u)/beta`` for u in [0,1) and beta > 0, so the
    thresholds are precomputed ONCE per sweep and each variable step costs
    one compare instead of exp+max+compare.  The anneal kernel uses the
    SAME formulation (the CI debug tests lock the two bit-for-bit)."""
    n = h.shape[0]
    thresh = -jnp.log(u) / beta  # (n, R)

    def body(i, s):
        field = h[i] + jnp.dot(s, J[i], precision="highest")  # (R,) local field of variable i in every chain
        delta = (1.0 - 2.0 * s[:, i]) * field
        accept = delta < thresh[i]
        return s.at[:, i].set(jnp.where(accept, 1.0 - s[:, i], s[:, i]))

    return jax.lax.fori_loop(0, n, body, s)


@partial(jax.jit, static_argnames=("num_reads", "num_sweeps"))
def sa_sample(
    key: jax.Array,
    Q: jax.Array,
    num_reads: int,
    num_sweeps: int,
    beta_range: tuple[jax.Array, jax.Array] | None = None,
) -> jax.Array:
    """Sample one QUBO: ``Q`` (n, n) → samples (num_reads, n) float32 in {0,1}.

    Each read is an independent annealing chain (matching neal's
    ``num_reads`` restarts × ``num_sweeps`` sweeps semantics).
    """
    n = Q.shape[-1]
    h, J = split_qubo(Q)
    if beta_range is None:
        beta_hot, beta_cold = default_beta_range(Q)
    else:
        beta_hot, beta_cold = beta_range
    betas = geometric_beta_schedule(beta_hot, beta_cold, num_sweeps)

    key_init, key_run = jax.random.split(key)
    s0 = jax.random.bernoulli(key_init, 0.5, (num_reads, n)).astype(jnp.float32)
    sweep_keys = jax.random.split(key_run, num_sweeps)

    def step(s, xs):
        beta, k = xs
        u = jax.random.uniform(k, (n, num_reads))
        return _metropolis_sweep(s, u, beta, h, J), None

    s, _ = jax.lax.scan(step, s0, (betas, sweep_keys))
    return s


@partial(jax.jit, static_argnames=("num_reads", "num_sweeps"))
def sa_sample_batch(
    key: jax.Array,
    Q: jax.Array,
    num_reads: int,
    num_sweeps: int,
) -> jax.Array:
    """Sample a batch of QUBOs: ``Q`` (B, n, n) → samples (B, num_reads, n).

    The entire batch anneals in one compiled computation — the per-variable
    sequential step becomes a batched matvec over the full (B, R) chain
    block, which is where the device wins over the reference's per-example
    process-pool loop (2·N sampler invocations per epoch, SURVEY.md §3.2).

    ``key`` may be a single key (split per problem internally) or a (B,)
    key array — one key PER problem, so a problem's noise stream is
    independent of its position in the batch (seed-parallel sweeps use
    this for per-seed trajectory reproducibility, VERDICT r2 #8).
    """
    B = Q.shape[0]
    keys = key if key.ndim else jax.random.split(key, B)
    return jax.vmap(lambda k, q: sa_sample(k, q, num_reads, num_sweeps))(keys, Q)

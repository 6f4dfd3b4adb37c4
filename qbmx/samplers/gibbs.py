"""Heat-bath (Gibbs) samplers for QUBOs.

JAX replacement for the reference's local ``BoltzmannSampler``
("BMS" solver, ``src/model/faster_dqbm.py:622-653``): chains are warmed up
with a geometric inverse-temperature ramp ending at the target beta (the
reference "reach equilibrium i.e. anneal with temperature schedule",
comment at ``src/model/faster_dqbm.py:631``), then one configuration per
chain is returned.  Unlike Metropolis SA, the heat-bath update draws each
variable directly from its conditional ``p(s_i=1 | rest) = σ(-β·field_i)``,
which mixes faster at fixed temperature.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from qbmx.core.qubo import default_beta_range, geometric_beta_schedule, split_qubo


def _heat_bath_sweep(s, u, beta, h, J):
    """One sequential heat-bath sweep across all chains. Shapes as in sa_jax.

    Acceptance uses the threshold form: ``u < σ(-beta*field)`` is exactly
    ``field < (log(1-u) - log(u))/beta`` for u ∈ [0,1) and beta > 0, so the
    thresholds are precomputed ONCE per sweep and each variable step costs
    one compare instead of sigmoid+compare.  The anneal kernel uses the
    SAME formulation (the CI debug tests lock the two bit-for-bit)."""
    n = h.shape[0]
    thresh = (jnp.log(1.0 - u) - jnp.log(u)) / beta  # (n, R)

    def body(i, s):
        field = h[i] + jnp.dot(s, J[i], precision="highest")  # (R,)
        return s.at[:, i].set((field < thresh[i]).astype(s.dtype))

    return jax.lax.fori_loop(0, n, body, s)


def _pair_heat_bath_sweep(s, u, beta, h, J):
    """One sequential PAIR-Gibbs sweep: consecutive variable pairs
    (0,1),(2,3),… are jointly resampled from their exact 4-state
    conditional (a trailing odd variable gets a single heat-bath draw).
    Halves the sequential depth per sweep.  Preserves the
    Boltzmann distribution (sequential-scan Gibbs on pair blocks).

    Uniform consumption: pair (i, i+1) draws from ``u[i]``; the anneal
    kernel consumes identically (CI debug tests lock the two).
    """
    n = h.shape[0]

    def pair_body(q, s):
        i = 2 * q
        f1 = h[i] + jnp.dot(s, J[i], precision="highest")  # (R,)
        f2 = h[i + 1] + jnp.dot(s, J[i + 1], precision="highest")
        c = J[i, i + 1]
        f1p = f1 - c * s[:, i + 1]  # fields excluding the partner
        f2p = f2 - c * s[:, i]
        e01 = -beta * f2p
        e10 = -beta * f1p
        e11 = -beta * (f1p + f2p + c)
        m = jnp.maximum(jnp.maximum(e01, e10), jnp.maximum(e11, 0.0))
        w00 = jnp.exp(-m)
        w01 = jnp.exp(e01 - m)
        w10 = jnp.exp(e10 - m)
        w11 = jnp.exp(e11 - m)
        Z = w00 + w01 + w10 + w11
        t = u[i] * Z
        cum2 = w00 + w01
        cum3 = cum2 + w10
        new1 = (t >= cum2).astype(s.dtype)
        new2 = (((t >= w00) & (t < cum2)) | (t >= cum3)).astype(s.dtype)
        return s.at[:, i].set(new1).at[:, i + 1].set(new2)

    s = jax.lax.fori_loop(0, n // 2, pair_body, s)
    if n % 2:
        i = n - 1
        f = h[i] + jnp.dot(s, J[i], precision="highest")
        # u < σ(-βf) ⟺ u·(1 + exp(βf)) < 1 (inf-safe: overflow → stay 0)
        w = jnp.exp(beta * f)
        s = s.at[:, i].set((u[i] * (1.0 + w) < 1.0).astype(s.dtype))
    return s


# quad state index s = b1·8 + b2·4 + b3·2 + b4 (MSB = lowest variable);
# the six intra-quad coupling pairs in lexicographic order
_QUAD_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _quad_heat_bath_sweep(s, u, beta, h, J):
    """One sequential QUAD-Gibbs sweep: variable quadruples
    (0..3),(4..7),… are jointly resampled from their exact 16-state
    conditional; a remainder of 2–3 variables gets one pair draw (and a
    trailing odd variable a single heat-bath draw).  Quarter the
    sequential depth per sweep of single-variable sweeps, at 4× the
    per-sub-step element work.  Preserves the Boltzmann distribution
    (sequential-scan Gibbs on quad blocks).

    Uniform consumption: quad (i..i+3) draws from ``u[i]``; remainder
    pair (i, i+1) from ``u[i]``; trailing single from ``u[n-1]``.
    """
    n = h.shape[0]

    def quad_body(q, s):
        i = 4 * q
        f = [h[i + a] + jnp.dot(s, J[i + a], precision="highest")
             for a in range(4)]  # (R,) each
        c = {(a, b): J[i + a, i + b] for a, b in _QUAD_PAIRS}
        fp = []
        for a in range(4):
            fa = f[a]
            for b in range(4):
                if b != a:
                    fa = fa - c[(min(a, b), max(a, b))] * s[:, i + b]
            fp.append(fa)
        es = [jnp.zeros_like(fp[0])]
        for idx in range(1, 16):
            bits = [(idx >> (3 - a)) & 1 for a in range(4)]
            acc = None
            for a in range(4):
                if bits[a]:
                    acc = fp[a] if acc is None else acc + fp[a]
            for a, b in _QUAD_PAIRS:
                if bits[a] and bits[b]:
                    acc = acc + c[(a, b)]
            es.append(-beta * acc)
        m = es[1]
        for idx in range(2, 16):
            m = jnp.maximum(m, es[idx])
        m = jnp.maximum(m, 0.0)
        ws = [jnp.exp(e - m) for e in es]
        cum = ws[0]
        cums = [cum]
        for idx in range(1, 16):
            cum = cum + ws[idx]
            cums.append(cum)
        t = u[i] * cums[15]
        sel = jnp.zeros_like(t, dtype=jnp.int32)
        for idx in range(15):
            sel = sel + (t >= cums[idx]).astype(jnp.int32)
        for a in range(4):
            bit = jnp.bitwise_and(jnp.right_shift(sel, 3 - a), 1)
            s = s.at[:, i + a].set(bit.astype(s.dtype))
        return s

    nq = n // 4
    s = jax.lax.fori_loop(0, nq, quad_body, s)
    r = n - 4 * nq
    if r >= 2:  # remainder pair — identical math to _pair_heat_bath_sweep
        i = 4 * nq
        f1 = h[i] + jnp.dot(s, J[i], precision="highest")
        f2 = h[i + 1] + jnp.dot(s, J[i + 1], precision="highest")
        c = J[i, i + 1]
        f1p = f1 - c * s[:, i + 1]
        f2p = f2 - c * s[:, i]
        e01 = -beta * f2p
        e10 = -beta * f1p
        e11 = -beta * (f1p + f2p + c)
        m = jnp.maximum(jnp.maximum(e01, e10), jnp.maximum(e11, 0.0))
        w00 = jnp.exp(-m)
        w01 = jnp.exp(e01 - m)
        w10 = jnp.exp(e10 - m)
        w11 = jnp.exp(e11 - m)
        Z = w00 + w01 + w10 + w11
        t = u[i] * Z
        cum2 = w00 + w01
        cum3 = cum2 + w10
        new1 = (t >= cum2).astype(s.dtype)
        new2 = (((t >= w00) & (t < cum2)) | (t >= cum3)).astype(s.dtype)
        s = s.at[:, i].set(new1).at[:, i + 1].set(new2)
    if r % 2:
        i = n - 1
        f = h[i] + jnp.dot(s, J[i], precision="highest")
        w = jnp.exp(beta * f)
        s = s.at[:, i].set((u[i] * (1.0 + w) < 1.0).astype(s.dtype))
    return s


@partial(jax.jit, static_argnames=("num_reads", "num_warmup", "pair", "quad"))
def gibbs_sample(
    key: jax.Array,
    Q: jax.Array,
    num_reads: int,
    num_warmup: int = 32,
    beta: float = 1.0,
    pair: bool = False,
    quad: bool = False,
) -> jax.Array:
    """Draw ``num_reads`` approximate Boltzmann samples at inverse temp ``beta``.

    Each read is its own chain: annealed from a hot start down to ``beta``
    over ``num_warmup`` sweeps, then read out once (independent chains, no
    autocorrelation between reads).  ``pair``/``quad`` pick the joint
    update width (2- or 4-variable exact conditionals; quad wins).
    """
    n = Q.shape[-1]
    h, J = split_qubo(Q)
    beta_hot, _ = default_beta_range(Q)
    beta_hot = jnp.minimum(beta_hot, beta)
    betas = geometric_beta_schedule(beta_hot, jnp.asarray(beta), num_warmup)

    key_init, key_run = jax.random.split(key)
    s0 = jax.random.bernoulli(key_init, 0.5, (num_reads, n)).astype(jnp.float32)
    sweep_keys = jax.random.split(key_run, num_warmup)
    sweep = (_quad_heat_bath_sweep if quad
             else _pair_heat_bath_sweep if pair else _heat_bath_sweep)

    def step(s, xs):
        b, k = xs
        u = jax.random.uniform(k, (n, num_reads))
        return sweep(s, u, b, h, J), None

    s, _ = jax.lax.scan(step, s0, (betas, sweep_keys))
    return s


@partial(jax.jit, static_argnames=("num_reads", "num_warmup", "pair", "quad"))
def gibbs_sample_batch(
    key: jax.Array,
    Q: jax.Array,
    num_reads: int,
    num_warmup: int = 32,
    beta: float = 1.0,
    pair: bool = False,
    quad: bool = False,
) -> jax.Array:
    """Batched variant: ``Q`` (B, n, n) → samples (B, num_reads, n).
    ``key``: single key, or a (B,) key array (one per problem — position-
    independent noise streams for seed-parallel sweeps)."""
    B = Q.shape[0]
    keys = key if key.ndim else jax.random.split(key, B)
    return jax.vmap(
        lambda k, q: gibbs_sample(k, q, num_reads, num_warmup, beta, pair,
                                  quad)
    )(keys, Q)

"""Pallas (Triton) anneal kernel for shared-coupling QUBO batches.

Every qbmx QUBO family shares its COUPLINGS across a group of problems:
the off-diagonal blocks come from model parameters, while only the LINEAR
terms vary per example (clamped visibles enter as fields —
``qbmx.models.dqbm.clamped_qubo``, ``qbmx.models.cdqbm.CDQBM.clamped_qubo``).
Models therefore hand the sampler ``Q_shared`` (G, n, n) plus ``h_extra``
(G, B, n); the effective QUBO of problem (g, b) is
``Q_shared[g] + diag(h_extra[g, b])``.  A dense batch is the special case
of one problem per group.

**Layout.**  One chain — a (problem, read) pair — per lane.  A program
owns ``block`` consecutive reads of ONE problem, so the problem's linear
terms, beta schedule and key are scalars of the program, and the group's
couplings are scalar loads broadcast to every lane (a group's J is at most
``MAX_N``² floats = 16 KB, so it stays in L1).  Each lane keeps its n
spins and its n local fields in registers.  All S sweeps × n updates run
inside one launch; nothing returns to device memory until the final state.

**Incremental fields.**  A single-variable step compares the stored field
with a threshold and, where the spin flips, adds ``J[j, i]·Δs`` to every
other field.  Those n-1 FMAs are independent of each other, so the
dependent chain between two steps is one compare, one select and one FMA
rather than an n-term dot product.  Fields are float32 throughout (no
TF32 anywhere: there is no matrix product).

**Randomness.**  A counter-based generator inside the kernel, keyed per
PROBLEM: two uint32 words drawn from the problem's ``jax.random`` key,
mixed with the read index into a per-lane key, then hashed with the
(sweep, variable) counter.  A problem's samples therefore depend on its
own key alone, never on its position in the batch or on the batch
composition — the same stream semantics as the XLA samplers.
:func:`draw_bits` is the one definition used by the kernel and by the
tests that check it.

Update rules match ``sa_jax._metropolis_sweep`` / ``gibbs._heat_bath_sweep``
/ ``gibbs._pair_heat_bath_sweep`` (same threshold forms, same beta
schedule, same uniform consumption per sweep).  ``debug_randoms`` replaces
the generator with host-supplied variates so that ``interpret=True`` runs
the kernel on the CPU against those sweeps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from qbmx.core.qubo import split_qubo

# Shape rule: the kernel takes QUBOs with n <= MAX_N.  A chain holds 2n
# float32 registers (spins + fields) and a step unrolls n-1 field updates,
# so larger problems spill; they run on the XLA samplers instead.
MAX_N = 64
# Problems padded to at most this many rows unroll their variable loop.
UNROLL_N_PAD = 16
# Reads per program.  Blocks of 32, 64 and 128 reads measured the same at
# the n=41 shape; 128 (four warps) fills the card at the many-reads shapes.
READ_BLOCK = 128

_GOLD = 0x9E3779B9


def _mix32(x):
    """Bijective 32-bit avalanche (two-multiply xorshift finalizer)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x21F0AAAD)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x735A2D97)
    return x ^ (x >> 15)


def lane_key(k0, k1, read):
    """Per-chain key from the problem's two key words and the read index."""
    return _mix32(k0 ^ _mix32(k1 + read * jnp.uint32(_GOLD)))


def draw_bits(lkey, k1, ctr):
    """32 random bits for counter ``ctr`` of the chain keyed ``lkey``.

    Counters: ``t * n + i`` for the uniform of variable i in sweep t, and
    ``num_sweeps * n + i`` for the initial spin of variable i."""
    return _mix32(_mix32(lkey ^ ctr) + k1)


def bits_to_uniform(bits):
    """Top 24 bits → float32 uniform in [0, 1)."""
    return (bits >> 8).astype(jnp.int32).astype(jnp.float32) * jnp.float32(2.0**-24)


def bits_to_spin(bits):
    """Top bit → float32 spin in {0, 1}."""
    return (bits >> 31).astype(jnp.int32).astype(jnp.float32)


def problem_key_words(keys):
    """(P,) jax.random keys → (P, 2) uint32 words that seed the kernel."""
    return jax.vmap(lambda k: jax.random.bits(k, (2,), jnp.uint32))(keys)


def _kernel(keys_ref, J_ref, h_ref, sched_ref, *rest, n, num_sweeps,
            num_problems, block, rule, pair, debug):
    """One (problem, read-block) program; see the module docstring.

    State: spins ``S`` and local fields ``F``, each (n_pad, block) float32
    — a lane's column lives in that lane's registers.  Variable ``i`` is
    picked out of a column with a row mask (a per-lane reduction)."""
    if debug:
        init_ref, u_ref, out_ref = rest
    else:
        (out_ref,) = rest
    n_pad = J_ref.shape[-1]
    gb = pl.program_id(0)
    c = pl.program_id(1)
    g = lax.div(gb, jnp.int32(num_problems))
    lanes = pl.ds(c * block, block)
    rows = lax.broadcasted_iota(jnp.int32, (n_pad, 1), 0)

    k0 = keys_ref[gb, 0]
    k1 = keys_ref[gb, 1]
    reads = (c * block + lax.broadcasted_iota(jnp.int32, (block,), 0)
             ).astype(jnp.uint32)
    lk = lane_key(k0, k1, reads)

    def loop(lo, hi, body, carry):
        """``lax.fori_loop`` over variables; unrolled for small problems,
        where static indices turn every row pick into a register move."""
        if n_pad > UNROLL_N_PAD:
            return lax.fori_loop(lo, hi, body, carry)
        for i in range(lo, hi):
            carry = body(jnp.int32(i), carry)
        return carry

    def row(A, i):
        return jnp.sum(jnp.where(rows == i, A, 0.0), axis=0)

    def flip(S, F, i, ds):
        """Spin i changes by ``ds`` (block,): update S and every field."""
        S = jnp.where(rows == i, S + ds[None, :], S)
        F = F + J_ref[g, i, pl.ds(0, n_pad)][:, None] * ds[None, :]
        return S, F

    if debug:
        S0 = init_ref[gb, pl.ds(0, n_pad), lanes]
    else:
        ctr = (rows + num_sweeps * n).astype(jnp.uint32)
        S0 = bits_to_spin(draw_bits(lk[None, :], k1, ctr))
        S0 = jnp.where(rows < n, S0, 0.0)
    # fields of the initial state, built by flipping each spin in from 0
    h = h_ref[gb, pl.ds(0, n_pad)]
    F0 = jnp.broadcast_to(h[:, None], (n_pad, block))
    S, F = loop(
        0, n, lambda i, c: flip(c[0], c[1], i, row(S0, i)),
        (jnp.zeros((n_pad, block), jnp.float32), F0))

    log_hot = sched_ref[gb, 0]
    dlog = sched_ref[gb, 1]
    beta_cold = sched_ref[gb, 2]

    def sweep(t, carry):
        if num_sweeps == 1:
            beta = beta_cold
        else:
            frac = t.astype(jnp.float32) / jnp.float32(num_sweeps - 1)
            beta = jnp.exp(log_hot + frac * dlog)
        base = (t * n).astype(jnp.uint32)

        def uniform(i):
            if debug:
                return u_ref[t, gb, i, lanes]
            return bits_to_uniform(draw_bits(lk, k1, base + i.astype(jnp.uint32)))

        def single(i, carry):
            S, F = carry
            s, f, u = row(S, i), row(F, i), uniform(i)
            if rule == "metropolis":
                thr = -jnp.log(u) / beta
                cdir = 1.0 - 2.0 * s
                ds = jnp.where(cdir * f < thr, cdir, 0.0)
            else:
                thr = (jnp.log(1.0 - u) - jnp.log(u)) / beta
                ds = (f < thr).astype(jnp.float32) - s
            return flip(S, F, i, ds)

        def pair_step(q, carry):
            S, F = carry
            i = 2 * q
            s1, s2 = row(S, i), row(S, i + 1)
            cpl = J_ref[g, i, i + 1]
            f1p = row(F, i) - cpl * s2  # fields excluding the partner
            f2p = row(F, i + 1) - cpl * s1
            e01 = -beta * f2p
            e10 = -beta * f1p
            e11 = -beta * (f1p + f2p + cpl)
            m = jnp.maximum(jnp.maximum(e01, e10), jnp.maximum(e11, 0.0))
            w00 = jnp.exp(-m)
            w01 = jnp.exp(e01 - m)
            w10 = jnp.exp(e10 - m)
            w11 = jnp.exp(e11 - m)
            tt = uniform(i) * (w00 + w01 + w10 + w11)
            cum2 = w00 + w01
            cum3 = cum2 + w10
            new1 = (tt >= cum2).astype(jnp.float32)
            new2 = (((tt >= w00) & (tt < cum2)) | (tt >= cum3)
                    ).astype(jnp.float32)
            S, F = flip(S, F, i, new1 - s1)
            return flip(S, F, i + 1, new2 - s2)

        if not pair:
            return loop(0, n, single, carry)
        carry = loop(0, n // 2, pair_step, carry)
        if n % 2:  # trailing odd variable: single heat-bath draw
            S, F = carry
            i = jnp.int32(n - 1)
            w = jnp.exp(beta * row(F, i))  # u < σ(-βf) ⟺ u·(1+exp(βf)) < 1
            new = (uniform(i) * (1.0 + w) < 1.0).astype(jnp.float32)
            carry = flip(S, F, i, new - row(S, i))
        return carry

    S, _ = lax.fori_loop(0, num_sweeps, sweep, (S, F))
    out_ref[gb, pl.ds(0, n_pad), lanes] = S


def default_schedule(hs, J, h_extra):
    """Per-problem ``default_beta_range`` of the effective dense QUBOs
    ``Q_shared[g] + diag(h_extra[g, b])`` without materialising them
    (J is shared; only |h| varies).  Returns (hot, cold), each (G, B)."""
    G = J.shape[0]
    h_all = hs[:, None, :] + h_extra
    absJ = jnp.sum(jnp.abs(J), axis=-1)  # (G, n)
    max_delta = jnp.max(jnp.abs(h_all) + absJ[:, None, :], axis=-1)
    hmag = jnp.abs(h_all)
    h_min = jnp.min(jnp.where(hmag > 0, hmag, jnp.inf), axis=-1)  # (G, B)
    jmag = jnp.abs(J).reshape(G, -1)
    j_min = jnp.min(jnp.where(jmag > 0, jmag, jnp.inf), axis=-1)  # (G,)
    min_delta = jnp.minimum(h_min, j_min[:, None])
    hot = jnp.where(max_delta > 0,
                    jnp.log(2.0) / jnp.maximum(max_delta, 1e-12), 0.1)
    cold = jnp.where(jnp.isfinite(min_delta),
                     jnp.log(100.0) / jnp.maximum(min_delta, 1e-12), 10.0)
    return hot, jnp.maximum(cold, hot * 1.0001)


def _pow2_at_least(x: int, lo: int) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def read_block(num_reads: int, block: int) -> int:
    """Lanes per program: ``block`` reads, or the next power of two >= the
    read count when that is smaller (Triton blocks are powers of two; at
    least one warp of 32)."""
    return _pow2_at_least(min(num_reads, block), 32)


@partial(jax.jit, static_argnames=("num_reads", "num_sweeps", "rule", "pair",
                                   "interpret"))
def anneal_groups(
    key: jax.Array,
    Q_shared: jax.Array,
    h_extra: jax.Array,
    num_reads: int,
    num_sweeps: int,
    rule: str = "metropolis",
    beta_hot=None,
    beta_cold=None,
    pair: bool = False,
    interpret: bool = False,
    debug_randoms=None,
) -> jax.Array:
    """Shared-coupling batched annealing → (G, B, num_reads, n) in {0, 1}.

    ``key``: one key (split into G·B problem keys, as the XLA samplers do)
    or G·B problem keys in group-major order.  ``rule``: ``"metropolis"``
    (SA) or ``"heatbath"`` (BMS); ``pair`` selects joint pair updates for
    the heat-bath rule.  ``beta_hot``/``beta_cold`` (G, B) override the
    per-problem geometric schedule; heat-bath callers pass only
    ``beta_cold`` (the target beta) and get the gibbs warmup ramp
    ``min(default_hot, beta) → beta``.

    ``debug_randoms``: ``(init01, uniforms)`` with shapes (G, B, R, n) and
    (S, G, B, n, R) — host variates in place of the in-kernel generator.
    """
    if pair and rule != "heatbath":
        raise ValueError("pair updates are defined for the heat-bath rule")
    G, n, _ = Q_shared.shape
    B = h_extra.shape[1]
    R = num_reads
    if n > MAX_N:
        raise ValueError(f"anneal kernel takes n <= {MAX_N}, got n={n}")
    hs, J = split_qubo(Q_shared.astype(jnp.float32))
    h_extra = h_extra.astype(jnp.float32)
    n_pad = _pow2_at_least(n, 2)
    pad = n_pad - n
    h_all = jnp.pad((hs[:, None, :] + h_extra).reshape(G * B, n),
                    ((0, 0), (0, pad)))

    if beta_hot is None or beta_cold is None:
        d_hot, d_cold = default_schedule(hs, J, h_extra)
        if rule == "heatbath" and beta_cold is not None and beta_hot is None:
            beta_hot = jnp.minimum(d_hot, jnp.asarray(beta_cold, jnp.float32))
        beta_hot = d_hot if beta_hot is None else beta_hot
        beta_cold = d_cold if beta_cold is None else beta_cold
    hot = jnp.broadcast_to(jnp.asarray(beta_hot, jnp.float32), (G, B))
    cold = jnp.broadcast_to(jnp.asarray(beta_cold, jnp.float32), (G, B))
    log_hot = jnp.log(hot)
    sched = jnp.stack([log_hot, jnp.log(cold) - log_hot, cold], axis=-1)
    sched = sched.reshape(G * B, 3)

    keys = key.reshape(-1) if key.ndim else jax.random.split(key, G * B)
    words = problem_key_words(keys)

    lb = read_block(R, READ_BLOCK)
    C = -(-R // lb)
    Rp = C * lb
    operands = [words, jnp.pad(J, ((0, 0), (0, pad), (0, pad))), h_all, sched]
    debug = debug_randoms is not None
    if debug:
        init01, uniforms = debug_randoms
        S = uniforms.shape[0]
        ini = jnp.swapaxes(init01.astype(jnp.float32).reshape(G * B, R, n), 1, 2)
        ini = jnp.pad(ini, ((0, 0), (0, pad), (0, Rp - R)))
        u = uniforms.astype(jnp.float32).reshape(S, G * B, n, R)
        u = jnp.pad(u, ((0, 0), (0, 0), (0, 0), (0, Rp - R)),
                    constant_values=0.5)
        operands += [ini, u]

    out = pl.pallas_call(
        partial(_kernel, n=n, num_sweeps=num_sweeps, num_problems=B,
                block=lb, rule=rule, pair=pair, debug=debug),
        grid=(G * B, C),
        out_shape=jax.ShapeDtypeStruct((G * B, n_pad, Rp), jnp.float32),
        compiler_params=pltriton.CompilerParams(num_warps=lb // 32,
                                                num_stages=1),
        interpret=interpret,
        name="qbmx_anneal",
    )(*operands)
    return jnp.swapaxes(out[:, :n, :R], 1, 2).reshape(G, B, R, n)

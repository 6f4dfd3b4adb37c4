"""Coverage of the Pallas anneal kernel (``qbmx.samplers.anneal_kernel``).

CPU tier: the kernel runs under ``interpret=True``.  With ``debug_randoms``
the initial spins and per-sweep uniforms are host inputs, and both update
rules (plus pair-Gibbs) are locked bit-for-bit against the XLA sweeps
(``sa_jax._metropolis_sweep`` / ``gibbs._heat_bath_sweep`` /
``gibbs._pair_heat_bath_sweep``) on the DENSE per-problem QUBOs the
structured (Q_shared, h_extra) call represents.  Without them the kernel's
own counter-based generator runs, and the same lock holds against the XLA
sweeps fed with that generator's variates.

GPU tier (``-m gpu``): the kernel compiled for the card, against the same
references and the exact oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qbmx.samplers.anneal_kernel as ak
from qbmx.core.qubo import (
    default_beta_range,
    geometric_beta_schedule,
    qubo_energies,
    random_qubo_batch,
    split_qubo,
)
from qbmx.samplers import api
from qbmx.samplers.anneal_kernel import anneal_groups
from qbmx.samplers.exact import enumerate_states, exact_boltzmann
from qbmx.samplers.gibbs import _heat_bath_sweep, _pair_heat_bath_sweep
from qbmx.samplers.sa_jax import _metropolis_sweep

RULES = {
    "metropolis": (dict(rule="metropolis"), _metropolis_sweep),
    "heatbath": (dict(rule="heatbath"), _heat_bath_sweep),
    "pair": (dict(rule="heatbath", pair=True), _pair_heat_bath_sweep),
}


def _problem(rng, G, B, n, reads, sweeps):
    Qg = random_qubo_batch(rng, G, n)
    h_extra = jnp.asarray(rng.normal(size=(G, B, n)).astype(np.float32))
    init01 = jnp.asarray((rng.random((G, B, reads, n)) < 0.5).astype(np.float32))
    uniforms = jnp.asarray(
        np.clip(rng.random((sweeps, G, B, n, reads)).astype(np.float32),
                1e-6, 1.0 - 1e-6)
    )
    return Qg, h_extra, init01, uniforms


def _dense(Qg, h_extra):
    return Qg[:, None, :, :] + jax.vmap(jax.vmap(jnp.diagflat))(h_extra)


def _ref_trajectory(sweep_fn, Qg, h_extra, init01, uniforms, hot, cold, S):
    """Run the dense XLA sweep per (group, problem) with the geometric
    schedule the kernel uses."""
    G, B = h_extra.shape[:2]
    out = np.zeros_like(np.asarray(init01))
    for g in range(G):
        h_s, J = split_qubo(Qg[g])
        for b in range(B):
            h = h_s + h_extra[g, b]
            betas = geometric_beta_schedule(hot[g, b], cold[g, b], S)
            s = init01[g, b]
            for t in range(S):
                s = sweep_fn(s, uniforms[t, g, b], betas[t], h, J)
            out[g, b] = np.asarray(s)
    return out


def _generator_variates(key, G, B, R, n, S):
    """The kernel generator's own (init01, uniforms), computed in plain jnp
    from the same per-problem keys the kernel derives."""
    keys = jax.random.split(key, G * B)
    words = ak.problem_key_words(keys)  # (P, 2)
    reads = jnp.arange(R, dtype=jnp.uint32)
    lk = ak.lane_key(words[:, :1], words[:, 1:], reads[None])  # (P, R)
    k1 = words[:, 1:, None]  # (P, 1, 1)
    lk3 = lk[:, None, :]  # (P, 1, R)
    i = jnp.arange(n, dtype=jnp.uint32)[None, :, None]
    init = ak.bits_to_spin(ak.draw_bits(lk3, k1, jnp.uint32(S * n) + i))
    u = jnp.stack([ak.bits_to_uniform(ak.draw_bits(lk3, k1, jnp.uint32(t * n) + i))
                   for t in range(S)])  # (S, P, n, R)
    init01 = jnp.swapaxes(init, 1, 2).reshape(G, B, R, n)
    return init01, u.reshape(S, G, B, n, R)


SHAPES = [
    (2, 3, 11, 7, 4),   # unrolled variable loop, odd n
    (1, 2, 8, 9, 3),    # n a power of two
    (2, 2, 21, 5, 3),   # looped variable loop (n_pad 32 > UNROLL_N_PAD)
    (1, 1, 3, 1, 3),    # minimal
]


@pytest.mark.parametrize("G,B,n,reads,sweeps", SHAPES)
@pytest.mark.parametrize("rule", ["metropolis", "heatbath"])
def test_debug_matches_xla_sweeps(rule, G, B, n, reads, sweeps):
    rng = np.random.default_rng(G * 1000 + n * 10 + reads)
    Qg, h_extra, init01, uniforms = _problem(rng, G, B, n, reads, sweeps)
    hot = jnp.full((G, B), 0.25)
    cold = jnp.full((G, B), 2.0)
    kw, sweep = RULES[rule]
    out = anneal_groups(jax.random.key(0), Qg, h_extra, reads, sweeps,
                        beta_hot=hot, beta_cold=cold, interpret=True,
                        debug_randoms=(init01, uniforms), **kw)
    ref = _ref_trajectory(sweep, Qg, h_extra, init01, uniforms, hot, cold, sweeps)
    np.testing.assert_array_equal(np.asarray(out), ref)


@pytest.mark.parametrize("G,B,n,reads,sweeps", [(2, 2, 11, 7, 4), (1, 2, 8, 9, 3)])
def test_pair_debug_matches_xla_pair_sweep(G, B, n, reads, sweeps):
    """Pair-Gibbs vs gibbs._pair_heat_bath_sweep, bit-for-bit (same uniform
    consumption: pair (i, i+1) draws from u[i]; odd n ends in a single
    heat-bath draw)."""
    rng = np.random.default_rng(42 + n)
    Qg, h_extra, init01, uniforms = _problem(rng, G, B, n, reads, sweeps)
    hot = jnp.full((G, B), 0.25)
    cold = jnp.full((G, B), 2.0)
    out = anneal_groups(
        jax.random.key(0), Qg, h_extra, reads, sweeps, rule="heatbath",
        beta_hot=hot, beta_cold=cold, pair=True, interpret=True,
        debug_randoms=(init01, uniforms),
    )
    ref = _ref_trajectory(_pair_heat_bath_sweep, Qg, h_extra, init01,
                          uniforms, hot, cold, sweeps)
    np.testing.assert_array_equal(np.asarray(out), ref)


@pytest.mark.parametrize("rule", ["metropolis", "heatbath", "pair"])
def test_generator_path_matches_xla_sweeps(rule):
    """Without host variates the kernel draws from its counter-based
    generator; fed the same variates (computed in plain jnp), the XLA
    sweeps reach the identical states.  Also pins the default schedules
    (metropolis: default_beta_range; heat-bath: min(hot, beta) → beta)."""
    G, B, n, R, S = 2, 2, 6, 40, 4
    rng = np.random.default_rng(3)
    Qg = random_qubo_batch(rng, G, n)
    h_extra = jnp.asarray(rng.normal(size=(G, B, n)).astype(np.float32))
    key = jax.random.key(11)
    kw, sweep = RULES[rule]
    if rule == "metropolis":
        out = anneal_groups(key, Qg, h_extra, R, S, interpret=True, **kw)
        hot, cold = default_beta_range(_dense(Qg, h_extra).reshape(G * B, n, n))
    else:
        beta = jnp.full((G, B), 1.0)
        out = anneal_groups(key, Qg, h_extra, R, S, beta_cold=beta,
                            interpret=True, **kw)
        hot, _ = default_beta_range(_dense(Qg, h_extra).reshape(G * B, n, n))
        hot, cold = jnp.minimum(hot, 1.0), jnp.ones_like(hot)
    init01, u = _generator_variates(key, G, B, R, n, S)
    ref = _ref_trajectory(sweep, Qg, h_extra, init01, u, hot.reshape(G, B),
                          cold.reshape(G, B), S)
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_default_schedule_matches_dense():
    """The structured default beta range equals default_beta_range on the
    densified per-problem QUBOs (same trajectories as the dense path)."""
    rng = np.random.default_rng(11)
    G, B, n, reads, sweeps = 2, 3, 10, 6, 4
    Qg, h_extra, init01, uniforms = _problem(rng, G, B, n, reads, sweeps)
    out = anneal_groups(
        jax.random.key(0), Qg, h_extra, reads, sweeps, rule="metropolis",
        interpret=True, debug_randoms=(init01, uniforms),
    )
    hot, cold = default_beta_range(_dense(Qg, h_extra).reshape(G * B, n, n))
    ref = _ref_trajectory(_metropolis_sweep, Qg, h_extra, init01, uniforms,
                          hot.reshape(G, B), cold.reshape(G, B), sweeps)
    np.testing.assert_array_equal(np.asarray(out), ref)


@pytest.mark.parametrize("debug", [True, False])
def test_read_blocks_are_pure_layout(monkeypatch, debug):
    """Splitting a problem's reads over several programs (block 32 → three
    programs for 70 reads) gives the same samples as one program: the
    generator is keyed by the read index, not by the program."""
    rng = np.random.default_rng(7)
    G, B, n, reads, sweeps = 1, 2, 9, 70, 3
    Qg, h_extra, init01, uniforms = _problem(rng, G, B, n, reads, sweeps)
    run = functools.partial(
        anneal_groups, jax.random.key(0), Qg, h_extra, reads, sweeps,
        rule="heatbath", beta_cold=jnp.ones((G, B)), interpret=True,
        debug_randoms=(init01, uniforms) if debug else None)
    assert ak.read_block(reads, ak.READ_BLOCK) == 128
    one = run()
    monkeypatch.setattr(ak, "READ_BLOCK", 32)
    anneal_groups.clear_cache()  # same shapes → would hit the one-block trace
    many = run()
    monkeypatch.undo()
    anneal_groups.clear_cache()
    np.testing.assert_array_equal(np.asarray(one), np.asarray(many))


@pytest.mark.parametrize("n", [9, 12])
@pytest.mark.parametrize("rule", ["metropolis", "heatbath", "pair"])
def test_unrolled_and_looped_variable_loops_match(monkeypatch, rule, n):
    """The variable loop unrolls for small problems (static row picks) and
    is a ``fori_loop`` otherwise; both are the same arithmetic."""
    rng = np.random.default_rng(100 + n)
    G, B, reads, sweeps = 1, 2, 8, 3
    Qg, h_extra, _, _ = _problem(rng, G, B, n, reads, sweeps)
    kw, _ = RULES[rule]
    if rule != "metropolis":
        kw = dict(kw, beta_cold=jnp.ones((G, B)))
    run = functools.partial(anneal_groups, jax.random.key(5), Qg, h_extra,
                            reads, sweeps, interpret=True, **kw)
    unrolled = run()
    monkeypatch.setattr(ak, "UNROLL_N_PAD", 0)
    anneal_groups.clear_cache()  # same shapes → would hit the unrolled trace
    looped = run()
    monkeypatch.undo()
    anneal_groups.clear_cache()
    np.testing.assert_array_equal(np.asarray(unrolled), np.asarray(looped))


def test_per_problem_streams():
    """A problem's samples depend on its own key alone: changing another
    problem's key, or the group composition, leaves them unchanged."""
    rng = np.random.default_rng(5)
    G, B, n, R, S = 2, 2, 5, 16, 3
    Qg = random_qubo_batch(rng, G, n)
    h = jnp.asarray(rng.normal(size=(G, B, n)).astype(np.float32))
    keys = jax.random.split(jax.random.key(0), G * B)
    run = functools.partial(anneal_groups, num_reads=R, num_sweeps=S,
                            interpret=True)
    base = np.asarray(run(keys, Qg, h))
    other = np.asarray(run(keys.at[3].set(jax.random.key(99)), Qg, h))
    np.testing.assert_array_equal(base[:, 0], other[:, 0])
    np.testing.assert_array_equal(base[0], other[0])
    assert not np.array_equal(base[1, 1], other[1, 1])
    # the same problems as four one-problem groups, in reverse order
    Qd = _dense(Qg, h).reshape(G * B, n, n)
    solo = np.asarray(run(keys[::-1], Qd[::-1], jnp.zeros((G * B, 1, n))))
    np.testing.assert_array_equal(solo[::-1, 0].reshape(G, B, R, n), base)


def test_generator_statistics():
    """The counter hash gives uniform, uncorrelated variates: moments and
    a 16-bin histogram over counters, and no correlation between adjacent
    reads or adjacent counters."""
    words = ak.problem_key_words(jax.random.split(jax.random.key(1), 4))
    reads = jnp.arange(512, dtype=jnp.uint32)
    lk = ak.lane_key(words[:, :1], words[:, 1:], reads[None])[..., None]
    ctr = jnp.arange(256, dtype=jnp.uint32)
    u = np.asarray(ak.bits_to_uniform(ak.draw_bits(lk, words[:, 1:, None], ctr)))
    assert u.shape == (4, 512, 256) and u.min() >= 0 and u.max() < 1
    assert abs(u.mean() - 0.5) < 2e-3 and abs(u.var() - 1 / 12) < 1e-3
    hist = np.histogram(u, bins=16, range=(0, 1))[0]
    expected = u.size / 16
    chi2 = ((hist - expected) ** 2 / expected).sum()
    assert chi2 < 45  # 15 dof: p ≈ 1e-4
    c = u - 0.5
    assert abs((c[:, 1:] * c[:, :-1]).mean()) * 12 < 0.01  # adjacent reads
    assert abs((c[..., 1:] * c[..., :-1]).mean()) * 12 < 0.01  # counters
    spins = np.asarray(ak.bits_to_spin(ak.draw_bits(lk, words[:, 1:, None], ctr)))
    assert set(np.unique(spins)) == {0.0, 1.0} and abs(spins.mean() - 0.5) < 5e-3


def test_heatbath_marginals_match_oracle():
    """The generator path under interpret anneals to the exact Boltzmann
    marginals at beta=1 (pair updates, the BMS default)."""
    rng = np.random.default_rng(9)
    n, R, S = 5, 512, 32
    Q = jnp.asarray(np.triu(rng.uniform(-1, 1, (1, n, n))), jnp.float32)
    s = anneal_groups(jax.random.key(2), Q, jnp.zeros((1, 1, n)), R, S,
                      rule="heatbath", beta_cold=jnp.ones((1, 1)), pair=True,
                      interpret=True)[0, 0]
    _, _, marg, _ = exact_boltzmann(Q[0], beta=1.0)
    se = np.sqrt(np.asarray(marg) * (1 - np.asarray(marg)) / R)
    assert np.all(np.abs(np.asarray(s).mean(0) - np.asarray(marg)) < 4 * se + 1e-3)


def test_metropolis_reaches_ground_state():
    """Uniforms ≈ 1 accept only downhill flips: an unfrustrated problem
    anneals to its unique ground state; the generator path gets there up
    to the cold end's thermal noise."""
    n = 6
    Q = -jnp.eye(n, dtype=jnp.float32)[None]  # all-ones ground state
    init01 = jnp.zeros((1, 1, 8, n), jnp.float32)
    uniforms = jnp.full((4, 1, 1, n, 8), 0.999, jnp.float32)
    out = anneal_groups(jax.random.key(0), Q, jnp.zeros((1, 1, n)), 8, 4,
                        interpret=True, debug_randoms=(init01, uniforms))
    assert np.all(np.asarray(out) == 1.0)
    # the default cold end leaves each spin exp(-ln 100) = 1% off
    out = anneal_groups(jax.random.key(0), Q, jnp.zeros((1, 1, n)), 64, 50,
                        interpret=True)
    assert np.asarray(out).mean() > 0.97


def test_read_block_rule():
    assert ak.read_block(1, 128) == 32
    assert ak.read_block(33, 128) == 64
    assert ak.read_block(100, 128) == 128
    assert ak.read_block(1000, 128) == 128
    assert ak.read_block(1000, 256) == 256
    assert ak.read_block(7, 256) == 32


def test_shape_rule(monkeypatch):
    """n <= MAX_N takes the kernel on a GPU; larger QUBOs (the n=717 CDQBM
    shape) and every CPU call take XLA; use_pallas forces either way.
    The kernel itself refuses n > MAX_N."""
    assert not api.kernel_route(None, 6)  # CPU backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert api.kernel_route(None, 6) and api.kernel_route(None, 41)
    assert api.kernel_route(None, ak.MAX_N)
    assert not api.kernel_route(None, ak.MAX_N + 1)
    assert not api.kernel_route(None, 717)
    assert not api.kernel_route(False, 6)
    assert api.kernel_route(True, 717)
    monkeypatch.undo()
    n = ak.MAX_N + 1
    with pytest.raises(ValueError, match="n <="):
        anneal_groups(jax.random.key(0), jnp.zeros((1, n, n)),
                      jnp.zeros((1, 1, n)), 4, 2, interpret=True)
    with pytest.raises(ValueError, match="heat-bath"):
        anneal_groups(jax.random.key(0), jnp.zeros((1, 3, 3)),
                      jnp.zeros((1, 1, 3)), 4, 2, pair=True, interpret=True)


def test_sample_groups_fallback_matches_dense():
    """On the XLA route, sample_groups is EXACTLY the dense sample_batch on
    the densified problems (same key stream), for samplers with and
    without a structured fast path."""
    from qbmx.samplers.api import (
        ExactSampler,
        GibbsSampler,
        SASampler,
        densify_groups,
        sampler_sample_groups,
    )

    rng = np.random.default_rng(5)
    G, B, n, R = 2, 3, 6, 64
    Qg = random_qubo_batch(rng, G, n)
    h_extra = jnp.asarray(rng.normal(size=(G, B, n)).astype(np.float32))
    Qd = densify_groups(Qg, h_extra)
    np.testing.assert_allclose(np.asarray(Qd.reshape(G, B, n, n)),
                               np.asarray(_dense(Qg, h_extra)), rtol=1e-6)
    key = jax.random.key(3)
    for sampler in [GibbsSampler(num_warmup=8), SASampler(num_sweeps=8),
                    ExactSampler()]:
        grp = sampler_sample_groups(sampler, key, Qg, h_extra, R)
        assert grp.shape == (G, B, R, n)
        flat = sampler.sample_batch(key, Qd, R)
        np.testing.assert_array_equal(
            np.asarray(grp), np.asarray(flat.reshape(G, B, R, n)))


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Route the samplers' kernel calls through the interpreter."""
    monkeypatch.setattr(ak, "anneal_groups",
                        functools.partial(anneal_groups, interpret=True))


def test_kernel_route_dense_batch_is_one_group_per_problem(interpret_kernel):
    """SASampler/GibbsSampler on the kernel route: a dense batch runs as one
    group per problem and matches the structured call on the same
    problems and keys."""
    rng = np.random.default_rng(2)
    G, B, n, R = 2, 2, 5, 16
    Qg = random_qubo_batch(rng, G, n)
    h = jnp.asarray(rng.normal(size=(G, B, n)).astype(np.float32))
    keys = jax.random.split(jax.random.key(4), G * B)
    Qd = _dense(Qg, h).reshape(G * B, n, n)
    for sampler in [api.SASampler(num_sweeps=3, use_pallas=True),
                    api.GibbsSampler(num_warmup=3, use_pallas=True)]:
        dense = sampler.sample_batch(keys, Qd, R)
        assert dense.shape == (G * B, R, n)
        grp = api.sampler_sample_groups(sampler, keys, Qg, h, R)
        np.testing.assert_array_equal(np.asarray(dense).reshape(G, B, R, n),
                                      np.asarray(grp))


def test_quad_updates_run_pairs_on_kernel_route(monkeypatch):
    """``GibbsSampler(quad_updates=True, pair_updates=False)`` runs PAIRS on
    the kernel route (quad takes precedence over pair_updates and the
    kernel has no quad variant), never single-variable sweeps."""
    captured = {}

    def fake_kernel(key, Qg, h_extra, num_reads, warmup, **kw):
        captured.update(kw)
        G, B = h_extra.shape[:2]
        return jnp.zeros((G, B, num_reads, Qg.shape[-1]))

    monkeypatch.setattr(ak, "anneal_groups", fake_kernel)
    rng = np.random.default_rng(0)
    Qg = random_qubo_batch(rng, 2, 6)
    h_extra = jnp.asarray(rng.normal(size=(2, 3, 6)).astype(np.float32))
    for sampler, want in [
        (api.GibbsSampler(quad_updates=True, pair_updates=False,
                          use_pallas=True), True),
        (api.GibbsSampler(pair_updates=False, use_pallas=True), False),
        (api.GibbsSampler(use_pallas=True), True),
    ]:
        captured.clear()
        sampler.sample_groups(jax.random.key(0), Qg, h_extra, 8)
        assert captured["pair"] is want, (sampler, captured)
        assert captured["rule"] == "heatbath"


def test_epoch_scan_on_every_route(monkeypatch):
    """Every SA/BMS route (kernel or XLA) lives inside lax.scan, so models
    take the scanned epoch launch at their real call shapes; the step's
    group count still follows the linear shortcut."""
    from qbmx.models.dqbm import DiscQBM

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    for sampler in [api.SASampler(), api.GibbsSampler(),
                    api.SASampler(use_pallas=True)]:
        m = DiscQBM(dim_input=4, n_hidden_nodes=40, seed=0, sample_count=100,
                    restricted=True, use_linear_shortcut=True, sampler=sampler)
        assert m._sampler_call_groups() == 1
        assert m.supports_epoch_scan(60) and m.supports_epoch_scan()
    m2 = DiscQBM(dim_input=4, n_hidden_nodes=3, seed=0, sample_count=16)
    assert m2._sampler_call_groups() == 2


# ---------------------------------------------------------------------------
# GPU tier: the kernel as compiled for the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["metropolis", "heatbath", "pair"])
def test_gpu_kernel_matches_xla_with_host_variates(gpu, rule):
    """Compiled kernel vs the XLA sweeps with the same host variates:
    at most 1e-4 of spins may differ (the card sums fields in another
    order, so only near-ties can flip)."""
    rng = np.random.default_rng(1)
    G, B, n, R, S = 2, 8, 41, 100, 4
    Qg, h_extra, init01, uniforms = _problem(rng, G, B, n, R, S)
    hot = jnp.full((G, B), 0.25)
    cold = jnp.full((G, B), 2.0)
    kw, sweep = RULES[rule]
    out = anneal_groups(jax.random.key(0), Qg, h_extra, R, S, beta_hot=hot,
                        beta_cold=cold, debug_randoms=(init01, uniforms), **kw)
    Qd = _dense(Qg, h_extra).reshape(G * B, n, n)
    h, J = split_qubo(Qd)
    betas = geometric_beta_schedule(hot.reshape(-1), cold.reshape(-1), S)
    u = jnp.moveaxis(uniforms.reshape(S, G * B, n, R), 1, 0)

    def one(s, uu, bb, hh, JJ):
        for t in range(S):
            s = sweep(s, uu[t], bb[t], hh, JJ)
        return s

    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax.vmap(one))(init01.reshape(G * B, R, n), u,
                                     betas.T, h, J)
    frac = float(np.mean(np.asarray(out).reshape(G * B, R, n) != np.asarray(ref)))
    assert frac <= 1e-4, frac


@pytest.mark.gpu
def test_gpu_heatbath_marginals_match_oracle(gpu):
    rng = np.random.default_rng(9)
    n, R, S = 12, 4096, 64
    Q = jnp.asarray(np.triu(rng.uniform(-1, 1, (1, n, n))), jnp.float32)
    for pair in (False, True):
        s = anneal_groups(jax.random.key(2), Q, jnp.zeros((1, 1, n)), R, S,
                          rule="heatbath", beta_cold=jnp.ones((1, 1)),
                          pair=pair)[0, 0]
        _, _, marg, _ = exact_boltzmann(Q[0], beta=1.0)
        m = np.asarray(marg)
        se = np.sqrt(m * (1 - m) / R)
        assert np.all(np.abs(np.asarray(s).mean(0) - m) < 4 * se + 1e-3), pair


@pytest.mark.gpu
def test_gpu_sa_ground_state_frequency(gpu):
    """Kernel SA finds the ground state at least as often as the XLA route
    (minus 4 standard errors)."""
    from qbmx.samplers.sa_jax import sa_sample_batch

    rng = np.random.default_rng(4)
    n, R, S = 12, 2048, 200
    Q = jnp.asarray(np.triu(rng.uniform(-2, 2, (1, n, n))), jnp.float32)
    states = enumerate_states(n)
    gs = np.asarray(states[int(np.argmin(np.asarray(qubo_energies(Q[0], states))))])
    k = np.asarray(anneal_groups(jax.random.key(1), Q, jnp.zeros((1, 1, n)),
                                 R, S))[0, 0]
    x = np.asarray(sa_sample_batch(jax.random.key(1), Q, R, S))[0]
    pk = np.mean(np.all(k == gs, axis=1))
    px = np.mean(np.all(x == gs, axis=1))
    se = np.sqrt(max(px * (1 - px), 1e-4) / R)
    assert pk >= px - 4 * se, (pk, px)

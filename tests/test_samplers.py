"""Sampler validation against the exact Boltzmann oracle.

The reference has no tests; its samplers were trusted third-party code
(dwave-neal).  Here every sampler is checked statistically against exact
enumeration on small problems (SURVEY.md §4: "statistical tests for the
sampler against exact Boltzmann enumeration on ≤20-variable problems").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qbmx.core.qubo import (
    default_beta_range,
    geometric_beta_schedule,
    qubo_energies,
    qubo_energy,
    split_qubo,
)
from qbmx.samplers.exact import (
    enumerate_states,
    exact_boltzmann,
    exact_sample,
    solve_linear_qubo,
)
from qbmx.samplers.gibbs import gibbs_sample, gibbs_sample_batch
from qbmx.samplers.sa_jax import sa_sample, sa_sample_batch


def random_qubo(rng, n, scale=1.0):
    Q = np.triu(rng.uniform(-scale, scale, (n, n)))
    return jnp.asarray(Q, dtype=jnp.float32)


class TestCore:
    def test_split_roundtrip_energy(self, rng):
        n = 6
        Q = random_qubo(rng, n)
        s = jnp.asarray(rng.integers(0, 2, n), dtype=jnp.float32)
        # brute-force energy from the dense convention
        Qnp = np.asarray(Q)
        snp = np.asarray(s)
        expected = snp @ np.diag(Qnp) + sum(
            (Qnp[i, j] + Qnp[j, i]) * snp[i] * snp[j]
            for i in range(n)
            for j in range(i + 1, n)
        )
        assert np.allclose(qubo_energy(Q, s), expected, atol=1e-5)

    def test_batched_energies(self, rng):
        Q = random_qubo(rng, 5)
        S = jnp.asarray(rng.integers(0, 2, (7, 5)), dtype=jnp.float32)
        es = qubo_energies(Q, S)
        for i in range(7):
            assert np.allclose(es[i], qubo_energy(Q, S[i]), atol=1e-5)

    def test_split_symmetric(self, rng):
        Q = random_qubo(rng, 8)
        h, J = split_qubo(Q)
        assert np.allclose(J, J.T)
        assert np.allclose(np.diagonal(J), 0.0)

    def test_beta_range_monotone(self, rng):
        Q = random_qubo(rng, 8)
        hot, cold = default_beta_range(Q)
        assert float(hot) < float(cold)
        betas = geometric_beta_schedule(hot, cold, 16)
        assert betas.shape[0] == 16
        assert np.all(np.diff(np.asarray(betas)) > 0)

    def test_beta_range_degenerate_zero_qubo(self):
        Q = jnp.zeros((4, 4))
        hot, cold = default_beta_range(Q)
        assert np.isfinite(float(hot)) and np.isfinite(float(cold))
        assert float(hot) < float(cold)


class TestExact:
    def test_enumerate(self):
        st = enumerate_states(3)
        assert st.shape == (8, 3)
        assert len({tuple(np.asarray(r)) for r in st}) == 8

    def test_boltzmann_uniform_at_zero_coupling(self):
        Q = jnp.zeros((4, 4))
        _, probs, marg, _ = exact_boltzmann(Q)
        assert np.allclose(probs, 1 / 16, atol=1e-6)
        assert np.allclose(marg, 0.5, atol=1e-6)

    def test_boltzmann_strong_bias(self):
        # strongly negative bias -> marginal ~1; strongly positive -> ~0
        Q = jnp.diag(jnp.asarray([-10.0, 10.0]))
        _, _, marg, _ = exact_boltzmann(Q)
        assert marg[0] > 0.99 and marg[1] < 0.01

    def test_exact_sample_matches_marginals(self, rng):
        Q = random_qubo(rng, 5, scale=2.0)
        _, _, marg, _ = exact_boltzmann(Q)
        s = exact_sample(jax.random.key(0), Q, 4000)
        assert np.allclose(s.mean(axis=0), marg, atol=0.04)

    def test_solve_linear(self):
        h = jnp.asarray([-1.0, 2.0, 0.0])
        s = solve_linear_qubo(jax.random.key(0), h, 64)
        assert np.all(np.asarray(s[:, 0]) == 1.0)
        assert np.all(np.asarray(s[:, 1]) == 0.0)
        # ties: one coin per variable shared across reads (reference
        # convention), so the read-mean is exactly 0 or 1, and varies by key
        fracs = {
            float(solve_linear_qubo(jax.random.key(k), h, 64)[:, 2].mean())
            for k in range(16)
        }
        assert fracs <= {0.0, 1.0} and len(fracs) == 2


class TestSAJax:
    @pytest.mark.parametrize("n", [2, 5, 8])
    def test_marginals_match_oracle(self, rng, n):
        """With enough sweeps SA at a cold end ~ finds low-energy states;
        statistical parity: marginals near the exact Boltzmann marginals of
        a moderately coupled problem at the cold beta."""
        Q = random_qubo(rng, n, scale=0.5)
        reads, sweeps = 512, 200
        samples = sa_sample(jax.random.key(1), Q, reads, sweeps)
        assert samples.shape == (reads, n)
        assert set(np.unique(np.asarray(samples))) <= {0.0, 1.0}
        # SA ends near the cold beta of the default schedule; compare against
        # the exact distribution at that beta.
        _, cold = default_beta_range(Q)
        _, _, marg, _ = exact_boltzmann(Q, beta=float(cold))
        assert np.allclose(samples.mean(axis=0), marg, atol=0.12)

    def test_finds_ground_state(self, rng):
        """On a problem with a clear minimum, most chains end in it."""
        Q = random_qubo(rng, 8, scale=3.0)
        states = enumerate_states(8)
        energies = np.asarray(qubo_energies(Q, states))
        gs = states[int(np.argmin(energies))]
        samples = sa_sample(jax.random.key(2), Q, 256, 300)
        hits = np.mean(np.all(np.asarray(samples) == np.asarray(gs), axis=1))
        assert hits > 0.5

    def test_chains_are_decorrelated(self, rng):
        """Unlike the reference (same seed in all 10 SA workers,
        SURVEY.md §2c.4), chains must not be identical copies."""
        Q = random_qubo(rng, 6, scale=0.2)  # weak couplings -> diffuse dist
        hot = jnp.asarray(0.5, dtype=jnp.float32)
        cold = jnp.asarray(1.0, dtype=jnp.float32)  # mild schedule: stay diffuse
        samples = np.asarray(
            sa_sample(jax.random.key(3), Q, 64, 50, beta_range=(hot, cold))
        )
        assert len({tuple(r) for r in samples}) > 5

    def test_batch_matches_single(self, rng):
        Qs = jnp.stack([random_qubo(rng, 5, scale=1.0) for _ in range(3)])
        out = sa_sample_batch(jax.random.key(4), Qs, 256, 100)
        assert out.shape == (3, 256, 5)
        # each problem's sample stats should track its own oracle
        for b in range(3):
            _, cold = default_beta_range(Qs[b])
            _, _, marg, _ = exact_boltzmann(Qs[b], beta=float(cold))
            assert np.allclose(out[b].mean(axis=0), marg, atol=0.15)


class TestGibbs:
    def test_matches_boltzmann_at_beta1(self, rng):
        Q = random_qubo(rng, 6, scale=1.0)
        _, _, marg, pair = exact_boltzmann(Q, beta=1.0)
        s = gibbs_sample(jax.random.key(5), Q, 2048, num_warmup=64, beta=1.0)
        assert np.allclose(s.mean(axis=0), marg, atol=0.05)
        emp_pair = np.einsum("mi,mj->ij", np.asarray(s), np.asarray(s)) / s.shape[0]
        assert np.allclose(emp_pair, pair, atol=0.07)

    def test_batch_shape(self, rng):
        Qs = jnp.stack([random_qubo(rng, 4) for _ in range(2)])
        out = gibbs_sample_batch(jax.random.key(6), Qs, 32, num_warmup=8)
        assert out.shape == (2, 32, 4)


def _dense_trajectory(sweep_fn, Q, init01, uniforms, hot, cold):
    """The anneal with an XLA sweep function and the geometric schedule
    (hot, cold) per problem: the reference the kernel is locked to."""
    S = uniforms.shape[0]
    out = []
    for b in range(Q.shape[0]):
        h, J = split_qubo(Q[b])
        betas = geometric_beta_schedule(hot[b], cold[b], S)
        s = jnp.asarray(init01[b], jnp.float32)
        for t in range(S):
            s = sweep_fn(s, uniforms[t, b], betas[t], h, J)
        out.append(np.asarray(s))
    return np.stack(out)


def _dense_problem(rng, B, n, reads, sweeps):
    Q = np.triu(rng.uniform(-2, 2, (B, n, n)).astype(np.float32))
    init01 = (rng.uniform(0, 1, (B, reads, n)) < 0.5).astype(np.float32)
    uniforms = rng.uniform(0, 1, (sweeps, B, n, reads)).astype(np.float32)
    return jnp.asarray(Q), jnp.asarray(init01), jnp.asarray(uniforms)


def _kernel_dense(Q, init01, uniforms, num_reads, **kw):
    """A dense batch through the anneal kernel (interpret mode), one group
    per problem — the layout SASampler/GibbsSampler.sample_batch use."""
    from qbmx.samplers.anneal_kernel import anneal_groups

    B, n = Q.shape[0], Q.shape[-1]
    out = anneal_groups(
        jax.random.key(0), Q, jnp.zeros((B, 1, n)), num_reads,
        uniforms.shape[0], interpret=True,
        debug_randoms=(init01[:, None], uniforms[:, :, None]), **kw)
    return np.asarray(out[:, 0])


KERNEL_SHAPES = [
    (5, 3, 16, 8),
    (14, 2, 8, 6),
    (20, 4, 8, 4),
    (41, 1, 4, 3),   # the CDQBM shape class (looped variable loop)
    (6, 2, 8, 1),    # a single sweep runs at the cold end
]


class TestKernelDenseBatches:
    """Dense batches through the anneal kernel (interpret mode, host
    variates) against the XLA sweeps, bit-for-bit."""

    @pytest.mark.parametrize("n,B,reads,sweeps", KERNEL_SHAPES)
    def test_metropolis_matches_sa_jax(self, n, B, reads, sweeps):
        from qbmx.samplers.sa_jax import _metropolis_sweep

        rng = np.random.default_rng(n * 1000 + B)
        Q, init01, uniforms = _dense_problem(rng, B, n, reads, sweeps)
        got = _kernel_dense(Q, init01, uniforms, reads)
        hot, cold = default_beta_range(Q)
        want = _dense_trajectory(_metropolis_sweep, Q, init01, uniforms,
                                 hot, cold)
        assert got.shape == (B, reads, n)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("n,B,reads,sweeps", KERNEL_SHAPES)
    def test_heatbath_matches_gibbs(self, n, B, reads, sweeps):
        """Heat-bath warmup ramp min(default_hot, beta) → beta, as
        gibbs_sample runs it."""
        from qbmx.samplers.gibbs import _heat_bath_sweep

        rng = np.random.default_rng(n * 1000 + B + 7)
        Q, init01, uniforms = _dense_problem(rng, B, n, reads, sweeps)
        got = _kernel_dense(Q, init01, uniforms, reads, rule="heatbath",
                            beta_cold=jnp.ones((B, 1)))
        hot, _ = default_beta_range(Q)
        want = _dense_trajectory(_heat_bath_sweep, Q, init01, uniforms,
                                 jnp.minimum(hot, 1.0), jnp.ones(B))
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("n,B,reads,sweeps",
                             [(20, 4, 8, 4), (41, 1, 4, 3), (5, 3, 8, 6)])
    def test_pair_gibbs_matches_mirror(self, n, B, reads, sweeps):
        from qbmx.samplers.gibbs import _pair_heat_bath_sweep

        rng = np.random.default_rng(n * 37 + B)
        Q, init01, uniforms = _dense_problem(rng, B, n, reads, sweeps)
        got = _kernel_dense(Q, init01, uniforms, reads, rule="heatbath",
                            pair=True, beta_cold=jnp.ones((B, 1)))
        hot, _ = default_beta_range(Q)
        want = _dense_trajectory(_pair_heat_bath_sweep, Q, init01, uniforms,
                                 jnp.minimum(hot, 1.0), jnp.ones(B))
        np.testing.assert_array_equal(got, want)

    def test_sampler_streams_are_per_problem(self, monkeypatch):
        """SASampler on the kernel route: one key per problem, so a
        problem's samples do not depend on the rest of the batch."""
        import functools

        import qbmx.samplers.anneal_kernel as ak
        from qbmx.samplers.api import SASampler

        monkeypatch.setattr(ak, "anneal_groups",
                            functools.partial(ak.anneal_groups, interpret=True))
        rng = np.random.default_rng(1)
        Q = jnp.stack([random_qubo(rng, 5) for _ in range(3)])
        keys = jax.random.split(jax.random.key(0), 3)
        s = SASampler(num_sweeps=4, use_pallas=True)
        full = np.asarray(s.sample_batch(keys, Q, 32))
        part = np.asarray(s.sample_batch(keys[1:], Q[1:], 32))
        np.testing.assert_array_equal(full[1:], part)


class TestRouting:
    def test_samplers_follow_kernel_route(self, monkeypatch):
        """SA and BMS take the kernel exactly where kernel_route says; PT
        always runs the XLA ladder."""
        import qbmx.samplers.anneal_kernel as ak
        from qbmx.samplers import api, gibbs, sa_jax, tempering

        seen = []
        monkeypatch.setattr(ak, "anneal_groups", lambda key, Qs, h, R, S, **kw: (
            seen.append("kernel") or jnp.zeros(h.shape[:2] + (R, Qs.shape[-1]))))
        for mod, name in [(sa_jax, "sa_sample_batch"),
                          (gibbs, "gibbs_sample_batch"),
                          (tempering, "pt_sample_batch")]:
            monkeypatch.setattr(mod, name, lambda key, Q, R, *a, **kw: (
                seen.append("xla") or jnp.zeros((Q.shape[0], R, Q.shape[-1]))))
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        for n, want in [(6, "kernel"), (41, "kernel"), (65, "xla"), (717, "xla")]:
            for s in [api.SASampler(num_sweeps=2), api.GibbsSampler(num_warmup=2)]:
                seen.clear()
                Q = jnp.zeros((2, n, n))
                assert s.sample_batch(jax.random.key(0), Q, 4).shape == (2, 4, n)
                assert seen == [want], (s, n, seen)
            seen.clear()
            api.PTSampler(num_sweeps=2).sample_batch(jax.random.key(0),
                                                     jnp.zeros((2, n, n)), 4)
            assert seen == ["xla"]

    def test_every_builtin_sampler_scans(self):
        """No built-in jit-safe sampler declines lax.scan (the kernel lives
        inside scan like the XLA samplers), at any shape."""
        from qbmx.samplers.api import (
            ExactSampler,
            GibbsSampler,
            PTSampler,
            SASampler,
            sampler_scan_safe,
            sampler_scan_safe_groups,
        )

        for s in [SASampler(), SASampler(use_pallas=True), GibbsSampler(),
                  PTSampler(num_replicas=8), ExactSampler()]:
            for n, B, R, G in [(6, 60, 1000, 20), (41, 60, 100, 2),
                               (717, 200, 100, 2)]:
                assert sampler_scan_safe(s, n, R)
                assert sampler_scan_safe_groups(s, n, B, R, groups=G)

    def test_quad_flag_routes(self, monkeypatch):
        """GibbsSampler(quad_updates=True) passes quad to the XLA route;
        the default keeps single-variable sweeps there."""
        from qbmx.samplers import api

        seen = {}

        def spy_xla(key, Q, num_reads, num_warmup=32, beta=1.0, pair=False,
                    quad=False):
            seen["xla"] = (pair, quad)
            return jnp.zeros((Q.shape[0], num_reads, Q.shape[-1]), jnp.float32)

        monkeypatch.setattr(api._gibbs, "gibbs_sample_batch", spy_xla)
        Q = jnp.zeros((2, 6, 6), jnp.float32)
        api.GibbsSampler(num_warmup=4, quad_updates=True).sample_batch(
            jax.random.key(0), Q, 8)
        assert seen["xla"] == (False, True)
        api.GibbsSampler(num_warmup=4).sample_batch(jax.random.key(0), Q, 8)
        assert seen["xla"] == (False, False)
        api.GibbsSampler(num_warmup=4, pair_updates=True).sample_batch(
            jax.random.key(0), Q, 8)
        assert seen["xla"] == (True, False)


class TestJointGibbsXLA:
    def test_pair_gibbs_statistics_match_oracle(self):
        """Pair-Gibbs preserves the Boltzmann distribution: XLA path vs the
        exact oracle at beta=1."""
        rng = np.random.default_rng(11)
        n = 6
        Q = jnp.asarray(np.triu(rng.uniform(-1, 1, (n, n))), jnp.float32)
        _, _, marg, pair_m = exact_boltzmann(Q, beta=1.0)
        s = gibbs_sample(jax.random.key(4), Q, 2048, num_warmup=64, beta=1.0,
                         pair=True)
        assert np.allclose(np.asarray(s).mean(axis=0), np.asarray(marg), atol=0.05)
        emp = np.einsum("mi,mj->ij", np.asarray(s), np.asarray(s)) / s.shape[0]
        assert np.allclose(emp, np.asarray(pair_m), atol=0.07)

    @pytest.mark.parametrize("n", [4, 5, 6, 7, 10])
    def test_quad_gibbs_statistics_match_oracle(self, n):
        """Quad-Gibbs preserves the Boltzmann distribution at every
        remainder (n % 4 = 0: quads only; 1: trailing single; 2: remainder
        pair; 3: pair + single): marginals AND pair moments."""
        rng = np.random.default_rng(11 + n)
        Q = jnp.asarray(np.triu(rng.uniform(-1, 1, (n, n))), jnp.float32)
        _, _, marg, pair_m = exact_boltzmann(Q, beta=1.0)
        s = gibbs_sample(jax.random.key(4), Q, 2048, num_warmup=64, beta=1.0,
                         quad=True)
        assert np.allclose(np.asarray(s).mean(axis=0), np.asarray(marg), atol=0.05)
        emp = np.einsum("mi,mj->ij", np.asarray(s), np.asarray(s)) / s.shape[0]
        assert np.allclose(emp, np.asarray(pair_m), atol=0.07)


class TestParallelTempering:
    def test_matches_boltzmann_at_target(self, rng):
        from qbmx.samplers.tempering import pt_sample

        Q = random_qubo(rng, 6, scale=1.5)
        _, _, marg, pair = exact_boltzmann(Q, beta=1.0)
        s = pt_sample(jax.random.key(0), Q, 1024, num_sweeps=48, num_replicas=6)
        assert s.shape == (1024, 6)
        assert np.allclose(s.mean(axis=0), marg, atol=0.06)
        emp_pair = np.einsum("mi,mj->ij", np.asarray(s), np.asarray(s)) / s.shape[0]
        assert np.allclose(emp_pair, pair, atol=0.08)

    def test_beats_plain_gibbs_on_frustrated_problem(self, rng):
        """On a bimodal (frustrated ferromagnet-pair) landscape with a high
        barrier, PT's cold rung should track the exact marginals at least as
        well as equal-budget one-way annealed Gibbs."""
        from qbmx.samplers.gibbs import gibbs_sample
        from qbmx.samplers.tempering import pt_sample

        n = 8
        # two cliques with strong internal ferromagnetic coupling and biases
        # arranged to make two near-degenerate modes
        Q = np.zeros((n, n), dtype="float32")
        for i in range(4):
            for j in range(i + 1, 4):
                Q[i, j] = -3.0
                Q[i + 4, j + 4] = -3.0
        Q[np.arange(4), np.arange(4)] = 4.4
        Q[np.arange(4, 8), np.arange(4, 8)] = 4.6
        Q = jnp.asarray(Q)
        _, _, marg, _ = exact_boltzmann(Q, beta=1.0)

        s_pt = pt_sample(jax.random.key(1), Q, 512, num_sweeps=64, num_replicas=8)
        s_gb = gibbs_sample(jax.random.key(1), Q, 512, num_warmup=64, beta=1.0)
        err_pt = np.abs(np.asarray(s_pt.mean(axis=0)) - np.asarray(marg)).max()
        err_gb = np.abs(np.asarray(s_gb.mean(axis=0)) - np.asarray(marg)).max()
        assert err_pt < max(err_gb + 0.02, 0.1)

    @pytest.mark.parametrize("M", [2, 4, 8])
    def test_ladders_match_oracle(self, M):
        """The XLA ladder at several rung counts tracks the exact marginals
        at the target beta."""
        from qbmx.samplers.tempering import pt_sample

        rng = np.random.default_rng(3)
        n = 5
        Q = jnp.asarray(np.triu(rng.uniform(-1.5, 1.5, (n, n))), jnp.float32)
        s = pt_sample(jax.random.key(M), Q, 1024, num_sweeps=32, num_replicas=M)
        _, _, marg, _ = exact_boltzmann(Q, beta=1.0)
        assert np.allclose(np.asarray(s).mean(axis=0), np.asarray(marg), atol=0.08)

    def test_batch_keys_are_per_problem(self, rng):
        from qbmx.samplers.tempering import pt_sample_batch

        Qs = jnp.stack([random_qubo(rng, 4) for _ in range(3)])
        keys = jax.random.split(jax.random.key(5), 3)
        full = np.asarray(pt_sample_batch(keys, Qs, 32, 4, 4, 1.0))
        part = np.asarray(pt_sample_batch(keys[1:], Qs[1:], 32, 4, 4, 1.0))
        np.testing.assert_array_equal(full[1:], part)

    def test_batch_shape(self, rng):
        from qbmx.samplers.tempering import pt_sample_batch

        Qs = jnp.stack([random_qubo(rng, 5) for _ in range(3)])
        out = pt_sample_batch(jax.random.key(2), Qs, 64, num_sweeps=8, num_replicas=4)
        assert out.shape == (3, 64, 5)


class TestEdgeShapes:
    def test_single_read(self, rng):
        Q = random_qubo(rng, 4)
        s = sa_sample(jax.random.key(0), Q, 1, 8)
        assert s.shape == (1, 4)

    def test_single_variable_qubo(self):
        Q = jnp.asarray([[-3.0]])
        s = sa_sample(jax.random.key(0), Q, 64, 32)
        assert s.shape == (64, 1)
        assert s.mean() > 0.9  # negative bias -> on

    def test_batch_of_one(self, rng):
        Q = random_qubo(rng, 5)[None]
        out = sa_sample_batch(jax.random.key(1), Q, 16, 8)
        assert out.shape == (1, 16, 5)

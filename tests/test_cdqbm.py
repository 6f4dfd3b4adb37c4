"""CDQBM: geometry counts, penalty structure, QUBO assembly vs naive numpy,
and end-to-end learning on synthetic images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qbmx.models.cdqbm import CDQBM, PROB_POOL_PENALTY, build_penalty_matrix
from qbmx.models.geometry import (
    StackGeometry,
    build_pool_windows,
    conv_output_shape,
    patch_index_grid,
)
from qbmx.samplers.api import GibbsSampler
from qbmx.train.loop import train_model


class TestGeometry:
    def test_conv_output_shape(self):
        assert conv_output_shape((28, 28), 3, 1) == (26, 26)
        assert conv_output_shape((28, 28), 3, 2) == (13, 13)
        assert conv_output_shape((6, 6), 3, 1) == (4, 4)

    def test_patch_grid_matches_naive(self):
        H, W, k, s = 6, 7, 3, 2
        grid = patch_index_grid((H, W), k, s)
        img = np.arange(H * W).reshape(H, W)
        u = 0
        for i in range(0, H - k + 1, s):
            for j in range(0, W - k + 1, s):
                assert np.array_equal(img.ravel()[grid[u]], img[i : i + k, j : j + k])
                u += 1
        assert u == grid.shape[0]

    def test_pool_windows(self):
        wins = build_pool_windows((4, 4), 2)
        assert wins.shape == (4, 4)
        # first window covers fmap positions (0,0),(0,1),(1,0),(1,1)
        assert list(wins[0]) == [0, 1, 4, 5]
        assert build_pool_windows((4, 4), 0).shape[0] == 0

    def test_counts_deterministic(self):
        geo = StackGeometry((6, 6), 3, 1, 2, "deterministic", (3,), 1)
        assert geo.num_conv_units == 16
        assert geo.n_windows == 4
        assert geo.conv_active == 4  # pooled units only
        assert geo.n_pool_vars == 0
        assert geo.n_hidden == 4 + 3
        assert geo.n_total == 8
        assert geo.last_hidden_slice == slice(4, 7)

    def test_counts_probabilistic(self):
        geo = StackGeometry((6, 6), 3, 1, 2, "probabilistic", (3,), 2)
        assert geo.conv_active == 16
        assert geo.n_pool_vars == 4
        assert geo.n_hidden == 16 + 4 + 3
        assert geo.stats_drop == 16
        assert geo.sizes_active == (4, 3)

    def test_conv_fmap_matches_naive(self):
        model = CDQBM(image_shape=(6, 6), kernel_size=3, pooling_size=0, seed=0)
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 1, (6, 6)).astype("float32")
        fmap, _, _ = model._context(model.params, jnp.asarray(x))
        kern = np.asarray(model.params.kernel)
        naive = np.asarray(
            [
                np.sum(x[i : i + 3, j : j + 3] * kern)
                for i in range(4)
                for j in range(4)
            ]
        )
        assert np.allclose(np.asarray(fmap), naive, atol=1e-5)


class TestPenalties:
    def test_penalty_matrix_structure(self):
        geo = StackGeometry((6, 6), 3, 1, 2, "probabilistic", (), 1)
        P = build_penalty_matrix(geo)
        B = PROB_POOL_PENALTY
        wins = geo.pool_windows
        # pairwise at-most-one inside window 0 ({0,1,4,5})
        assert P[0, 1] == pytest.approx(B)
        assert P[0, 5] == pytest.approx(B)
        assert P[1, 4] == pytest.approx(B)
        # OR-link: pool var of window 0 sits at conv_active + 0 = 16
        pv = 16
        assert P[pv, pv] == pytest.approx(B)
        assert P[0, 0] == pytest.approx(B)
        assert P[0, pv] == pytest.approx(-2 * B)
        # no cross-window terms
        assert P[0, int(wins[1][0])] == pytest.approx(0.0)

    def test_deterministic_has_no_penalties(self):
        geo = StackGeometry((6, 6), 3, 1, 2, "deterministic", (), 1)
        assert np.allclose(build_penalty_matrix(geo), 0.0)


class TestQuboAssembly:
    def make_model(self, pooling_type, hidden_bias_type="shared", seq=(3,)):
        return CDQBM(
            image_shape=(6, 6), num_label_nodes=1, seed=1, kernel_size=3,
            pooling_size=2, pooling_type=pooling_type, stride=1,
            sequential_layer_sizes=list(seq), hidden_bias_type=hidden_bias_type,
            sample_count=8, beta_eff=2.0,
        )

    def test_clamped_deterministic_structure(self):
        model = self.make_model("deterministic")
        geo = model.geo
        rng = np.random.default_rng(2)
        x = rng.uniform(0, 1, (6, 6)).astype("float32")
        label = np.asarray([1.0], dtype="float32")
        Q = np.asarray(model.clamped_qubo(model.params, jnp.asarray(x), jnp.asarray(label)))
        assert Q.shape == (geo.n_hidden, geo.n_hidden)

        # naive: conv diag = fmap[argmin per window] + shared bias
        kern = np.asarray(model.params.kernel)
        fmap = np.asarray(
            [np.sum(x[i:i+3, j:j+3] * kern) for i in range(4) for j in range(4)]
        )
        wins = geo.pool_windows
        pooled = [w[np.argmin(fmap[w])] for w in wins]
        conv_bias = fmap[pooled] + float(np.asarray(model.params.b_conv)[0])
        expected = np.zeros((geo.n_hidden, geo.n_hidden))
        expected[np.arange(4), np.arange(4)] += conv_bias
        expected[geo.pool_slice, geo.seq_slices[0]] += np.asarray(model.params.w_seq[0])
        expected[geo.seq_slices[0], geo.seq_slices[0]] += np.triu(
            np.asarray(model.params.w_seq_intra[0]), k=1
        )
        expected[np.arange(4, 7), np.arange(4, 7)] += np.asarray(model.params.b_seq)
        eff = np.asarray(model.params.w_h2o) @ label
        expected[np.arange(4, 7), np.arange(4, 7)] += eff
        expected /= 2.0
        assert np.allclose(Q, expected, atol=1e-5)

    def test_unclamped_embeds_hidden_block_plus_output(self):
        model = self.make_model("deterministic")
        geo = model.geo
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.uniform(0, 1, (6, 6)), dtype=jnp.float32)
        Qu = np.asarray(model.unclamped_qubo(model.params, x))
        assert Qu.shape == (geo.n_total, geo.n_total)
        # output block
        b_o = np.asarray(model.params.b_o)
        assert Qu[geo.n_hidden, geo.n_hidden] == pytest.approx(b_o[0] / 2.0, abs=1e-5)
        # hidden->output block present
        w_h2o = np.asarray(model.params.w_h2o)
        ls = geo.last_hidden_slice
        assert np.allclose(Qu[ls, geo.out_slice], w_h2o / 2.0, atol=1e-5)

    def test_probabilistic_includes_penalties(self):
        model = self.make_model("probabilistic")
        geo = model.geo
        rng = np.random.default_rng(4)
        x = jnp.asarray(rng.uniform(0, 1, (6, 6)), dtype=jnp.float32)
        Q = np.asarray(model.clamped_qubo(model.params, x, jnp.asarray([0.0])))
        # at-most-one penalty between conv units 0 and 1 (window 0), / beta_eff
        assert Q[0, 1] == pytest.approx(PROB_POOL_PENALTY / 2.0, abs=1e-5)
        pv = geo.conv_active
        assert Q[0, pv] == pytest.approx(-2 * PROB_POOL_PENALTY / 2.0, abs=1e-5)

    def test_per_unit_bias_applied(self):
        """The reference's modular builder silently ignores per-unit conv
        biases (src/qubo/builder.py:8-10) — ours must apply them."""
        model = self.make_model("deterministic", hidden_bias_type="per-unit")
        rng = np.random.default_rng(5)
        x = jnp.asarray(rng.uniform(0, 1, (6, 6)), dtype=jnp.float32)
        Q1 = np.asarray(model.clamped_qubo(model.params, x, jnp.asarray([0.0])))
        import dataclasses as dc

        bumped = dc.replace(
            model.params, b_conv=model.params.b_conv + 10.0
        )
        Q2 = np.asarray(model.clamped_qubo(bumped, x, jnp.asarray([0.0])))
        assert np.all(np.diag(Q2)[:4] - np.diag(Q1)[:4] > 4.0)  # 10/beta_eff



    def test_structured_builders_match_dense(self):
        """shared + diag(fields) must equal the dense per-example builders
        EXACTLY for every pooling mode — the contract the sampler group
        path (sampler_sample_groups / anneal_kernel) relies on."""
        rng = np.random.default_rng(9)
        for pooling, bias, lp in [("deterministic", "shared", False),
                                  ("probabilistic", "per-unit", False),
                                  ("probabilistic", "shared", True),
                                  ("deterministic", "none", False)]:
            model = CDQBM(
                image_shape=(6, 6), num_label_nodes=2, seed=3, kernel_size=3,
                pooling_size=2 if pooling != "none" else 0,
                pooling_type=pooling, stride=1, sequential_layer_sizes=[3],
                hidden_bias_type=bias, sample_count=8, beta_eff=2.0,
                learn_penalty=lp,
            )
            p = model.params
            x = jnp.asarray(rng.uniform(0, 1, (6, 6)).astype("float32"))
            yv = jnp.asarray([0.0, 1.0], dtype=jnp.float32)

            Qc = model.clamped_qubo(p, x, yv)
            rc = model.clamped_qubo_shared(p) + jnp.diagflat(
                model.clamped_fields(p, x, yv))
            np.testing.assert_allclose(np.asarray(Qc), np.asarray(rc),
                                       rtol=0, atol=1e-6)

            Qu = model.unclamped_qubo(p, x)
            ru = model.unclamped_qubo_shared(p) + jnp.diagflat(
                model.unclamped_fields(p, x))
            np.testing.assert_allclose(np.asarray(Qu), np.asarray(ru),
                                       rtol=0, atol=1e-6)


class TestTraining:
    @pytest.mark.parametrize("pooling_type", ["deterministic", "probabilistic"])
    def test_step_updates_all_params(self, pooling_type):
        model = CDQBM(
            image_shape=(6, 6), num_label_nodes=1, seed=0, kernel_size=3,
            pooling_size=2, pooling_type=pooling_type,
            sequential_layer_sizes=[3], hidden_bias_type="shared",
            sample_count=32, sampler=GibbsSampler(num_warmup=8),
        )
        rng = np.random.default_rng(6)
        x = rng.uniform(0, 1, (4, 6, 6)).astype("float32")
        y = np.asarray([0, 1, 0, 1], dtype="float32")
        before = jax.tree.map(lambda a: np.asarray(a).copy(), model.params)
        model.train_for_one_iteration(x, y, 0.5)
        after = model.params
        changed = [
            not np.allclose(np.asarray(a), b)
            for a, b in zip(jax.tree.leaves(after), jax.tree.leaves(before))
        ]
        # kernel, w_seq, w_h2o, b_seq, b_o must all move (w_oo is 1x1 → empty triu)
        assert sum(changed) >= 5

    def test_learns_synthetic(self):
        """Brightness-separable task; moment-matching training is slow by
        nature (the reference runs 20 epochs × dozens of batches), so give it
        enough updates.  Gradient correctness itself is pinned against
        autodiff of the exact NLL in test_gradient_matches_autodiff."""
        rngl = np.random.default_rng(1)
        n = 40
        y = rngl.integers(0, 2, n).astype("float32")
        x = np.where(
            y[:, None, None] > 0,
            rngl.uniform(0.6, 1.0, (n, 4, 4)),
            rngl.uniform(0.0, 0.4, (n, 4, 4)),
        ).astype("float32")
        model = CDQBM(
            image_shape=(4, 4), num_label_nodes=1, seed=3, kernel_size=3,
            pooling_size=2, pooling_type="deterministic",
            sequential_layer_sizes=[3], hidden_bias_type="shared",
            sample_count=256, sampler=GibbsSampler(num_warmup=16),
        )
        history = train_model(
            model, x, y, x, y, batch_size=40, learning_rate=0.5, epochs=140,
            verbose=False,
        )
        assert max(history.acc_per_epoch) >= 0.72

    def test_gradient_matches_autodiff(self):
        """Moment-diff gradient with exact samples == jax.grad of the true
        discriminative NLL computed from the exact partition functions."""
        from qbmx.core.qubo import qubo_energies
        from qbmx.samplers.api import ExactSampler
        from qbmx.samplers.exact import enumerate_states

        model = CDQBM(
            image_shape=(4, 4), num_label_nodes=1, seed=3, kernel_size=3,
            pooling_size=2, pooling_type="deterministic",
            sequential_layer_sizes=[3], hidden_bias_type="shared",
            sample_count=8192, sampler=ExactSampler(),
        )
        rngl = np.random.default_rng(0)
        x = jnp.asarray(rngl.uniform(0, 1, (1, 4, 4)), dtype=jnp.float32)
        y = jnp.asarray([1.0])

        def true_nll(params):
            Qc = model.clamped_qubo(params, x[0], y)
            Qu = model.unclamped_qubo(params, x[0])
            Ec = qubo_energies(Qc, enumerate_states(model.geo.n_hidden))
            Eu = qubo_energies(Qu, enumerate_states(model.geo.n_total))
            const = jnp.dot(params.b_o, y) / model.beta_eff
            logZc = jax.scipy.special.logsumexp(-Ec - const)
            logZu = jax.scipy.special.logsumexp(-Eu)
            return -(logZc - logZu)

        p = model.params
        key = jax.random.key(0)
        kc, ku = jax.random.split(key)
        yv = jnp.asarray([[1.0]])
        Qc = jax.vmap(lambda xi, yi: model.clamped_qubo(p, xi, yi))(x, yv)
        Qu = jax.vmap(lambda xi: model.unclamped_qubo(p, xi))(x)
        s_c = model.sampler.sample_batch(kc, Qc, 8192)
        s_u = model.sampler.sample_batch(ku, Qu, 8192)
        mc = jax.vmap(lambda s, xi, yi: model._moments(p, s, xi, yi))(s_c, x, yv)
        mu = jax.vmap(lambda s, xi: model._moments(p, s, xi))(s_u, x)
        diff = jax.tree.map(lambda a, b: (a - b)[0], mc, mu)
        g_auto = jax.grad(true_nll)(p)
        for name in ["w_h2o", "b_o", "b_seq", "w_oo"]:
            a = np.asarray(getattr(diff, name))
            b = np.asarray(getattr(g_auto, name))
            assert np.allclose(a, b, atol=0.05), name
        # kernel gradient matches up to the (non-differentiable) argmin
        # pooling selection — direction must agree
        ka = np.asarray(diff.kernel).ravel()
        kb = np.asarray(g_auto.kernel).ravel()
        assert np.dot(ka, kb) > 0

    def test_checkpoint_roundtrip(self, tmp_path):
        model = CDQBM(image_shape=(6, 6), kernel_size=3, pooling_size=2,
                      sequential_layer_sizes=[3], seed=0, sample_count=8)
        model.save_weights("ck", str(tmp_path))
        model2 = CDQBM(image_shape=(6, 6), kernel_size=3, pooling_size=2,
                       sequential_layer_sizes=[3], seed=9, sample_count=8)
        model2.load_params(str(tmp_path / "ck.pkl"))
        for a, b in zip(jax.tree.leaves(model.params), jax.tree.leaves(model2.params)):
            assert np.allclose(np.asarray(a), np.asarray(b))

    def test_hidden_embedding_shape(self):
        model = CDQBM(image_shape=(6, 6), kernel_size=3, pooling_size=2,
                      sequential_layer_sizes=[3], seed=0, sample_count=16,
                      sampler=GibbsSampler(num_warmup=4))
        rng = np.random.default_rng(7)
        x = rng.uniform(0, 1, (5, 6, 6)).astype("float32")
        emb = model.get_last_hidden_embedding(x)
        assert emb.shape == (5, 3)
        assert np.all(emb >= 0) and np.all(emb <= 1)


class TestPipelineAndViz:
    def test_run_clamped_unclamped(self):
        model = CDQBM(image_shape=(4, 4), kernel_size=3, pooling_size=2,
                      sequential_layer_sizes=[2], seed=0, sample_count=16,
                      sampler=GibbsSampler(num_warmup=4))
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 1, (4, 4)).astype("float32")
        s, probs = model.run_unclamped(x)
        assert s.shape == (16, model.geo.n_total)
        assert probs.shape == (2,) and abs(probs.sum() - 1) < 1e-5
        sc = model.run_clamped(x, np.asarray([1.0]))
        assert sc.shape == (16, model.geo.n_hidden)

    def test_visualize_architecture(self, tmp_path):
        from qbmx.utils.viz import visualize_architecture

        model = CDQBM(image_shape=(6, 6), kernel_size=3, pooling_size=2,
                      pooling_type="probabilistic", sequential_layer_sizes=[3],
                      seed=0, sample_count=8)
        fig = visualize_architecture(model, save_path=str(tmp_path / "arch.png"))
        assert (tmp_path / "arch.png").exists()

    def test_is_qbm_model(self):
        from qbmx.models.base import QBMModel
        from qbmx.models.dqbm import DiscQBM

        assert issubclass(CDQBM, QBMModel)
        assert issubclass(DiscQBM, QBMModel)


class TestProbPoolingGradient:
    def test_gradient_matches_autodiff_probabilistic(self):
        """Same autodiff pin as the deterministic test, but with
        probabilistic pooling: penalties, pool variables, conv-unit-marginal
        kernel/bias gradients all in play."""
        from qbmx.core.qubo import qubo_energies
        from qbmx.samplers.api import ExactSampler
        from qbmx.samplers.exact import enumerate_states

        model = CDQBM(
            image_shape=(4, 4), num_label_nodes=1, seed=3, kernel_size=3,
            pooling_size=2, pooling_type="probabilistic",
            sequential_layer_sizes=[2], hidden_bias_type="shared",
            sample_count=16384, sampler=ExactSampler(),
        )
        geo = model.geo
        assert geo.n_pool_vars == 1 and geo.n_hidden == 4 + 1 + 2
        rngl = np.random.default_rng(0)
        x = jnp.asarray(rngl.uniform(0, 1, (1, 4, 4)), dtype=jnp.float32)
        y = jnp.asarray([1.0])

        def true_nll(params):
            Qc = model.clamped_qubo(params, x[0], y)
            Qu = model.unclamped_qubo(params, x[0])
            Ec = qubo_energies(Qc, enumerate_states(geo.n_hidden))
            Eu = qubo_energies(Qu, enumerate_states(geo.n_total))
            const = jnp.dot(params.b_o, y) / model.beta_eff
            return -(jax.scipy.special.logsumexp(-Ec - const)
                     - jax.scipy.special.logsumexp(-Eu))

        p = model.params
        kc, ku = jax.random.split(jax.random.key(0))
        yv = jnp.asarray([[1.0]])
        Qc = jax.vmap(lambda xi, yi: model.clamped_qubo(p, xi, yi))(x, yv)
        Qu = jax.vmap(lambda xi: model.unclamped_qubo(p, xi))(x)
        s_c = model.sampler.sample_batch(kc, Qc, 16384)
        s_u = model.sampler.sample_batch(ku, Qu, 16384)
        mc = jax.vmap(lambda s, xi, yi: model._moments(p, s, xi, yi))(s_c, x, yv)
        mu = jax.vmap(lambda s, xi: model._moments(p, s, xi))(s_u, x)
        diff = jax.tree.map(lambda a, b: (a - b)[0], mc, mu)
        g_auto = jax.grad(true_nll)(p)
        for name in ["kernel", "w_h2o", "b_o", "b_seq", "b_conv", "w_oo"]:
            a = np.asarray(getattr(diff, name))
            b = np.asarray(getattr(g_auto, name))
            assert np.allclose(a, b, atol=0.06), (name, a, b)
        # tuple-valued groups (sequential inter/intra-layer weights)
        assert np.allclose(np.asarray(diff.w_seq[0]),
                           np.asarray(g_auto.w_seq[0]), atol=0.06)
        assert np.allclose(np.asarray(diff.w_seq_intra[0]),
                           np.asarray(g_auto.w_seq_intra[0]), atol=0.06)


class TestPoolSelectFlags:
    """Flag-gated pooling extensions (PARITY.md §4 exact study); defaults
    stay reference-parity (tested against the actual reference builder in
    test_ref_builder_parity.py)."""

    def _model(self, **kw):
        from qbmx.samplers.api import GibbsSampler

        return CDQBM(
            image_shape=(5, 5), num_label_nodes=1, seed=0, kernel_size=2,
            pooling_size=2, pooling_type="deterministic",
            hidden_bias_type="shared", sample_count=8,
            sampler=GibbsSampler(num_warmup=2), **kw,
        )

    def test_pool_select_picks_expected_units(self):
        m_min = self._model()
        m_max = self._model(pool_select="max")
        m_abs = self._model(pool_select="absmax")
        x = jnp.asarray(np.linspace(0, 1, 25).reshape(5, 5), jnp.float32)
        # force a kernel with known sign structure
        import dataclasses as dc

        for m in (m_min, m_max, m_abs):
            m.params = dc.replace(
                m.params, kernel=jnp.asarray([[[1.0, 0.0], [0.0, -2.0]]]))
        fmap, idx_min, _ = m_min._context(m_min.params, x)
        _, idx_max, _ = m_max._context(m_max.params, x)
        _, idx_abs, _ = m_abs._context(m_abs.params, x)
        wf = np.asarray(fmap)[np.asarray(m_min.windows)]
        np.testing.assert_array_equal(
            np.asarray(idx_min), np.asarray(m_min.windows)[np.arange(4), wf.argmin(1)])
        np.testing.assert_array_equal(
            np.asarray(idx_max), np.asarray(m_min.windows)[np.arange(4), wf.argmax(1)])
        np.testing.assert_array_equal(
            np.asarray(idx_abs), np.asarray(m_min.windows)[np.arange(4), np.abs(wf).argmax(1)])

    def test_center_fmap_zero_means(self):
        m = self._model(center_fmap=True)
        x = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (5, 5)), jnp.float32)
        fmap, _, _ = m._context(m.params, x)
        assert abs(float(fmap.mean())) < 1e-6

    def test_defaults_unchanged(self):
        m = self._model()
        assert m.pool_select == "min" and m.center_fmap is False

    def test_invalid_pool_select_raises(self):
        with pytest.raises(ValueError, match="pool_select"):
            self._model(pool_select="median")


class TestCDQBMEpochLaunch:
    """CDQBM gains whole-epoch device launches via EpochLaunchMixin."""

    def _model(self):
        from qbmx.samplers.api import SASampler

        return CDQBM(
            image_shape=(5, 5), num_label_nodes=1, seed=2, kernel_size=2,
            pooling_size=2, sequential_layer_sizes=[2], hidden_bias_type="shared",
            sample_count=16, sampler=SASampler(num_sweeps=8, use_pallas=False),
        )

    def test_train_epoch_scan_runs_and_learns(self):
        m = self._model()
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 1, (11, 5, 5)).astype("float32")
        y = (rng.uniform(size=11) < 0.5).astype("float32")
        assert m.supports_epoch_scan()
        nlls, errs = m.train_epoch(x, y, batch_size=4, learning_rate=0.05)
        assert nlls.shape == (3,) and np.all(np.isfinite(nlls))
        # cached device batches reused on the second epoch (same entry)
        entry = m._epoch_data
        m.train_epoch(x, y, batch_size=4, learning_rate=0.05)
        assert m._epoch_data is entry

    def test_train_epoch_accepts_flat_inputs(self):
        m = self._model()
        rng = np.random.default_rng(1)
        x = rng.uniform(0, 1, (8, 25)).astype("float32")  # flattened
        y = (rng.uniform(size=8) < 0.5).astype("float32")
        nlls, _ = m.train_epoch(x, y, batch_size=4, learning_rate=0.05)
        assert nlls.shape == (2,)

    def test_loop_takes_epoch_path_for_cdqbm(self, monkeypatch):
        from qbmx.train.loop import train_model

        m = self._model()
        calls = {"n": 0}
        orig = CDQBM.train_epoch

        def spy(self, *a, **k):
            calls["n"] += 1
            return orig(self, *a, **k)

        monkeypatch.setattr(CDQBM, "train_epoch", spy)
        rng = np.random.default_rng(2)
        x = rng.uniform(0, 1, (8, 5, 5)).astype("float32")
        y = (rng.uniform(size=8) < 0.5).astype("float32")
        train_model(m, x, y, batch_size=4, learning_rate=0.05, epochs=2, verbose=False)
        assert calls["n"] == 2


class TestLearnedPenalties:
    """Flag-gated per-window learned penalties (ROADMAP r2 lead)."""

    KW = dict(image_shape=(4, 4), num_label_nodes=1, kernel_size=3,
              pooling_size=2, pooling_type="probabilistic",
              sequential_layer_sizes=[2], hidden_bias_type="shared")

    def test_basis_sums_to_constant_matrix(self):
        from qbmx.models.cdqbm import build_penalty_basis

        geo = StackGeometry((6, 6), 3, 1, 2, "probabilistic", (), 1)
        basis = build_penalty_basis(geo)
        assert basis.shape[0] == len(geo.pool_windows)
        np.testing.assert_allclose(
            PROB_POOL_PENALTY * basis.sum(axis=0),
            build_penalty_matrix(geo), rtol=1e-6)

    def test_pen_at_init_reproduces_parity_qubo(self, rng):
        """learn_penalty at init (pen = prob_penalty everywhere) must build
        the SAME QUBOs as the parity constant-penalty model."""
        from qbmx.samplers.api import ExactSampler

        m_ref = CDQBM(seed=0, sample_count=8, sampler=ExactSampler(), **self.KW)
        m_lrn = CDQBM(seed=0, sample_count=8, sampler=ExactSampler(),
                      learn_penalty=True, **self.KW)
        x = jnp.asarray(rng.uniform(0, 1, (4, 4)), jnp.float32)
        y = jnp.asarray([1.0])
        np.testing.assert_allclose(
            np.asarray(m_lrn.clamped_qubo(m_lrn.params, x, y)),
            np.asarray(m_ref.clamped_qubo(m_ref.params, x, y)), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(m_lrn.unclamped_qubo(m_lrn.params, x)),
            np.asarray(m_ref.unclamped_qubo(m_ref.params, x)), atol=1e-6)

    def test_pen_trains_and_roundtrips(self, rng):
        from qbmx.samplers.api import ExactSampler

        m = CDQBM(seed=0, sample_count=256, sampler=ExactSampler(),
                  learn_penalty=True, **self.KW)
        x = jnp.asarray(rng.uniform(0, 1, (4, 4, 4)), jnp.float32)
        y = jnp.asarray(rng.integers(0, 2, 4), jnp.float32)
        p0 = np.asarray(m.params.pen).copy()
        new_p, nll, _ = m._step(m.params, x, y, jnp.ones((4,)), 0.5,
                                jax.random.key(1))
        assert np.isfinite(float(nll))
        assert not np.allclose(np.asarray(new_p.pen), p0)
        # 9-entry checkpoint roundtrip
        m.params = new_p
        m.save_weights("pen_rt", "/tmp/qbmx_pen_test")
        m2 = CDQBM(seed=3, sample_count=8, sampler=ExactSampler(),
                   learn_penalty=True, **self.KW)
        m2.load_params("/tmp/qbmx_pen_test/pen_rt.pkl")
        np.testing.assert_allclose(np.asarray(m2.params.pen),
                                   np.asarray(new_p.pen), rtol=1e-6)

    def test_default_off_keeps_pen_none(self, rng):
        from qbmx.samplers.api import ExactSampler

        m = CDQBM(seed=0, sample_count=32, sampler=ExactSampler(), **self.KW)
        assert m.params.pen is None
        x = jnp.asarray(rng.uniform(0, 1, (2, 4, 4)), jnp.float32)
        y = jnp.asarray([0.0, 1.0])
        new_p, _, _ = m._step(m.params, x, y, jnp.ones((2,)), 0.3,
                              jax.random.key(0))
        assert new_p.pen is None
        assert len(m.weight_objects()) == 8  # reference checkpoint format

    def test_requires_probabilistic_pooling(self):
        from qbmx.samplers.api import ExactSampler

        with pytest.raises(ValueError, match="probabilistic"):
            CDQBM(image_shape=(4, 4), num_label_nodes=1, seed=0,
                  kernel_size=3, pooling_size=2,
                  pooling_type="deterministic", sequential_layer_sizes=[2],
                  hidden_bias_type="shared", sample_count=8,
                  sampler=ExactSampler(), learn_penalty=True)


def test_prob_penalty_flag_scales_penalty_matrix():
    """The reference hardcodes 0.8225; the flag must scale the penalty
    terms linearly (round-2 extension)."""
    from qbmx.samplers.api import GibbsSampler

    kw = dict(image_shape=(6, 6), num_label_nodes=1, seed=0, kernel_size=4,
              pooling_size=2, pooling_type="probabilistic",
              sequential_layer_sizes=[2], sample_count=4,
              sampler=GibbsSampler(num_warmup=2))
    m1 = CDQBM(**kw)
    m2 = CDQBM(**kw, prob_penalty=1.645)
    assert float(m1.prob_penalty) == 0.8225  # parity default
    np.testing.assert_allclose(np.asarray(m2.penalty_hidden),
                               2.0 * np.asarray(m1.penalty_hidden), rtol=1e-6)


class TestMultiKernel:
    """Flag-gated multi-channel conv (``--n_kernels``, VERDICT r4 #2): C
    independent kernels stack C channel copies of the conv(+pool) block
    channel-major; n_kernels=1 is reference parity (pinned element-wise by
    test_ref_builder_parity against the reference's own builder)."""

    def test_geometry_counts(self):
        geo = StackGeometry((6, 6), 3, 1, 2, "deterministic", (3,), 1,
                            n_kernels=2)
        assert geo.num_conv_units == 16 and geo.conv_units_total == 32
        assert geo.n_windows == 8 and geo.conv_active == 8
        assert geo.n_hidden == 8 + 3
        geo_p = StackGeometry((6, 6), 3, 1, 2, "probabilistic", (3,), 2,
                              n_kernels=3)
        assert geo_p.conv_active == 48 and geo_p.n_pool_vars == 12
        assert geo_p.stats_drop == 48 and geo_p.sizes_active == (12, 3)
        with pytest.raises(ValueError, match="n_kernels"):
            StackGeometry((6, 6), 3, 1, 2, "deterministic", (), 1, n_kernels=0)

    def test_pool_windows_channel_offsets(self):
        geo = StackGeometry((6, 6), 3, 1, 2, "deterministic", (), 1,
                            n_kernels=2)
        w = geo.pool_windows
        assert w.shape == (8, 4)
        np.testing.assert_array_equal(w[4:], w[:4] + geo.num_conv_units)

    def _model(self, n_kernels, seed=0, **kw):
        from qbmx.samplers.api import ExactSampler

        base = dict(image_shape=(5, 5), num_label_nodes=1, kernel_size=2,
                    pooling_size=2, pooling_type="deterministic",
                    sequential_layer_sizes=[2], hidden_bias_type="shared",
                    sample_count=16, sampler=ExactSampler())
        base.update(kw)
        return CDQBM(seed=seed, n_kernels=n_kernels, **base)

    def test_identical_kernels_give_identical_channel_blocks(self):
        import dataclasses as dc

        m = self._model(2)
        p = dc.replace(m.params, kernel=jnp.stack([m.params.kernel[0]] * 2))
        x = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (5, 5)),
                        jnp.float32)
        h = np.asarray(m.unclamped_fields(p, x))
        half = m.geo.conv_active // 2
        np.testing.assert_allclose(h[:half], h[half : 2 * half], atol=1e-6)

    def test_distinct_kernels_give_distinct_channel_blocks(self):
        m = self._model(2, seed=4)
        x = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (5, 5)),
                        jnp.float32)
        h = np.asarray(m.unclamped_fields(m.params, x))
        half = m.geo.conv_active // 2
        assert not np.allclose(h[:half], h[half : 2 * half])

    def test_gradient_matches_autodiff_two_kernels(self):
        """The C=2 moment-diff gradient with exact samples == autodiff of
        the true NLL (same contract the single-kernel test pins)."""
        from qbmx.core.qubo import qubo_energies
        from qbmx.samplers.api import ExactSampler
        from qbmx.samplers.exact import enumerate_states

        model = CDQBM(
            image_shape=(4, 4), num_label_nodes=1, seed=3, kernel_size=3,
            pooling_size=2, pooling_type="deterministic", n_kernels=2,
            sequential_layer_sizes=[3], hidden_bias_type="shared",
            sample_count=8192, sampler=ExactSampler(),
        )
        rngl = np.random.default_rng(0)
        x = jnp.asarray(rngl.uniform(0, 1, (1, 4, 4)), dtype=jnp.float32)
        y = jnp.asarray([1.0])

        def true_nll(params):
            Qc = model.clamped_qubo(params, x[0], y)
            Qu = model.unclamped_qubo(params, x[0])
            Ec = qubo_energies(Qc, enumerate_states(model.geo.n_hidden))
            Eu = qubo_energies(Qu, enumerate_states(model.geo.n_total))
            const = jnp.dot(params.b_o, y) / model.beta_eff
            logZc = jax.scipy.special.logsumexp(-Ec - const)
            logZu = jax.scipy.special.logsumexp(-Eu)
            return -(logZc - logZu)

        import dataclasses as dc

        # scale away from init: at U(-1,1) init the per-channel kernel
        # gradient (~7e-4) sits below the 8192-sample noise floor (~5e-3),
        # so a direction check would be a coin flip
        p = dc.replace(model.params, kernel=3.0 * model.params.kernel,
                       w_h2o=2.0 * model.params.w_h2o)
        kc, ku = jax.random.split(jax.random.key(0))
        yv = jnp.asarray([[1.0]])
        Qc = jax.vmap(lambda xi, yi: model.clamped_qubo(p, xi, yi))(x, yv)
        Qu = jax.vmap(lambda xi: model.unclamped_qubo(p, xi))(x)
        s_c = model.sampler.sample_batch(kc, Qc, 8192)
        s_u = model.sampler.sample_batch(ku, Qu, 8192)
        mc = jax.vmap(lambda s, xi, yi: model._moments(p, s, xi, yi))(s_c, x, yv)
        mu = jax.vmap(lambda s, xi: model._moments(p, s, xi))(s_u, x)
        diff = jax.tree.map(lambda a, b: (a - b)[0], mc, mu)
        g_auto = jax.grad(true_nll)(p)
        for name in ["w_h2o", "b_o", "b_seq", "w_oo", "b_conv"]:
            a = np.asarray(getattr(diff, name))
            b = np.asarray(getattr(g_auto, name))
            assert np.allclose(a, b, atol=0.05), name
        # per-channel kernel gradients agree in direction (argmin pooling
        # selection is non-differentiable, as in the single-kernel test)
        for c in range(2):
            ka = np.asarray(diff.kernel[c]).ravel()
            kb = np.asarray(g_auto.kernel[c]).ravel()
            assert np.dot(ka, kb) > 0, c

    def test_step_updates_both_kernels(self):
        from qbmx.samplers.api import GibbsSampler

        m = self._model(2, sampler=GibbsSampler(num_warmup=4))
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.uniform(0, 1, (4, 5, 5)), jnp.float32)
        y = jnp.asarray([0.0, 1.0, 0.0, 1.0])
        before = np.asarray(m.params.kernel)
        assert before.shape[0] == 2
        new_p, nll, _ = m._step(m.params, x, y, jnp.ones((4,)), 0.3,
                                jax.random.key(0))
        after = np.asarray(new_p.kernel)
        assert not np.allclose(after[0], before[0])
        assert not np.allclose(after[1], before[1])
        assert np.isfinite(float(nll))

    def test_checkpoint_roundtrip_and_reference_format(self, tmp_path):
        # C=2: kernel stored (2, k, k), roundtrips exactly
        m2 = self._model(2, seed=5)
        m2.save_weights("c2", str(tmp_path))
        objs = m2.weight_objects()
        assert np.asarray(objs[0]).shape == (2, 2, 2)
        m2b = self._model(2, seed=9)
        m2b.load_params(str(tmp_path / "c2.pkl"))
        for a, b in zip(jax.tree.leaves(m2.params), jax.tree.leaves(m2b.params)):
            assert np.allclose(np.asarray(a), np.asarray(b))
        # C=1: kernel stored in the REFERENCE's (k, k) shape and reloadable
        m1 = self._model(1, seed=5)
        assert np.asarray(m1.weight_objects()[0]).shape == (2, 2)
        m1.save_weights("c1", str(tmp_path))
        m1b = self._model(1, seed=9)
        m1b.load_params(str(tmp_path / "c1.pkl"))
        np.testing.assert_allclose(np.asarray(m1b.params.kernel),
                                   np.asarray(m1.params.kernel))
        # kernel-count mismatch is a clear error, not a silent reshape
        with pytest.raises(ValueError, match="n_kernels=2"):
            m2c = self._model(2, seed=1)
            m2c.load_params(str(tmp_path / "c1.pkl"))

    def test_cli_flag(self):
        from qbmx.cli import cdqbm_main

        assert cdqbm_main.build_parser().parse_args([]).n_kernels == 1
        flags = cdqbm_main.build_parser().parse_args(["--n_kernels", "4"])
        assert flags.n_kernels == 4

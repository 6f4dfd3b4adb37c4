"""Seed-parallel DQBM sweep: one batched program ≡ S sequential trainings
(statistically), shapes/slices correct, ragged tails masked."""

import jax
import numpy as np
import pytest

from qbmx.models.dqbm import DiscQBM
from qbmx.samplers.api import ExactSampler, SASampler
from qbmx.train.loop import get_best_combined_acc_auc, train_model
from qbmx.train.sweep import SeedParallelDQBM


def two_cluster_data(rng, n=96, D=6):
    base = rng.uniform(0, 1, (2, D))
    y = rng.integers(0, 2, n)
    x = np.clip(0.75 * base[y] + 0.25 * rng.uniform(0, 1, (n, D)), 0, 1)
    return x.astype("float32"), y.astype("float32")


class TestSeedParallel:
    def test_per_seed_init_matches_single_model(self):
        """Stacked params row s must equal DiscQBM(seed=s).params exactly."""
        seeds = [3, 17]
        sweep = SeedParallelDQBM(seeds, dim_input=5, n_hidden_nodes=3,
                                 restricted=False, sample_count=8,
                                 sampler=SASampler(num_sweeps=4, use_pallas=False))
        for i, s in enumerate(seeds):
            single = DiscQBM(dim_input=5, n_hidden_nodes=3, seed=s, sample_count=8,
                             restricted=False,
                             sampler=SASampler(num_sweeps=4, use_pallas=False))
            for a, b in zip(jax.tree.leaves(sweep.params_for_seed(i)),
                            jax.tree.leaves(single.params)):
                assert np.allclose(np.asarray(a), np.asarray(b)), (i, s)

    def test_sweep_learns_all_seeds(self, rng):
        x, y = two_cluster_data(rng)
        sweep = SeedParallelDQBM([0, 1, 2], dim_input=6, n_hidden_nodes=3,
                                 sample_count=256, sampler=ExactSampler())
        hist = sweep.train(x, y, x, y, epochs=8, batch_size=24,
                           learning_rate=0.3, verbose=False)
        assert len(hist) == 3
        for h in hist:
            _, acc, _, _ = get_best_combined_acc_auc(h)
            assert acc > 0.8, [hh.acc_per_epoch for hh in hist]
            # probability-scored AUC rides along and is a proper ROC score
            assert len(h.prob_auc_per_epoch) == 8
            assert max(h.prob_auc_per_epoch) > 0.8

    def test_predict_sample_count_decoupled(self, rng):
        """Eval-time reads decouple from training reads (prob-AUC ranking
        resolution scales 1/sqrt(predict reads))."""
        x, y = two_cluster_data(rng)
        sweep = SeedParallelDQBM([0], dim_input=6, n_hidden_nodes=3,
                                 sample_count=64, predict_sample_count=512,
                                 sampler=ExactSampler())
        hist = sweep.train(x, y, x, y, epochs=2, batch_size=24,
                           learning_rate=0.3, verbose=False)
        assert len(hist[0].acc_per_epoch) == 2
        assert len(hist[0].prob_auc_per_epoch) == 2

    def test_matches_sequential_band(self, rng):
        """Batched sweep's mean best-acc must land in the sequential path's
        band on the same task (same seeds, same hypers, exact sampler)."""
        x, y = two_cluster_data(rng, n=72)
        seeds = [5, 6]
        kw = dict(dim_input=6, n_hidden_nodes=3, sample_count=256)
        sweep = SeedParallelDQBM(seeds, **kw, sampler=ExactSampler())
        hs = sweep.train(x, y, x, y, epochs=6, batch_size=24,
                         learning_rate=0.3, verbose=False)
        batched = np.mean([max(h.acc_per_epoch) for h in hs])

        seq = []
        for s in seeds:
            m = DiscQBM(seed=s, **kw, sampler=ExactSampler())
            h = train_model(m, x, y, x, y, batch_size=24, learning_rate=0.3,
                            epochs=6, verbose=False)
            seq.append(max(h.acc_per_epoch))
        assert abs(batched - np.mean(seq)) < 0.12, (batched, seq)

    def test_single_seed_trajectory_reproducible_across_seed_sets(self, rng):
        """VERDICT r2 #8: with per-problem sampler keys derived from each
        seed's own stream, a seed's training trajectory must be IDENTICAL
        whether it trains alone or inside a larger sweep (XLA samplers;
        the Pallas path mixes keys per pack and stays statistical)."""
        x, y = two_cluster_data(rng, n=48)
        kw = dict(dim_input=6, n_hidden_nodes=3, sample_count=64,
                  sampler=ExactSampler())
        solo = SeedParallelDQBM([7], **kw)
        hs_solo = solo.train(x, y, x, y, epochs=3, batch_size=24,
                             learning_rate=0.3, verbose=False)
        trio = SeedParallelDQBM([3, 7, 11], **kw)
        hs_trio = trio.train(x, y, x, y, epochs=3, batch_size=24,
                             learning_rate=0.3, verbose=False)
        np.testing.assert_allclose(hs_solo[0].nll_per_batch,
                                   hs_trio[1].nll_per_batch, rtol=1e-5)
        assert hs_solo[0].acc_per_epoch == hs_trio[1].acc_per_epoch
        for a, b in zip(jax.tree.leaves(solo.params_for_seed(0)),
                        jax.tree.leaves(trio.params_for_seed(1))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5)

    def test_ragged_tail_and_segments(self, rng):
        """n not divisible by batch_size + epoch segmentation still runs and
        produces per-batch NLLs for ceil(n/bs) batches."""
        x, y = two_cluster_data(rng, n=50)
        sweep = SeedParallelDQBM([0, 1], dim_input=6, n_hidden_nodes=2,
                                 sample_count=32, epoch_segment=2,
                                 sampler=SASampler(num_sweeps=4, use_pallas=False))
        hist = sweep.train(x, y, epochs=1, batch_size=16, learning_rate=0.1,
                           verbose=False)
        assert len(hist[0].nll_per_batch) == 4  # ceil(50/16)
        assert np.all(np.isfinite(hist[0].nll_per_batch))

    def test_one_hot_multiclass(self, rng):
        x = rng.uniform(0, 1, (30, 4)).astype("float32")
        y = rng.integers(0, 3, 30).astype("int32")
        sweep = SeedParallelDQBM([0, 1], dim_input=4, num_classes=3,
                                 n_hidden_nodes=2, use_one_hot_encoding=True,
                                 sample_count=32,
                                 sampler=SASampler(num_sweeps=4, use_pallas=False))
        hist = sweep.train(x, y, x, y, epochs=1, batch_size=10,
                           learning_rate=0.1, class_titles=("0", "1", "2"),
                           verbose=False)
        assert len(hist) == 2 and len(hist[0].acc_per_epoch) == 1


class TestSeedShardedMesh:
    def test_seed_axis_shards_over_dp_mesh(self, rng):
        """Seed-sharded sweep on an 8-device CPU mesh reproduces the
        unsharded run (seeds are embarrassingly parallel — GSPMD partitions
        from the parameter sharding alone, no collectives)."""
        from qbmx.parallel.mesh import make_mesh

        x, y = two_cluster_data(rng, n=48)
        seeds = list(range(8))
        kw = dict(dim_input=6, n_hidden_nodes=3, sample_count=32,
                  sampler=SASampler(num_sweeps=8, use_pallas=False))
        mesh = make_mesh(dp=8, chains=1)
        sharded = SeedParallelDQBM(seeds, **kw, mesh=mesh)
        plain = SeedParallelDQBM(seeds, **kw)

        hs = sharded.train(x, y, x, y, epochs=2, batch_size=16,
                           learning_rate=0.2, verbose=False)
        hp = plain.train(x, y, x, y, epochs=2, batch_size=16,
                         learning_rate=0.2, verbose=False)
        # same PRNG streams → same trajectories (up to reduction order)
        for a, b in zip(jax.tree.leaves(sharded.params),
                        jax.tree.leaves(plain.params)):
            assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-5)
        for s in range(8):
            assert hs[s].acc_per_epoch == pytest.approx(hp[s].acc_per_epoch)
        # the stacked parameters really live distributed over the mesh
        leaf = jax.tree.leaves(sharded.params)[0]
        assert len({d for sh in leaf.addressable_shards for d in [sh.device]}) == 8

    def test_mesh_requires_divisible_seed_count(self):
        from qbmx.parallel.mesh import make_mesh

        with pytest.raises(ValueError, match="divisible"):
            SeedParallelDQBM([0, 1, 2], dim_input=4, n_hidden_nodes=2,
                             sampler=SASampler(num_sweeps=2, use_pallas=False),
                             mesh=make_mesh(dp=2, chains=1))


class TestSeedParallelRBM:
    def test_whole_sweep_single_dispatch_learns(self, rng):
        from qbmx.train.sweep import SeedParallelRBM

        x, y = two_cluster_data(rng, n=120)
        x = (x > 0.5).astype("float32")
        sweep = SeedParallelRBM([0, 1, 2], num_visible=6, num_hidden=6,
                                learning_rate=0.3)
        accs, aucs = sweep.sweep(x, y, x, y, epochs=10, batch_size=12)
        assert len(accs) == 3 and len(accs[0]) == 10
        for per_seed in accs:
            assert max(per_seed) > 0.85, accs

    def test_matches_classification_rbm_band(self, rng):
        """Same seeds/hypers: the batched sweep's accuracies must track the
        per-seed ClassificationRBM trainings."""
        from qbmx.models.rbm import ClassificationRBM
        from qbmx.train.sweep import SeedParallelRBM

        x, y = two_cluster_data(rng, n=96)
        x = (x > 0.5).astype("float32")
        seeds = [7, 8, 9, 10]
        sweep = SeedParallelRBM(seeds, num_visible=6, num_hidden=5,
                                learning_rate=0.25)
        accs, _ = sweep.sweep(x, y, x, y, epochs=15, batch_size=12)
        batched = np.mean([max(a) for a in accs])
        seq = []
        for s in seeds:
            rbm = ClassificationRBM(num_visible=6, num_hidden=5, seed=s,
                                    learning_rate=0.25)
            rbm.train_rbm(x, y, epochs=15, batch_size=12, test_x=x, test_y=y)
            seq.append(max(rbm.acc_per_epoch_list))
        # key-consumption order differs → different shuffles; compare means
        # over enough seeds/epochs that both estimates are past the
        # early-training bimodality of this toy task
        assert abs(batched - np.mean(seq)) < 0.15, (batched, seq)

    def test_generative_mode_and_pcd_rejection(self, rng):
        from qbmx.train.sweep import SeedParallelRBM

        x, y = two_cluster_data(rng, n=48)
        x = (x > 0.5).astype("float32")
        sweep = SeedParallelRBM([0, 1], num_visible=6, num_hidden=4,
                                learning_rate=0.2, method="generative", k=1)
        accs, _ = sweep.sweep(x, y, x, y, epochs=2, batch_size=12)
        assert len(accs[0]) == 2
        with pytest.raises(ValueError, match="pcd"):
            SeedParallelRBM([0], num_visible=6, num_hidden=4, method="pcd")

    def test_oversized_batch_raises(self, rng):
        """batch_size > n would silently train nothing (nb = 0)."""
        from qbmx.train.sweep import SeedParallelRBM

        x, y = two_cluster_data(rng, n=24)
        x = (x > 0.5).astype("float32")
        sweep = SeedParallelRBM([0], num_visible=6, num_hidden=4)
        with pytest.raises(ValueError, match="batch_size"):
            sweep.sweep(x, y, x, y, epochs=1, batch_size=100)


class TestSeedParallelCDQBM:
    def _donor(self, **kw):
        from qbmx.models.cdqbm import CDQBM

        kw.setdefault("sampler", SASampler(num_sweeps=8, use_pallas=False))
        kw.setdefault("sample_count", 16)
        return CDQBM(image_shape=(5, 5), num_label_nodes=1, kernel_size=2,
                     pooling_size=2, sequential_layer_sizes=[2],
                     hidden_bias_type="shared", **kw)

    def test_per_seed_init_matches_single_model(self):
        from qbmx.models.cdqbm import CDQBM
        from qbmx.train.sweep import SeedParallelCDQBM

        seeds = [3, 17]
        sweep = SeedParallelCDQBM(seeds, self._donor())
        for i, s in enumerate(seeds):
            single = self._donor(seed=s)
            assert isinstance(single, CDQBM)
            for a, b in zip(jax.tree.leaves(sweep.params_for_seed(i)),
                            jax.tree.leaves(single.params)):
                assert np.allclose(np.asarray(a), np.asarray(b)), (i, s)

    def test_sweep_trains_and_predicts(self, rng):
        from qbmx.train.sweep import SeedParallelCDQBM

        x = rng.uniform(0, 1, (11, 5, 5)).astype("float32")
        y = (x[:, 2, 2] > 0.5).astype("float32")
        sweep = SeedParallelCDQBM([0, 1, 2], self._donor())
        hist = sweep.train(x, y, x, y, epochs=2, batch_size=4,
                           learning_rate=0.05, verbose=False)
        assert len(hist) == 3
        for h in hist:
            assert len(h.nll_per_epoch) == 2 and len(h.acc_per_epoch) == 2
            assert len(h.prob_auc_per_epoch) == 2
            assert all(0.0 <= a <= 1.0 for a in h.prob_auc_per_epoch)
            assert np.all(np.isfinite(h.nll_per_batch))
        # seeds must differ (independent inits → different trajectories)
        assert not np.allclose(
            np.asarray(jax.tree.leaves(sweep.params_for_seed(0))[0]),
            np.asarray(jax.tree.leaves(sweep.params_for_seed(1))[0]))

    def test_matches_sequential_cdqbm_nll(self, rng):
        """First-step NLL per seed must be close to the sequential model's
        (same init, same exact-ish sampler statistics)."""
        from qbmx.train.loop import train_model
        from qbmx.train.sweep import SeedParallelCDQBM

        x = rng.uniform(0, 1, (8, 5, 5)).astype("float32")
        y = (x[:, 2, 2] > 0.5).astype("float32")
        donor = self._donor(sampler=ExactSampler(), sample_count=512)
        sweep = SeedParallelCDQBM([5], donor)
        hist = sweep.train(x, y, epochs=1, batch_size=8,
                           learning_rate=0.0, verbose=False)
        single = self._donor(seed=5, sampler=ExactSampler(), sample_count=512)
        _, nll = single.train_for_one_iteration(x, y, learning_rate=0.0)
        assert abs(hist[0].nll_per_epoch[0] - float(nll)) < 0.15, (
            hist[0].nll_per_epoch, float(nll))

    def test_rejects_host_bound_sampler(self):
        from qbmx.train.sweep import SeedParallelCDQBM

        class FakeHostSampler:
            jit_safe = False

        donor = self._donor()
        donor.sampler = FakeHostSampler()
        with pytest.raises(ValueError, match="jit-safe"):
            SeedParallelCDQBM([0], donor)

    def test_dqbm_sweep_rejects_host_bound_sampler(self):
        from qbmx.train.sweep import SeedParallelDQBM

        class FakeHostSampler:
            jit_safe = False

        with pytest.raises(ValueError, match="jit-safe"):
            SeedParallelDQBM([0], dim_input=4, n_hidden_nodes=2,
                             sampler=FakeHostSampler())

    def test_reinit_seeds_replaces_only_listed_rows(self):
        from qbmx.train.sweep import SeedParallelCDQBM

        sweep = SeedParallelCDQBM([7, 8, 9], self._donor())
        before = [jax.tree.map(lambda a: np.asarray(a[s]).copy(), sweep.params)
                  for s in range(3)]
        sweep.reinit_seeds([1])
        after = [jax.tree.map(lambda a: np.asarray(a[s]), sweep.params)
                 for s in range(3)]
        for s in (0, 2):  # untouched rows bit-identical
            for a, b in zip(jax.tree.leaves(before[s]), jax.tree.leaves(after[s])):
                np.testing.assert_array_equal(a, b)
        changed = any(not np.allclose(a, b) for a, b in
                      zip(jax.tree.leaves(before[1]), jax.tree.leaves(after[1])))
        assert changed
        # deterministic: a second sweep re-initialized the same way matches
        sweep2 = SeedParallelCDQBM([7, 8, 9], self._donor())
        sweep2.reinit_seeds([1])
        for a, b in zip(jax.tree.leaves(sweep.params), jax.tree.leaves(sweep2.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_train_reinit_on_collapse_triggers(self, rng):
        """With an impossible-to-beat majority threshold the check must
        re-draw every seed at the requested epoch (smoke: end-to-end
        wiring, determinism covered above)."""
        from qbmx.train.sweep import SeedParallelCDQBM

        x = rng.uniform(0, 1, (8, 5, 5)).astype("float32")
        y = np.zeros(8, dtype="float32")  # majority fraction 1.0 on val
        sweep = SeedParallelCDQBM([0, 1], self._donor())
        before = jax.tree.map(lambda a: np.asarray(a).copy(), sweep.params)
        sweep.train(x, y, x, y, epochs=2, batch_size=4, learning_rate=0.0,
                    verbose=False, reinit_on_collapse=1)
        # lr=0 → params could only change via the re-init
        changed = any(not np.allclose(a, b) for a, b in
                      zip(jax.tree.leaves(before), jax.tree.leaves(sweep.params)))
        assert changed


class TestDQBMSweepReinit:
    def test_reinit_seeds_replaces_only_listed_rows(self):
        sweep = SeedParallelDQBM([4, 5, 6], dim_input=5, n_hidden_nodes=3,
                                 sample_count=8,
                                 sampler=SASampler(num_sweeps=4, use_pallas=False))
        before = jax.tree.map(lambda a: np.asarray(a).copy(), sweep.params)
        sweep.reinit_seeds([2])
        after = jax.tree.map(np.asarray, sweep.params)
        for a, b in zip(jax.tree.leaves(
                jax.tree.map(lambda v: v[:2], before)),
                jax.tree.leaves(jax.tree.map(lambda v: v[:2], after))):
            np.testing.assert_array_equal(a, b)
        changed = any(not np.allclose(a[2], b[2]) for a, b in
                      zip(jax.tree.leaves(before), jax.tree.leaves(after))
                      if a[2].size)
        assert changed

    def test_train_reinit_on_collapse_smoke(self, rng):
        x, y = two_cluster_data(rng, n=24)
        y0 = np.zeros_like(y)  # impossible majority threshold
        sweep = SeedParallelDQBM([0, 1], dim_input=6, n_hidden_nodes=2,
                                 sample_count=8,
                                 sampler=SASampler(num_sweeps=4, use_pallas=False))
        before = jax.tree.map(lambda a: np.asarray(a).copy(), sweep.params)
        sweep.train(x, y0, x, y0, epochs=2, batch_size=12, learning_rate=0.0,
                    verbose=False, reinit_on_collapse=1)
        changed = any(not np.allclose(a, b) for a, b in
                      zip(jax.tree.leaves(before), jax.tree.leaves(sweep.params)))
        assert changed


def _cdqbm_donor():
    from qbmx.models.cdqbm import CDQBM

    return CDQBM(image_shape=(5, 5), num_label_nodes=1, kernel_size=2,
                 pooling_size=2, sequential_layer_sizes=[2],
                 hidden_bias_type="shared", sample_count=16,
                 sampler=SASampler(num_sweeps=8, use_pallas=False))


def test_reinit_repeats_with_fresh_attempts(rng):
    """With a never-satisfiable majority threshold and lr=0, the check
    fires at every epoch but the last; the final params must equal a
    direct attempt=<n_fires> re-draw (distinct per attempt)."""
    from qbmx.train.sweep import SeedParallelCDQBM

    x = rng.uniform(0, 1, (8, 5, 5)).astype("float32")
    y = np.zeros(8, dtype="float32")
    sweep = SeedParallelCDQBM([0], _cdqbm_donor())
    sweep.train(x, y, x, y, epochs=4, batch_size=4, learning_rate=0.0,
                verbose=False, reinit_on_collapse=1)  # fires at 1, 2, 3
    expect = SeedParallelCDQBM([0], _cdqbm_donor())
    expect.reinit_seeds([0], attempt=3)
    for a, b in zip(jax.tree.leaves(sweep.params), jax.tree.leaves(expect.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # attempts are distinct draws
    other = SeedParallelCDQBM([0], _cdqbm_donor())
    other.reinit_seeds([0], attempt=2)
    assert any(not np.allclose(np.asarray(a), np.asarray(b)) for a, b in
               zip(jax.tree.leaves(sweep.params), jax.tree.leaves(other.params)))


def test_scan_epoch_matches_unrolled_exactly():
    """_scan_epoch is the lax.scan twin of _unrolled_epoch (identical key
    consumption): same params, keys, and data must produce bit-identical
    parameters and nlls — the contract that lets sweeps switch between the
    scanned and the unrolled whole-epoch program."""
    import jax
    import jax.numpy as jnp

    from qbmx.train.sweep import (
        SeedParallelDQBM,
        _pad_to_batches,
        _scan_epoch,
        _unrolled_epoch,
    )

    rng = np.random.default_rng(5)
    X = rng.uniform(0, 1, (24, 6)).astype("float32")
    Y = rng.integers(0, 2, 24)
    sw = SeedParallelDQBM([1, 2, 3], dim_input=6, n_hidden_nodes=3,
                          sample_count=16, anneal_steps=8, solver="SA-JAX")
    xb, yb, maskb, nb = _pad_to_batches(X, Y, 8)
    xb, yb, maskb = jnp.asarray(xb), jnp.asarray(yb), jnp.asarray(maskb)

    p1, k1, n1 = _unrolled_epoch(sw._step, nb)(
        sw.params, xb, yb, maskb, 0.05, sw.keys)
    p2, k2, n2 = _scan_epoch(sw._step)(
        sw.params, xb, yb, maskb, 0.05, sw.keys)
    np.testing.assert_array_equal(np.asarray(n1), np.asarray(n2))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(k1)), np.asarray(jax.random.key_data(k2)))
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestBestEpochCapture:
    """VERDICT r3 Missing #1: sweep winners' (seed, epoch) checkpoints must
    be reloadable without retraining."""

    def test_track_best_updates_only_improved_seeds(self):
        import types

        import jax.numpy as jnp

        from qbmx.train.sweep import _track_best
        from qbmx.utils.metrics import History

        sw = types.SimpleNamespace(
            S=2, best_params=None, best_metric=np.full(2, -np.inf),
            best_epoch=np.zeros(2, dtype=int), _epochs_done=0,
            params={"w": jnp.asarray([[1.0], [10.0]])})
        h0, h1 = History(), History()
        h0.combined_acc_auc_per_epoch.append(0.6)
        h1.combined_acc_auc_per_epoch.append(0.8)
        _track_best(sw, [h0, h1], 1)
        np.testing.assert_array_equal(np.asarray(sw.best_params["w"]),
                                      [[1.0], [10.0]])
        # epoch 2: seed 0 improves, seed 1 regresses — only row 0 updates
        sw.params = {"w": jnp.asarray([[2.0], [20.0]])}
        h0.combined_acc_auc_per_epoch.append(0.7)
        h1.combined_acc_auc_per_epoch.append(0.5)
        _track_best(sw, [h0, h1], 2)
        np.testing.assert_array_equal(np.asarray(sw.best_params["w"]),
                                      [[2.0], [10.0]])
        np.testing.assert_array_equal(sw.best_epoch, [2, 1])
        np.testing.assert_allclose(sw.best_metric, [0.7, 0.8])
        # a later train() call (epoch counter restarts at 1) records the
        # CUMULATIVE epoch for new winners (VERDICT r4 review)
        sw._epochs_done = 2
        sw.params = {"w": jnp.asarray([[3.0], [30.0]])}
        h0.combined_acc_auc_per_epoch.append(0.9)
        h1.combined_acc_auc_per_epoch.append(0.4)
        _track_best(sw, [h0, h1], 1)
        np.testing.assert_array_equal(sw.best_epoch, [3, 1])

    def test_rbm_best_epoch_cumulative_across_sweep_calls(self, rng):
        """A winner found in a SECOND sweep() call must be labeled with its
        total training epoch, not the run-local index — its weights reflect
        all epochs so far."""
        from qbmx.train.sweep import SeedParallelRBM

        x, y = two_cluster_data(rng, n=48, D=8)
        tx, ty = two_cluster_data(rng, n=20, D=8)
        sweep = SeedParallelRBM([11, 12], num_visible=8, num_hidden=3,
                                learning_rate=0.2)
        acc1, auc1 = sweep.sweep(x, y, tx, ty, epochs=2, batch_size=12)
        acc2, auc2 = sweep.sweep(x, y, tx, ty, epochs=2, batch_size=12)
        # reconstruct the expected global winner per seed: call-2 entries
        # replace only on strict improvement (matching sweep()'s rule)
        for s in range(2):
            comb1 = 0.5 * np.asarray(acc1[s]) + 0.5 * np.asarray(auc1[s])
            comb2 = 0.5 * np.asarray(acc2[s]) + 0.5 * np.asarray(auc2[s])
            e1, e2 = int(np.argmax(comb1)), int(np.argmax(comb2))
            if comb2[e2] > comb1[e1]:
                expect = 2 + e2 + 1  # cumulative: 2 epochs already done
            else:
                expect = e1 + 1
            assert sweep.best_epoch[s] == expect, (s, sweep.best_epoch[s], expect)
        assert sweep._epochs_done == 4

    def test_dqbm_reload_winner(self, tmp_path, rng):
        from qbmx.train.sweep import SeedParallelDQBM

        x, y = two_cluster_data(rng)
        seeds = [0, 1]
        sweep = SeedParallelDQBM(seeds, dim_input=6, n_hidden_nodes=3,
                                 sample_count=512, sampler=ExactSampler())
        hists = sweep.train(x, y, x, y, epochs=5, batch_size=24,
                            learning_rate=0.3, verbose=False)
        for s in range(2):
            comb = hists[s].combined_acc_auc_per_epoch
            assert sweep.best_epoch[s] == int(np.argmax(comb)) + 1
            assert sweep.best_metric[s] == pytest.approx(max(comb))
        paths = sweep.save_best_models(tmp_path)
        assert set(paths) == set(seeds)
        assert all("best_model" in p for p in paths.values())

        # reload seed 0's winner into a fresh DiscQBM and check it IS the
        # snapshot (bitwise) and reproduces the recorded val accuracy
        model = DiscQBM(dim_input=6, n_hidden_nodes=3, seed=0,
                        sample_count=2048, sampler=ExactSampler(),
                        load_path=paths[0])
        snap = sweep.best_params_for_seed(0)
        for a, b in zip(jax.tree.leaves(model.params), jax.tree.leaves(snap)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        preds, _ = model.predict_batch(x)
        acc = float(np.mean(preds == y))
        best_acc = hists[0].acc_per_epoch[int(sweep.best_epoch[0]) - 1]
        assert abs(acc - best_acc) <= 0.1, (acc, best_acc)

    def test_cdqbm_reload_winner(self, tmp_path, rng):
        from qbmx.models.cdqbm import CDQBM
        from qbmx.samplers.api import GibbsSampler
        from qbmx.train.sweep import SeedParallelCDQBM

        donor = CDQBM(image_shape=(4, 4), num_label_nodes=1, seed=0,
                      kernel_size=3, pooling_size=2,
                      pooling_type="deterministic",
                      sequential_layer_sizes=[2], hidden_bias_type="shared",
                      sample_count=64, sampler=GibbsSampler(num_warmup=8))
        sweep = SeedParallelCDQBM([5, 6], donor)
        x = rng.uniform(0, 1, (24, 4, 4)).astype("float32")
        y = rng.integers(0, 2, 24).astype("float32")
        sweep.train(x, y, x, y, epochs=3, batch_size=12, learning_rate=0.2,
                    verbose=False)
        paths = sweep.save_best_models(tmp_path)
        fresh = CDQBM(image_shape=(4, 4), num_label_nodes=1, seed=99,
                      kernel_size=3, pooling_size=2,
                      pooling_type="deterministic",
                      sequential_layer_sizes=[2], hidden_bias_type="shared",
                      sample_count=64, sampler=GibbsSampler(num_warmup=8))
        fresh.load_params(paths[6])
        snap = sweep.best_params_for_seed(1)
        for a, b in zip(jax.tree.leaves(fresh.params), jax.tree.leaves(snap)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_rbm_reload_winner_exact_accuracy(self, tmp_path, rng):
        """RBM prediction is deterministic (exact p(y|x)), so the reloaded
        winner must reproduce its best-epoch test accuracy EXACTLY."""
        from qbmx.models.rbm import ClassificationRBM
        from qbmx.train.sweep import SeedParallelRBM

        x, y = two_cluster_data(rng, n=48, D=8)
        tx, ty = two_cluster_data(rng, n=20, D=8)
        sweep = SeedParallelRBM([11, 12], num_visible=8, num_hidden=3,
                                learning_rate=0.2)
        acc_lists, auc_lists = sweep.sweep(x, y, tx, ty, epochs=4,
                                           batch_size=12)
        comb = 0.5 * np.asarray(acc_lists) + 0.5 * np.asarray(auc_lists)
        for s in range(2):
            assert sweep.best_epoch[s] == int(np.argmax(comb[s])) + 1
        paths = sweep.save_best_models(tmp_path)
        rbm = ClassificationRBM(num_visible=8, num_hidden=3, seed=0)
        rbm.load_params(paths[11])
        acc, _ = rbm.run_test_set(tx, ty)
        assert acc == pytest.approx(
            acc_lists[0][int(sweep.best_epoch[0]) - 1])


class TestLateR5ReviewFixes:
    """Round-5 deep-review regressions: mesh-safe reinit scatter, persistent
    attempt counters, image-shaped RBM sweep inputs."""

    def test_reinit_seeds_under_dp_mesh(self, rng):
        """reinit_seeds on a mesh-sharded sweep must not crash on the
        row-scatter (fresh rows replicated over the SAME device set) and
        must leave the state dp-sharded and trainable."""
        from qbmx.parallel.mesh import make_mesh

        x, y = two_cluster_data(rng, n=16)
        seeds = [0, 1, 2, 3]
        kw = dict(dim_input=6, n_hidden_nodes=2, sample_count=8,
                  sampler=SASampler(num_sweeps=4, use_pallas=False))
        mesh = make_mesh(dp=4, chains=1)
        sharded = SeedParallelDQBM(seeds, **kw, mesh=mesh)
        plain = SeedParallelDQBM(seeds, **kw)
        sharded.reinit_seeds([1, 3])
        plain.reinit_seeds([1, 3])
        for a, b in zip(jax.tree.leaves(sharded.params),
                        jax.tree.leaves(plain.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))
        leaf = jax.tree.leaves(sharded.params)[0]
        assert len({sh.device for sh in leaf.addressable_shards}) == 4
        # the re-drawn state must train (the crash was inside the scatter,
        # but a mis-sharded result would die here instead)
        sharded.train(x, y, epochs=1, batch_size=8, learning_rate=0.1,
                      verbose=False)

    def test_reinit_attempts_persist_across_train_calls(self, rng):
        """A second train() call continues at attempt N+1 instead of
        re-drawing the attempt-1 basin that already flatlined."""
        x, y = two_cluster_data(rng, n=16)
        y0 = np.zeros_like(y)  # impossible majority threshold
        kw = dict(dim_input=6, n_hidden_nodes=2, sample_count=8,
                  sampler=SASampler(num_sweeps=4, use_pallas=False))
        sweep = SeedParallelDQBM([0, 1], **kw)
        # each call: 2 epochs, check fires at epoch 1 only (never after the
        # final epoch); lr=0 so params stay exactly at the re-drawn values
        for _ in range(2):
            sweep.train(x, y0, x, y0, epochs=2, batch_size=8,
                        learning_rate=0.0, verbose=False,
                        reinit_on_collapse=1)
        assert sweep._reinit_attempts == [2, 2]
        expect = SeedParallelDQBM([0, 1], **kw)
        expect.reinit_seeds([0, 1], attempt=2)
        for a, b in zip(jax.tree.leaves(sweep.params),
                        jax.tree.leaves(expect.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_rbm_sweep_accepts_image_shaped_inputs(self, rng):
        """(N, H, W) train AND test inputs must both flatten — the jitted
        sweep used to flatten train incidentally but crash on test."""
        from qbmx.train.sweep import SeedParallelRBM

        x = rng.uniform(0, 1, (24, 3, 2)).astype("float32")
        y = rng.integers(0, 2, 24).astype("float32")
        tx = rng.uniform(0, 1, (10, 3, 2)).astype("float32")
        sweep = SeedParallelRBM([0, 1], num_visible=6, num_hidden=3)
        acc_lists, auc_lists = sweep.sweep(x, y, tx, y[:10], epochs=2,
                                           batch_size=8)
        assert len(acc_lists) == 2 and len(acc_lists[0]) == 2

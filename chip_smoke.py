"""GPU smoke test of qbmx: the main path on the card, checked against the
plain references.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs: the sharded paths only

One GPU, in one process:

1. ``kernel_vs_xla`` — the Pallas anneal kernel as compiled for the card
   against the XLA sweeps (``sa_jax`` / ``gibbs``) with the same host
   variates, at the flat-QBM shape (n=6: 2 groups × 10 seeds × B=60,
   R=1000) and the CDQBM shape (n=41: B=60, R=100), S cut to 4 so the
   variates fit.  float32.  At most 1e-4 of spins may differ, and every
   differing chain must have met a near-tie (|δ − threshold| ≤
   1e-5·max|Q|) in the reference trajectory.
   ``kernel_vs_xla_time`` then times both routes at those shapes with
   the full S=1000.
2. ``oracle`` — kernel statistics against the exact enumeration oracle at
   n=6 and n=12: heat-bath marginals within 4 standard errors, SA
   ground-state frequency at least the XLA route's minus 4 s.e.
3. ``step_gpu_vs_cpu`` — one ``DiscQBM`` training step (784 inputs, H=5,
   EXACT sampler) on the GPU and on the CPU device with the same key:
   parameters within atol 1e-5.
4. ``qbm_sweep`` / ``cdqbm`` / ``rbm`` — the CLIs as a user runs them, on
   seeded synthetic data: one epoch of the 10-seed flat-QBM sweep at the
   reference's breastmnist setting (H=5, 1000 reads × 1000 sweeps, batch
   60), one CDQBM epoch at the n=41 shape (R=100, S=1000), one
   seed-parallel RBM epoch.  Losses must be finite.

``--four`` runs the (dp × chains) sharded DQBM and CDQBM steps and the
seed-sharded sweeps on four GPUs, each against its single-device result.

Prints the card's name and power limit, each phase's result and time, and
as its last line ``{"ok": true, "device": {...}}``.  Exits nonzero, with
no such line, if a phase fails or JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import runpy
import subprocess
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import qbmx  # noqa: E402,F401  (fails outside a checkout of the repo)

NEAR_TIE = 1e-5  # × max|Q|
MAX_DIFF_FRAC = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1. kernel vs XLA with host variates
# ---------------------------------------------------------------------------


def _reference_with_margins(rule, init01, uniforms, Q, hot, cold):
    """XLA sweeps (the ``sa_jax`` / ``gibbs`` single-variable rules) over a
    dense batch, also returning each chain's smallest |δ − threshold|."""
    from qbmx.core.qubo import geometric_beta_schedule, split_qubo

    S = uniforms.shape[0]
    betas = geometric_beta_schedule(hot, cold, S)  # (S, P)

    def one(s, u, bb, Qp):
        h, J = split_qubo(Qp)
        margin = jnp.full(s.shape[:1], jnp.inf)
        for t in range(S):
            if rule == "metropolis":
                thr = -jnp.log(u[t]) / bb[t]
            else:
                thr = (jnp.log(1.0 - u[t]) - jnp.log(u[t])) / bb[t]

            def body(i, c):
                s, m = c
                field = h[i] + jnp.dot(s, J[i], precision="highest")
                if rule == "metropolis":
                    delta = (1.0 - 2.0 * s[:, i]) * field
                    new = jnp.where(delta < thr[i], 1.0 - s[:, i], s[:, i])
                else:
                    delta = field
                    new = (field < thr[i]).astype(s.dtype)
                return s.at[:, i].set(new), jnp.minimum(m, jnp.abs(delta - thr[i]))

            s, margin = jax.lax.fori_loop(0, s.shape[1], body, (s, margin))
        return s, margin

    return jax.jit(jax.vmap(one))(init01, jnp.moveaxis(uniforms, 1, 0),
                                  betas.T, Q)


def _pair_reference(init01, uniforms, Q, hot, cold):
    from qbmx.core.qubo import geometric_beta_schedule, split_qubo
    from qbmx.samplers.gibbs import _pair_heat_bath_sweep

    S = uniforms.shape[0]
    betas = geometric_beta_schedule(hot, cold, S)

    def one(s, u, bb, Qp):
        h, J = split_qubo(Qp)
        for t in range(S):
            s = _pair_heat_bath_sweep(s, u[t], bb[t], h, J)
        return s

    return jax.jit(jax.vmap(one))(init01, jnp.moveaxis(uniforms, 1, 0),
                                  betas.T, Q)


def phase_kernel_vs_xla(log):
    from qbmx.core.qubo import default_beta_range, random_qubo_batch
    from qbmx.samplers.anneal_kernel import anneal_groups
    from qbmx.samplers.api import densify_groups

    rng = np.random.default_rng(0)
    S = 4
    log(f"{'shape':<24}{'rule':<12}{'spins':>12}{'differ':>8}"
        f"{'frac':>10}{'near-ties':>10}  kernel s")
    for name, (G, B, n, R) in {"n6 G20 B60 R1000": (20, 60, 6, 1000),
                               "n41 G2 B60 R100": (2, 60, 41, 100)}.items():
        Qg = random_qubo_batch(rng, G, n)
        he = jnp.asarray(rng.normal(size=(G, B, n)).astype(np.float32))
        init01 = jnp.asarray((rng.random((G, B, R, n)) < 0.5).astype(np.float32))
        u = jnp.asarray(np.clip(rng.random((S, G, B, n, R)).astype(np.float32),
                                1e-6, 1 - 1e-6))
        Qd = densify_groups(Qg, he)
        P = G * B
        hot0, cold0 = default_beta_range(Qd)
        scale = jnp.max(jnp.abs(Qd), axis=(1, 2))  # (P,)
        init_p = init01.reshape(P, R, n)
        u_p = u.reshape(S, P, n, R)
        for rule in ("metropolis", "heatbath", "pair"):
            if rule == "metropolis":
                hot, cold, kw = hot0, cold0, {}
            else:
                hot, cold = jnp.minimum(hot0, 1.0), jnp.ones(P)
                kw = dict(rule="heatbath", pair=rule == "pair",
                          beta_cold=jnp.ones((G, B)))
            t0 = time.perf_counter()
            out = jax.block_until_ready(anneal_groups(
                jax.random.key(0), Qg, he, R, S, debug_randoms=(init01, u), **kw))
            dt = time.perf_counter() - t0
            out = np.asarray(out).reshape(P, R, n)
            if rule == "pair":
                ref = np.asarray(_pair_reference(init_p, u_p, Qd, hot, cold))
                ties_ok, ties = True, "-"
            else:
                ref, margin = _reference_with_margins(rule, init_p, u_p, Qd,
                                                      hot, cold)
                ref, margin = np.asarray(ref), np.asarray(margin)
                bad_chain = np.any(out != ref, axis=-1)  # (P, R)
                tol = NEAR_TIE * np.asarray(scale)[:, None]
                ties_ok = bool(np.all(margin[bad_chain] <= np.broadcast_to(
                    tol, margin.shape)[bad_chain]))
                ties = "all" if ties_ok else "NO"
            diff = int(np.sum(out != ref))
            frac = diff / out.size
            log(f"{name:<24}{rule:<12}{out.size:>12}{diff:>8}{frac:>10.2e}"
                f"{ties:>10}  {dt:.3f}")
            if frac > MAX_DIFF_FRAC or not ties_ok:
                raise AssertionError(f"{name} {rule}: {diff} spins differ "
                                     f"(frac {frac:.2e}), near-ties {ties}")


def phase_kernel_vs_xla_time(log):
    """Sampler call times, kernel vs XLA, at the n=6 and n=41 model shapes
    (full S=1000), in turns XLA, kernel, kernel, XLA; medians of 3 calls
    after a compiling call (``scripts/anneal_kernel_ab.py``)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "scripts"))
    from anneal_kernel_ab import sampler_rows

    rows = list(sampler_rows(3, shapes=("n6", "n41")))
    log(f"{'shape':<6}{'sampler':<10}{'xla s':>22}{'kernel s':>22}{'speed-up':>10}")
    for shape in ("n6", "n41"):
        for sampler in ("SA", "BMS-pair"):
            t = {route: [r["seconds"] for r in rows if r["shape"] == shape
                         and r["sampler"] == sampler and r["route"] == route]
                 for route in ("xla", "kernel")}
            x, k = (" / ".join(f"{v:.5f}" for v in t[r]) for r in ("xla", "kernel"))
            log(f"{shape:<6}{sampler:<10}{x:>22}{k:>22}"
                f"{np.median(t['xla']) / np.median(t['kernel']):>9.1f}x")


# ---------------------------------------------------------------------------
# 2. statistics vs the exact oracle
# ---------------------------------------------------------------------------


def phase_oracle(log):
    from qbmx.core.qubo import qubo_energies
    from qbmx.samplers.api import GibbsSampler, SASampler
    from qbmx.samplers.exact import enumerate_states, exact_boltzmann

    rng = np.random.default_rng(1)
    R = 4096
    for n in (6, 12):
        Q = jnp.asarray(np.triu(rng.uniform(-1, 1, (4, n, n))), jnp.float32)
        for pair in (False, True):
            g = GibbsSampler(num_warmup=256, use_pallas=True, pair_updates=pair)
            s = np.asarray(g.sample_batch(jax.random.key(n), Q, R))
            worst = 0.0
            for b in range(Q.shape[0]):
                m = np.asarray(exact_boltzmann(Q[b], beta=1.0)[2])
                se = np.sqrt(np.maximum(m * (1 - m), 1e-6) / R)
                worst = max(worst, float(np.max(np.abs(s[b].mean(0) - m) / se)))
            log(f"heat-bath n={n} pair={pair}: worst marginal gap "
                f"{worst:.2f} s.e. over {Q.shape[0]} problems")
            if worst > 4.0:
                raise AssertionError(f"heat-bath n={n} pair={pair}: {worst:.2f} s.e.")
        Qs = jnp.asarray(np.triu(rng.uniform(-2, 2, (4, n, n))), jnp.float32)
        states = enumerate_states(n)
        k = np.asarray(SASampler(num_sweeps=200, use_pallas=True).sample_batch(
            jax.random.key(7), Qs, R))
        x = np.asarray(SASampler(num_sweeps=200, use_pallas=False).sample_batch(
            jax.random.key(7), Qs, R))
        for b in range(Qs.shape[0]):
            e = np.asarray(qubo_energies(Qs[b], states))
            gs = np.asarray(states[int(np.argmin(e))])
            pk = float(np.mean(np.all(k[b] == gs, axis=1)))
            px = float(np.mean(np.all(x[b] == gs, axis=1)))
            se = math.sqrt(max(px * (1 - px), 1.0 / R) / R)
            log(f"SA n={n} problem {b}: ground state kernel {pk:.4f} "
                f"xla {px:.4f} (4 s.e. = {4 * se:.4f})")
            if pk < px - 4 * se:
                raise AssertionError(f"SA n={n} problem {b}: {pk} < {px} - 4 s.e.")


# ---------------------------------------------------------------------------
# 3. one training step, GPU vs CPU
# ---------------------------------------------------------------------------


def phase_step_gpu_vs_cpu(log):
    from qbmx.models.dqbm import DiscQBM
    from qbmx.samplers.api import ExactSampler

    cpu = jax.devices("cpu")[0]
    model = DiscQBM(dim_input=784, n_hidden_nodes=5, seed=0, sample_count=4096,
                    sampler=ExactSampler())
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (60, 784)).astype(np.float32)
    y = rng.integers(0, 2, 60).astype(np.float32)
    args = (model.params, jnp.asarray(x), jnp.asarray(y),
            jnp.ones(60, jnp.float32), 0.307, jax.random.key(3))
    p_gpu, nll_gpu, _ = model._step(*args)
    p_cpu, nll_cpu, _ = model._step(*jax.device_put(args, cpu))
    assert next(iter(jax.tree.leaves(p_cpu)[0].devices())).platform == "cpu"
    diff = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(jax.tree.leaves(p_gpu), jax.tree.leaves(p_cpu)))
    moved = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                for a, b in zip(jax.tree.leaves(p_gpu),
                                jax.tree.leaves(model.params)))
    log(f"DiscQBM step (784 in, H=5, EXACT, B=60): max |gpu - cpu| param "
        f"{diff:.2e} (update size {moved:.2e}); nll gpu {float(nll_gpu):.6f} "
        f"cpu {float(nll_cpu):.6f}")
    if not diff <= 1e-5:
        raise AssertionError(f"GPU and CPU steps differ by {diff:.2e}")


# ---------------------------------------------------------------------------
# 4. the CLIs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _argv(*argv):
    old = sys.argv
    sys.argv = list(argv)
    try:
        yield
    finally:
        sys.argv = old


@contextlib.contextmanager
def _capture(module, name, sink):
    """Wrap ``module.name`` to record what it returns (or is given)."""
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        sink.append((a, kw, out))
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def phase_qbm_sweep(log):
    import qbmx.cli._common as common

    seen = []
    with _capture(common, "finish_seed_sweep", seen), _argv(
        "qbm_main", "--data_set", "synthetic", "--solver", "SA", "-hn", "5",
        "-sc", "1000", "--anneal", "1000", "-b", "60", "-lr", "0.307",
        "-e", "1", "--seed_sweep", *map(str, range(1, 11)), "--save", ""):
        runpy.run_module("qbmx.cli.qbm_main", run_name="__main__")
    (args, _, _), = seen
    hists = args[2]
    nll = [h.nll_per_epoch[-1] for h in hists]
    log(f"10-seed sweep epoch: nll per seed {np.round(nll, 4).tolist()}")
    if len(hists) != 10 or not np.all(np.isfinite(nll)):
        raise AssertionError(f"non-finite or missing losses: {nll}")


def phase_cdqbm(log):
    import qbmx.train.loop as loop
    from qbmx.models.cdqbm import CDQBM

    n = CDQBM(image_shape=(28, 28), num_label_nodes=1, seed=0, kernel_size=3,
              pooling_size=4, sequential_layer_sizes=[4]).geo.n_total
    seen = []
    with _capture(loop, "train_model", seen), _argv(
        "cdqbm_main", "--data_set", "synthetic", "-b", "60", "-sc", "100",
        "--anneal", "1000", "-e", "1", "--save", ""):
        runpy.run_module("qbmx.cli.cdqbm_main", run_name="__main__")
    (_, _, hist), = seen
    log(f"CDQBM (QUBO n={n}) epoch: nll {hist.nll_per_epoch}")
    if n != 41 or not np.all(np.isfinite(hist.nll_per_epoch)):
        raise AssertionError(f"n={n}, nll {hist.nll_per_epoch}")


def phase_rbm(log):
    import qbmx.train.sweep as sweep_mod

    seen = []
    with tempfile.TemporaryDirectory() as out, \
            _capture(sweep_mod.SeedParallelRBM, "sweep", seen), _argv(
            "rbm_main", "--epochs", "1", "--seed_parallel", "--data_set",
            "synthetic", "--out", out):
        runpy.run_module("qbmx.cli.rbm_main", run_name="__main__")
    (args, _, (accs, _)), = seen
    sw = args[0]
    finite = all(np.all(np.isfinite(np.asarray(p))) for p in jax.tree.leaves(sw.params))
    log(f"seed-parallel RBM epoch: {len(accs)} seeds, acc "
        f"{np.round([a[-1] for a in accs], 4).tolist()}, params finite {finite}")
    if not finite or not np.all(np.isfinite([a[-1] for a in accs])):
        raise AssertionError("non-finite RBM parameters or accuracy")


# ---------------------------------------------------------------------------
# --four: the sharded paths
# ---------------------------------------------------------------------------


def _max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def phase_sharded_steps(log):
    """The (dp × chains) steps against the single-device step (the
    tests/test_parallel.py equality: EXACT sampler, params within 0.05,
    nll within 0.2), then the same steps on the kernel route at the
    flagship and CDQBM widths."""
    from qbmx.models.cdqbm import CDQBM
    from qbmx.models.dqbm import DiscQBM
    from qbmx.parallel.mesh import (make_cdqbm_sharded_step,
                                    make_dqbm_sharded_step, make_mesh)
    from qbmx.samplers.api import ExactSampler, SASampler

    mesh = make_mesh(dp=2, chains=2)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(0, 1, (8, 4)), jnp.float32)
    y = jnp.asarray(rng.integers(0, 2, 8), jnp.float32)
    mask = jnp.ones((8,), jnp.float32)
    model = DiscQBM(dim_input=4, n_hidden_nodes=2, seed=0, sample_count=4096,
                    restricted=False, sampler=ExactSampler())
    single, nll1, _ = model._step(model.params, x, y, mask, 0.5, jax.random.key(2))
    sharded, nll2, _ = make_dqbm_sharded_step(model, mesh)(
        model.params, x, y, mask, 0.5, jax.random.key(2))
    d, dn = _max_diff(single, sharded), abs(float(nll1) - float(nll2))
    log(f"DQBM dp=2 x chains=2 vs single (EXACT): max param diff {d:.4f}, "
        f"nll diff {dn:.4f}")
    if d > 0.05 or dn > 0.2:
        raise AssertionError("sharded DQBM step disagrees with single device")

    cfg = dict(image_shape=(6, 6), num_label_nodes=1, seed=0, kernel_size=3,
               pooling_size=2, pooling_type="deterministic",
               sequential_layer_sizes=[3], hidden_bias_type="shared")
    cm = CDQBM(sample_count=4096, sampler=ExactSampler(), **cfg)
    xi = jnp.asarray(rng.uniform(0, 1, (8, 6, 6)), jnp.float32)
    single, nll1, _ = cm._step(cm.params, xi, y, mask, 0.3, jax.random.key(4))
    sharded, nll2, _ = make_cdqbm_sharded_step(cm, mesh)(
        cm.params, xi, y, mask, 0.3, jax.random.key(4))
    d, dn = _max_diff(single, sharded), abs(float(nll1) - float(nll2))
    log(f"CDQBM dp=2 x chains=2 vs single (EXACT): max param diff {d:.4f}, "
        f"nll diff {dn:.4f}")
    if d > 0.05 or dn > 0.2:
        raise AssertionError("sharded CDQBM step disagrees with single device")

    # kernel route at real widths under shard_map
    big = DiscQBM(dim_input=784, n_hidden_nodes=5, seed=0, sample_count=1000,
                  sampler=SASampler(num_sweeps=1000))
    xb = jnp.asarray(rng.uniform(0, 1, (60, 784)), jnp.float32)
    yb = jnp.asarray(rng.integers(0, 2, 60), jnp.float32)
    p, nll, _ = make_dqbm_sharded_step(big, mesh)(
        big.params, xb, yb, jnp.ones(60), 0.307, jax.random.key(5))
    cd = CDQBM(image_shape=(28, 28), num_label_nodes=1, seed=0, kernel_size=3,
               pooling_size=4, sequential_layer_sizes=[4], sample_count=100,
               sampler=SASampler(num_sweeps=1000))
    xc = jnp.asarray(rng.uniform(0, 1, (60, 28, 28)), jnp.float32)
    pc, nllc, _ = make_cdqbm_sharded_step(cd, mesh)(
        cd.params, xc, yb, jnp.ones(60), 0.01, jax.random.key(6))
    log(f"kernel route sharded: DQBM (784 in, H=5, R=1000, S=1000) nll "
        f"{float(nll):.4f}; CDQBM (n={cd.geo.n_total}, R=100, S=1000) nll "
        f"{float(nllc):.4f}")
    if not (np.isfinite(float(nll)) and np.isfinite(float(nllc))):
        raise AssertionError("non-finite sharded kernel-route loss")


def phase_seed_sharded(log):
    """Seed-sharded sweeps against the unsharded ones: SeedParallelDQBM on
    the kernel route (per-problem streams, so statistically identical;
    params within 0.05) and SeedParallelRBM (pure XLA: identical)."""
    from qbmx.data.loaders import synthetic_images
    from qbmx.parallel.mesh import make_mesh
    from qbmx.train.sweep import SeedParallelDQBM, SeedParallelRBM

    mesh = make_mesh(dp=4, chains=1)
    x, y = synthetic_images(180, seed=0)
    x = x.reshape(len(x), -1).astype(np.float32)
    tx, ty, vx, vy = x[:120], y[:120], x[120:], y[120:]
    seeds = list(range(1, 9))
    kw = dict(dim_input=784, n_hidden_nodes=5, sample_count=1000,
              anneal_steps=1000)
    runs = []
    for m in (None, mesh):
        sw = SeedParallelDQBM(seeds, mesh=m, **kw)
        hists = sw.train(tx, ty, vx, vy, epochs=1, batch_size=60,
                         learning_rate=0.307, verbose=False)
        runs.append((sw.params, [h.nll_per_epoch[-1] for h in hists]))
    d = _max_diff(runs[0][0], runs[1][0])
    log(f"SeedParallelDQBM 8 seeds, dp=4 vs unsharded: max param diff "
        f"{d:.2e}; nll {np.round(runs[1][1], 4).tolist()}")
    if d > 0.05 or not np.all(np.isfinite(runs[1][1])):
        raise AssertionError("seed-sharded DQBM sweep disagrees")

    rx = (x[:, :12] > 0.5).astype(np.float32)
    ref = SeedParallelRBM(seeds, 12, 3)
    a0, u0 = ref.sweep(rx[:24], y[:24], rx[24:34], y[24:34], epochs=3,
                       batch_size=6)
    sh = SeedParallelRBM(seeds, 12, 3, mesh=make_mesh(dp=4, chains=1))
    a1, u1 = sh.sweep(rx[:24], y[:24], rx[24:34], y[24:34], epochs=3,
                      batch_size=6)
    d = _max_diff(ref.params, sh.params)
    log(f"SeedParallelRBM 8 seeds, dp=4 vs unsharded: accs equal {a0 == a1}, "
        f"aucs equal {u0 == u1}, max param diff {d:.2e}")
    if not (a0 == a1 and u0 == u1 and d <= 1e-6):
        raise AssertionError("seed-sharded RBM sweep disagrees")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devs)}", file=sys.stderr)
        return 2
    from qbmx.cli._common import enable_compile_cache

    print(card_line(), flush=True)
    print(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}, "
          f"compile cache {enable_compile_cache()}", flush=True)

    phases = ([("sharded_steps", phase_sharded_steps),
               ("seed_sharded", phase_seed_sharded)] if args.four else
              [("kernel_vs_xla", phase_kernel_vs_xla),
               ("kernel_vs_xla_time", phase_kernel_vs_xla_time),
               ("oracle", phase_oracle),
               ("step_gpu_vs_cpu", phase_step_gpu_vs_cpu),
               ("qbm_sweep", phase_qbm_sweep), ("cdqbm", phase_cdqbm),
               ("rbm", phase_rbm)])
    failed = []
    for name, fn in phases:
        def log(msg, _name=name):
            print(f"  [{_name}] {msg}", flush=True)

        t0 = time.perf_counter()
        try:
            fn(log)
            status = "ok"
        except Exception:
            traceback.print_exc()
            status = "FAILED"
            failed.append(name)
        print(f"PHASE {name}: {status} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Annealing-time scaling microbenchmark.

Parity with the reference's ``get_annealing_time`` two-batch probe
(``src/model/faster_dqbm.py:1267-1329``) and its
``anneal_time_per_qbm_size`` figure (``src/paper_plots/``): measures
sampler wall time as a function of QBM size for each backend and writes a
CSV (+ optional PNG with --plot).

Usage: python scripts/anneal_time_bench.py [--reads 100] [--sweeps 1000]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse
import csv
import time

import jax
import jax.numpy as jnp
import numpy as np
from qbmx.core.qubo import random_qubo_batch


def time_groups(sampler, Qs, h, reads, reps=3):
    """Structured shared-coupling call (sampler_sample_groups route —
    the anneal kernel on a GPU)."""
    jax.block_until_ready(sampler.sample_groups(jax.random.key(0), Qs, h, reads))
    t0 = time.perf_counter()
    for i in range(reps):
        jax.block_until_ready(
            sampler.sample_groups(jax.random.key(i + 1), Qs, h, reads))
    return (time.perf_counter() - t0) / reps


def time_sampler(sampler, Q, reads, reps=3):
    jax.block_until_ready(sampler.sample_batch(jax.random.key(0), Q, reads))
    t0 = time.perf_counter()
    for i in range(reps):
        jax.block_until_ready(
            sampler.sample_batch(jax.random.key(i + 1), Q, reads))
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=100)
    ap.add_argument("--sweeps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=60)
    ap.add_argument("--sizes", type=int, nargs="*", default=[4, 8, 16, 32, 64, 128])
    ap.add_argument("--out", type=str, default="out/anneal_time_per_qbm_size.csv")
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args()

    from qbmx.samplers.api import get_sampler
    from qbmx.samplers.native import native_available

    solvers = ["SA", "SA-JAX", "BMS"]
    if native_available():
        solvers.append("SA-NATIVE")

    from qbmx.samplers.api import densify_groups

    lane_cols = ["SA-GROUPS", "BMS-GROUPS"]
    rng = np.random.default_rng(0)
    rows = []
    for n in args.sizes:
        # shared-coupling ensemble: one J per size + per-problem linear
        # terms, densified for the dense samplers so every column anneals
        # the IDENTICAL problems (the structured columns take the
        # (Q_shared, h) form the models hand samplers)
        Qs = random_qubo_batch(rng, 1, n)
        h = jnp.asarray(rng.normal(size=(1, args.batch, n)).astype(np.float32))
        Q = densify_groups(Qs, h)
        row = {"n": n}
        for solver in solvers:
            # BMS defaults to sweeps//16 warmup passes; pin it to --sweeps so
            # every column in the CSV/plot runs the same number of sweeps
            s = get_sampler(solver, num_sweeps=args.sweeps, num_warmup=args.sweeps)
            row[solver] = round(time_sampler(s, Q, args.reads) * 1000, 2)
        for col, solver in zip(lane_cols, ["SA", "BMS"]):
            s = get_sampler(solver, num_sweeps=args.sweeps, num_warmup=args.sweeps)
            row[col] = round(time_groups(s, Qs, h, args.reads) * 1000, 2)
        rows.append(row)
        print(row)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["n"] + solvers + lane_cols)
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for solver in solvers + lane_cols:
            plt.plot([r["n"] for r in rows], [r[solver] for r in rows], marker="o",
                     label=solver)
        plt.xlabel("QBM size (variables)")
        plt.ylabel(f"ms per batch ({args.batch}×{args.reads} reads, {args.sweeps} sweeps)")
        plt.legend()
        plt.yscale("log")
        png = args.out.replace(".csv", ".png")
        plt.savefig(png, bbox_inches="tight")
        print(f"wrote {png}")


if __name__ == "__main__":
    main()

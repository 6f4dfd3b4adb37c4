"""Anneal kernel vs XLA samplers on the GPU, in one process, in turns.

Sampler shapes (structured ``sample_groups`` calls, as the models make):

* n=6:   20 groups (2 phases × 10 seeds) × B=60, R=1000, S=1000
* n=41:  2 groups × B=60, R=100, S=1000
* n=717: 2 groups × B=200, R=100, S=100 (above ``MAX_N``: XLA only)

End to end: one epoch of the 10-seed flat-QBM sweep (784 inputs, H=5,
R=1000, S=1000, batch 60, synthetic data) with ``"SA"`` (kernel) vs
``"SA-JAX"`` (XLA).

Order per shape: XLA, kernel, kernel, XLA; each entry is the median of
``--reps`` calls ending in ``block_until_ready``, compilation excluded.

    python scripts/anneal_kernel_ab.py [--reps 5] [--out ab.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from qbmx.core.qubo import random_qubo_batch  # noqa: E402
from qbmx.samplers.api import GibbsSampler, SASampler, sampler_sample_groups  # noqa: E402

SHAPES = {"n6": (20, 60, 6, 1000, 1000), "n41": (2, 60, 41, 100, 1000),
          "n717": (2, 200, 717, 100, 100)}


def median_s(fn, reps):
    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def sampler_rows(reps, shapes=tuple(SHAPES)):
    rng = np.random.default_rng(0)
    for name in shapes:
        G, B, n, R, S = SHAPES[name]
        Qg = random_qubo_batch(rng, G, n)
        h = jnp.asarray(rng.normal(size=(G, B, n)).astype(np.float32))
        for label, make in [
            ("SA", lambda k: SASampler(num_sweeps=S, use_pallas=k)),
            ("BMS-pair", lambda k: GibbsSampler(num_warmup=S, use_pallas=k,
                                                pair_updates=True)),
        ]:
            routes = [("xla", False)] + ([("kernel", True)] * 2 if n <= 64 else []) + [("xla", False)]
            for route, k in routes:
                s = make(k)
                t = median_s(lambda: sampler_sample_groups(
                    s, jax.random.key(1), Qg, h, R), reps)
                yield dict(shape=name, sampler=label, route=route, seconds=t,
                           spin_updates_per_s=G * B * R * S * n / t)


def sweep_rows(reps):
    from qbmx.data.loaders import preprocess_images, synthetic_images
    from qbmx.train.sweep import SeedParallelDQBM

    x, y = synthetic_images(800, seed=0)
    tx, _, vx = preprocess_images(x[:600], x[700:], x[600:700])
    ty, vy = y[:600], y[600:700]
    sweeps = {}
    for solver in ("SA-JAX", "SA"):
        sw = SeedParallelDQBM(list(range(1, 11)), dim_input=784, n_hidden_nodes=5,
                              sample_count=1000, anneal_steps=1000, solver=solver)
        sw.train(tx, ty, vx, vy, epochs=1, batch_size=60, learning_rate=0.307,
                 verbose=False)  # compile
        sweeps[solver] = sw
    for solver in ("SA-JAX", "SA", "SA", "SA-JAX"):
        sw = sweeps[solver]
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            sw.train(tx, ty, vx, vy, epochs=1, batch_size=60,
                     learning_rate=0.307, verbose=False)
            ts.append(time.perf_counter() - t0)
        yield dict(shape="sweep_epoch_10seeds", sampler="SA",
                   route="kernel" if solver == "SA" else "xla",
                   seconds=float(np.median(ts)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=str, default="")
    a = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("anneal_kernel_ab.py measures a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rows = []
    for row in list(sampler_rows(a.reps)) + list(sweep_rows(max(a.reps // 2, 1))):
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")


if __name__ == "__main__":
    main()

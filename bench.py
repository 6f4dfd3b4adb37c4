"""Driver-facing benchmark battery.

Emits one JSON line per metric; the HEADLINE metric (CD-1 RBM training
throughput on binarized MNIST, north star ≥100k images/sec/chip,
BASELINE.json) prints LAST so a last-line parser keeps recording it.
Extra rows (VERDICT r4 #3 — the driver benchmark must also see the
reference-shape model and the sampler core, SURVEY §6):

1. reference-shape RBM (H=9, the reference's ``rbm_main.py:14-20`` config)
   with an MFU estimate,
2. SA sampler spin-update throughput at the breastmnist training shape
   (B=60, n=6, 1000 reads × 1000 sweeps — ``sample_count``/``anneal_steps``
   of the BASELINE sweep row),
3. same at the CDQBM shape (B=60, n=41, 100 reads × 1000 sweeps).

``vs_baseline``: RBM rows divide by the 100k img/s north star; SA rows
divide by the reference's process-pool neal rate derived from its own
profile (``src/paper_plots/s20_vectorized_parallelized.prof``: 600
``get_samples`` calls = 19.89 s at sample_count=20, 1000 neal sweeps,
n≈6 → ≈3.6e6 spin-updates/sec).

Every row names the device it ran on; the run fails when JAX finds no
GPU.  Times are medians of calls that end in ``block_until_ready``, with
compilation left out.
"""

from __future__ import annotations

import json
import time

import numpy as np

#: reference neal-pool spin-update rate (derivation in the module docstring)
REF_SA_SPIN_UPDATES_PER_SEC = 3.6e6


def gpu_device() -> dict:
    """The device every row is measured on; raises when JAX finds no GPU
    (a CPU number must never be recorded under a device metric)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"bench.py measures a GPU; JAX found {devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def median_seconds(fn, trials: int = 5) -> float:
    """Median wall time of ``fn()`` over ``trials`` calls that each end in
    ``block_until_ready`` (call ``fn`` once before to compile)."""
    import jax

    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def load_images(n_target: int = 65536):
    from qbmx.data import loaders

    try:
        x, y = loaders.get_mnist(
            "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz", classes=[0, 1]
        )
    except FileNotFoundError:
        x, y = loaders.synthetic_images(4096, shape=(28, 28), num_classes=2, seed=0)
    x = loaders.binarize(x.reshape(len(x), -1))
    y = np.asarray(y)
    reps = max(n_target // len(x), 1)
    x = np.tile(x, (reps, 1))[:n_target]
    y = np.tile(y, reps)[:n_target]
    return x, y


def measure_rbm(x, y, batch_size: int, num_hidden: int, reps: int = 200):
    """CD-1 RBM training images/sec at (batch, hidden)."""
    import jax
    import jax.numpy as jnp

    from qbmx.models.rbm import init_params, make_epoch_scan, make_train_step

    n = (len(x) // batch_size) * batch_size
    nb = n // batch_size
    # bf16 compute mode: binary states and stats matmuls at bf16 (params
    # and updates stay f32); accuracy at this config is checked by
    # scripts/bench_accuracy.py
    xb = jnp.asarray(x[:n].reshape(nb, batch_size, -1), dtype=jnp.bfloat16)
    yb = jnp.asarray(y[:n].reshape(nb, batch_size), dtype=jnp.int32)

    step = make_train_step(num_classes=2, method="generative", cd_k=1,
                           compute_dtype=jnp.bfloat16)
    epoch = make_epoch_scan(step)
    params = init_params(jax.random.key(0), xb.shape[-1], num_hidden, 2)
    # rbg PRNG: XLA's RngBitGenerator instead of threefry for the Gibbs
    # bernoulli draws
    key = jax.random.key(1, impl="rbg")

    @jax.jit
    def run_epochs(params, key):
        def body(carry, k):
            p, acc = carry
            p, loss = epoch(p, k, xb, yb, 0.05)
            return (p, acc + loss), None

        (p, acc), _ = jax.lax.scan(
            body, (params, jnp.float32(0)), jax.random.split(key, reps)
        )
        return p, acc

    jax.block_until_ready(run_epochs(params, key))  # compile + warmup
    per_epoch = median_seconds(lambda: run_epochs(params, key), trials=3) / reps
    return n / per_epoch


def emit_rbm_row(metric: str, imgs_per_sec: float, device: dict):
    print(json.dumps({
        "metric": metric,
        "value": round(imgs_per_sec, 1),
        "unit": "images/sec",
        "vs_baseline": round(imgs_per_sec / 100_000.0, 3),
        "device": device,
    }), flush=True)


def measure_sa(B: int, n: int, reads: int, sweeps: int):
    """Spin-update throughput of the routed SA sampler (the exact call
    training makes) at a (B, n, reads, sweeps) shape."""
    import jax
    import jax.numpy as jnp

    from qbmx.core.qubo import random_qubo_batch
    from qbmx.samplers.api import get_sampler

    rng = np.random.default_rng(1)
    Q = jnp.asarray(random_qubo_batch(rng, B, n))
    sampler = get_sampler("SA", num_sweeps=sweeps)

    def call():
        return sampler.sample_batch(jax.random.key(1), Q, reads)

    jax.block_until_ready(call())  # compile + warmup
    return B * reads * sweeps * n / median_seconds(call)


def emit_sa_row(metric: str, spin_updates_per_sec: float, device: dict):
    print(json.dumps({
        "metric": metric,
        "value": round(spin_updates_per_sec, 1),
        "unit": "spin_updates/sec",
        "vs_baseline": round(spin_updates_per_sec / REF_SA_SPIN_UPDATES_PER_SEC, 3),
        "device": device,
    }), flush=True)


def main(batch_size: int = 4096, num_hidden: int = 128, headline_only: bool = False):
    # the reference uses H=9 — that row prints too
    from qbmx.cli._common import enable_compile_cache

    device = gpu_device()
    enable_compile_cache()
    x, y = load_images()

    if not headline_only:
        emit_rbm_row("mnist_cd1_rbm_train_throughput_h9_reference_shape",
                     measure_rbm(x, y, batch_size, 9), device)
        emit_sa_row("sa_sampler_throughput_breastmnist_shape",
                    measure_sa(B=60, n=6, reads=1000, sweeps=1000), device)
        emit_sa_row("sa_sampler_throughput_cdqbm_shape",
                    measure_sa(B=60, n=41, reads=100, sweeps=1000), device)

    emit_rbm_row("mnist_cd1_rbm_train_throughput",
                 measure_rbm(x, y, batch_size, num_hidden), device)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--headline_only", action="store_true",
                    help="skip the reference-shape and sampler rows")
    a = ap.parse_args()
    main(batch_size=a.batch, num_hidden=a.hidden, headline_only=a.headline_only)

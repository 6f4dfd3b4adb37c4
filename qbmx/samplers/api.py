"""Uniform sampler interface + registry.

The reference dispatches on solver strings at ``src/model/faster_dqbm.py:571-684``
("SA" / "BMS" / D-Wave names) and wraps the modular version in
``LocalSASampler`` / ``DWaveAdapter`` (``src/qubo/sampler.py:19-51``).  Here a
sampler is a small config object with one method:

    sample_batch(key, Q, num_reads) -> (B, num_reads, n) float32 in {0,1}

where ``Q`` is a batch (B, n, n) of dense upper-triangular QUBOs.  Solver
names accepted by :func:`get_sampler` keep the reference CLI vocabulary:
``"SA"`` (annealed Metropolis: the Pallas anneal kernel on a GPU, pure JAX
elsewhere), ``"SA-JAX"`` (force the pure-JAX path), ``"SA-NATIVE"`` (host
C++ sampler), ``"PT"`` (parallel tempering), ``"BMS"`` (annealed heat-bath
Boltzmann sampler), ``"EXACT"`` (enumeration oracle, n ≤ 20).  D-Wave solver
names raise with a pointer to the QPU adapter seam — there is deliberately no
cloud dependency (BASELINE.json: "no Ocean SDK or cloud secrets").
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import jax
import jax.numpy as jnp

from qbmx.samplers import anneal_kernel as _anneal
from qbmx.samplers import exact as _exact
from qbmx.samplers import gibbs as _gibbs
from qbmx.samplers import sa_jax as _sa_jax


class Sampler(Protocol):
    def sample_batch(self, key: jax.Array, Q: jax.Array, num_reads: int) -> jax.Array:
        """(B, n, n) QUBOs → (B, num_reads, n) binary samples."""
        ...


def sampler_jit_safe(sampler) -> bool:
    """Capability flag: can ``sample_batch`` be traced inside jit?

    Declared by the sampler itself (``jit_safe`` attribute/property,
    default True).  False for host-bound samplers such as the QPU adapter
    (each sample is a network call).  Models build their training step
    EAGERLY for such samplers instead of special-casing sampler types."""
    return bool(getattr(sampler, "jit_safe", True))


def sampler_scan_safe(sampler, n: int, num_reads: int) -> bool:
    """Capability flag: can ``sample_batch`` live inside ``lax.scan``?

    Implies jit-safety.  A sampler may decline with a ``scan_safe(n,
    num_reads)`` method; the epoch launchers then take the unrolled-segment
    path.  Every built-in jit-safe sampler scans."""
    if not sampler_jit_safe(sampler):
        return False
    scan_safe = getattr(sampler, "scan_safe", None)
    return bool(scan_safe(n, num_reads)) if scan_safe is not None else True


def sampler_scan_safe_groups(sampler, n: int, num_problems: int,
                             num_reads: int, groups: int = 2) -> bool:
    """Can a ``sampler_sample_groups`` call with these EXACT shapes live
    inside ``lax.scan``?  A sampler may answer per shape with a
    ``scan_safe_groups`` method; otherwise its ``scan_safe`` (or its
    jit-safety) decides."""
    if not sampler_jit_safe(sampler):
        return False
    fn = getattr(sampler, "scan_safe_groups", None)
    if fn is not None:
        return bool(fn(n, num_problems, num_reads, groups))
    return sampler_scan_safe(sampler, n, num_reads)


def densify_groups(Q_shared, h_extra):
    """(G, n, n) shared QUBOs + (G, B, n) per-problem linear terms → the
    (G*B, n, n) dense batch they represent (fallback path for samplers
    without a structured fast path)."""
    n = Q_shared.shape[-1]
    diag = jax.vmap(jax.vmap(jnp.diagflat))(h_extra.astype(jnp.float32))
    return (Q_shared[:, None] + diag).reshape(-1, n, n)


def _sample_dense(sampler, key, Q_shared, h_extra, num_reads):
    """Structured call served by ``sample_batch`` on the densified batch,
    with the same per-problem keys (one key is split into G·B)."""
    G, B, n = h_extra.shape
    keys = key.reshape(-1) if key.ndim else key
    flat = sampler.sample_batch(keys, densify_groups(Q_shared, h_extra),
                                num_reads)
    return flat.reshape(G, B, num_reads, n)


def sampler_sample_groups(sampler, key, Q_shared, h_extra, num_reads):
    """Structured shared-coupling sampling: every qbmx QUBO family shares
    its couplings across the batch (only linear terms vary per example —
    see qbmx.samplers.anneal_kernel), so models hand samplers ``Q_shared``
    (G, n, n) + ``h_extra`` (G, B, n) instead of G·B dense matrices.
    Samplers with a ``sample_groups`` method (SA/BMS) exploit the
    structure; everything else densifies and runs ``sample_batch``.
    Returns (G, B, num_reads, n)."""
    fn = getattr(sampler, "sample_groups", None)
    if fn is not None:
        return fn(key, Q_shared, h_extra, num_reads)
    return _sample_dense(sampler, key, Q_shared, h_extra, num_reads)


def kernel_route(use_pallas: bool | None, n: int) -> bool:
    """Anneal-kernel vs XLA routing for SA/BMS.

    ``use_pallas`` True/False forces a route.  ``None`` takes the kernel
    on a GPU for QUBOs of at most ``anneal_kernel.MAX_N`` variables (a
    chain's spins and fields stay in registers) and the XLA samplers
    everywhere else, including the n=717 CDQBM shape."""
    if use_pallas is not None:
        return use_pallas
    return n <= _anneal.MAX_N and jax.default_backend() == "gpu"


def _as_groups(Q):
    """Dense (B, n, n) batch → one group per problem: (Q, zeros (B, 1, n))."""
    return Q, jnp.zeros((Q.shape[0], 1, Q.shape[-1]), jnp.float32)


@dataclasses.dataclass(frozen=True)
class SASampler:
    """Annealed Metropolis sampler (neal-equivalent). ``num_sweeps`` matches
    the reference's ``anneal_steps`` knob.  ``use_pallas``: None = auto
    (:func:`kernel_route`), True/False force the anneal kernel / XLA."""

    num_sweeps: int = 1000
    use_pallas: bool | None = None

    def sample_batch(self, key, Q, num_reads):
        if kernel_route(self.use_pallas, Q.shape[-1]):
            return self._anneal(key, *_as_groups(Q), num_reads)[:, 0]
        return _sa_jax.sa_sample_batch(key, Q, num_reads, self.num_sweeps)

    def sample_groups(self, key, Q_shared, h_extra, num_reads):
        """Structured shared-coupling path (see sampler_sample_groups)."""
        if kernel_route(self.use_pallas, Q_shared.shape[-1]):
            return self._anneal(key, Q_shared, h_extra, num_reads)
        return _sample_dense(self, key, Q_shared, h_extra, num_reads)

    def _anneal(self, key, Q_shared, h_extra, num_reads):
        return _anneal.anneal_groups(key, Q_shared, h_extra, num_reads,
                                     self.num_sweeps, rule="metropolis")


@dataclasses.dataclass(frozen=True)
class GibbsSampler:
    """Annealed heat-bath sampler — the "BMS" solver equivalent.

    ``pair_updates``: resample consecutive variable PAIRS from their exact
    4-state conditionals instead of one variable at a time — half the
    sequential sub-steps per sweep, same stationary distribution
    (sequential-scan pair Gibbs).  ``None`` (the default) enables pairs on
    the kernel route and keeps the XLA path on single-variable sweeps;
    pass True/False to force both paths.

    ``quad_updates``: widen the joint update to variable QUADRUPLES (exact
    16-state conditionals) on the XLA path.  The kernel has no quad
    variant, so there ``quad_updates=True`` runs pairs.  Takes precedence
    over ``pair_updates`` when set."""

    num_warmup: int = 64
    beta: float = 1.0
    use_pallas: bool | None = None
    pair_updates: bool | None = None
    quad_updates: bool | None = None

    def sample_batch(self, key, Q, num_reads):
        if kernel_route(self.use_pallas, Q.shape[-1]):
            return self._anneal(key, *_as_groups(Q), num_reads)[:, 0]
        quad = self.quad_updates is True
        return _gibbs.gibbs_sample_batch(key, Q, num_reads, self.num_warmup,
                                         self.beta,
                                         pair=not quad and bool(self.pair_updates),
                                         quad=quad)

    def sample_groups(self, key, Q_shared, h_extra, num_reads):
        """Structured shared-coupling path (see sampler_sample_groups)."""
        if kernel_route(self.use_pallas, Q_shared.shape[-1]):
            return self._anneal(key, Q_shared, h_extra, num_reads)
        return _sample_dense(self, key, Q_shared, h_extra, num_reads)

    def _anneal(self, key, Q_shared, h_extra, num_reads):
        return _anneal.anneal_groups(
            key, Q_shared, h_extra, num_reads, self.num_warmup,
            rule="heatbath",
            beta_cold=jnp.full(h_extra.shape[:2], self.beta, jnp.float32),
            # quad precedence: quad_updates=True runs PAIRS here (no kernel
            # quad variant) even when pair_updates=False
            pair=self.quad_updates is True or self.pair_updates is not False)


@dataclasses.dataclass(frozen=True)
class PTSampler:
    """Parallel-tempering (replica exchange) sampler at a target beta —
    better mixing than one-way annealing on frustrated landscapes.  Runs
    the XLA ladder (``qbmx.samplers.tempering``); structured
    ``sample_groups`` calls reach it through the densify fallback.
    Measured (10-seed breastmnist training A/B,
    ``out/parity/pt_training_ab.log``): PT reaches the same metric band as
    BMS."""

    num_sweeps: int = 64
    num_replicas: int = 8
    beta_target: float = 1.0

    def sample_batch(self, key, Q, num_reads):
        from qbmx.samplers.tempering import pt_sample_batch

        return pt_sample_batch(key, Q, num_reads, self.num_sweeps,
                               self.num_replicas, self.beta_target)


@dataclasses.dataclass(frozen=True)
class ExactSampler:
    """Exact enumeration oracle (n ≤ 20). The test anchor for everything else."""

    beta: float = 1.0

    def sample_batch(self, key, Q, num_reads):
        B = Q.shape[0]
        keys = key if key.ndim else jax.random.split(key, B)
        return jax.vmap(lambda k, q: _exact.exact_sample(k, q, num_reads, self.beta))(keys, Q)


def get_sampler(solver: str, num_sweeps: int = 1000, **kwargs) -> Sampler:
    """Solver-string registry.  ``num_sweeps`` means *sweeps per read* for
    EVERY solver (the reference's ``anneal_steps`` knob): SA anneal sweeps,
    BMS warmup sweeps, PT sweeps at the target temperature.  Passing the
    legacy ``num_warmup`` kwarg still overrides the sweep count for BMS/PT
    (deprecated alias, kept so round-1 call sites don't change meaning)."""
    s = solver.upper()
    if s == "SA":
        return SASampler(num_sweeps=num_sweeps, use_pallas=kwargs.get("use_pallas"))
    if s == "SA-JAX":
        return SASampler(num_sweeps=num_sweeps, use_pallas=False)
    if s == "SA-NATIVE":
        from qbmx.samplers.native import NativeSASampler

        return NativeSASampler(num_sweeps=num_sweeps)
    if s == "BMS":
        return GibbsSampler(
            num_warmup=kwargs.get("num_warmup", num_sweeps),
            beta=kwargs.get("beta", 1.0),
            use_pallas=kwargs.get("use_pallas"),
            pair_updates=kwargs.get("pair_updates"),
            quad_updates=kwargs.get("quad_updates"),
        )
    if s == "PT":
        return PTSampler(
            num_sweeps=kwargs.get("num_warmup", num_sweeps),
            num_replicas=kwargs.get("num_replicas", 8),
            beta_target=kwargs.get("beta", 1.0),
        )
    if s == "EXACT":
        return ExactSampler(beta=kwargs.get("beta", 1.0))
    if s.startswith("ADVANTAGE") or s.startswith("DW_"):
        # dimod-compatible adapter: works iff the Ocean SDK is installed,
        # otherwise raises with guidance (still no hard dependency).
        # ``embedding="first_party"`` (the default) wraps the RAW structured
        # sampler and runs qbmx's own cached, partition-aware embedding
        # pipeline (qbmx.embedding); ``embedding="composite"`` keeps the
        # r2-era EmbeddingComposite delegation.
        if kwargs.get("embedding", "first_party") == "composite":
            from qbmx.samplers.qpu import QPUSampler

            return QPUSampler.from_ocean(solver, token=kwargs.get("token"),
                                         copies=kwargs.get("copies", 1))
        from qbmx.samplers.qpu import StructuredQPUSampler

        return StructuredQPUSampler.from_ocean(
            solver, token=kwargs.get("token"), copies=kwargs.get("copies", 1),
            cache_dir=kwargs.get("cache_dir"),
            chain_strength=kwargs.get("chain_strength"))
    if s == "FUJITSUDAU":
        raise NotImplementedError(
            f"QPU solver {solver!r}: qbmx is annealer-free by design. Pass any "
            "dimod-style sampler to qbmx.samplers.qpu.QPUSampler to adapt "
            "external hardware."
        )
    raise ValueError(
        f'Unknown solver {solver!r}. Valid: "SA", "SA-JAX", "SA-NATIVE", '
        '"BMS", "PT", "EXACT", or a D-Wave solver name with '
        "the Ocean SDK installed."
    )

"""Routing-invariant property tests for the anneal kernel's shape rule.

The kernel-vs-XLA decision (``api.kernel_route``) and the kernel's read
blocking (``anneal_kernel.read_block``) are pure host math.  These tests
sweep hundreds of randomized (n, B, R, G) tuples asserting:

1. ``read_block`` always yields a Triton-legal block (a power of two, at
   least one warp) whose programs cover every read with less than one
   block of padding;
2. the shape rule takes the kernel exactly for n <= MAX_N on a GPU, and
   never off a GPU unless forced;
3. the route ``sample_groups`` actually takes equals the rule's answer,
   for both SA and BMS (kernel and XLA entry points stubbed with
   recorders), and every route is scan-safe.

All host math + stubbed kernels: runs in the default CPU tier.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qbmx.samplers.anneal_kernel as ak
from qbmx.samplers import api, gibbs, sa_jax
from qbmx.samplers.api import GibbsSampler, SASampler

NS = sorted(set(
    [1, 2, 3, 5, 6, 9, 10, 16, 41, 63, 64, 65, 100, 245, 717]
    + [int(x) for x in np.random.default_rng(20260820).integers(1, 800, size=40)]
))
BS = [1, 2, 7, 8, 20, 60, 73, 120, 256, 600]
RS = [1, 16, 31, 32, 33, 100, 128, 200, 1000, 1024]
GS = [1, 2, 3, 20]


def _tuples(k=400, seed=0):
    """Deterministic PER-CALL draw stream (no shared module RNG, so each
    test's tuples do not depend on which tests ran before it)."""
    rng = np.random.default_rng(20260820 + seed)
    for _ in range(k):
        yield (int(rng.choice(NS)), int(rng.choice(BS)),
               int(rng.choice(RS)), int(rng.choice(GS)))


class TestReadBlock:
    @pytest.mark.parametrize("block", [32, 64, 128, 256])
    def test_block_is_legal_and_covers_reads(self, block):
        for _, _, R, _ in _tuples(300, seed=1):
            lb = ak.read_block(R, block)
            assert lb >= 32 and lb & (lb - 1) == 0, (R, block, lb)
            assert lb <= max(block, 32)
            C = -(-R // lb)
            assert C * lb >= R and C * lb - R < lb, (R, block, lb, C)
            if R <= block:
                assert C == 1  # a problem's reads fit one program


class TestShapeRule:
    def test_rule_on_and_off_gpu(self, monkeypatch):
        for n, _, _, _ in _tuples(200, seed=2):
            assert not api.kernel_route(None, n)  # CPU backend
            assert api.kernel_route(True, n) and not api.kernel_route(False, n)
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        for n, _, _, _ in _tuples(200, seed=3):
            assert api.kernel_route(None, n) == (n <= ak.MAX_N), n


def _route_recorder(monkeypatch, record):
    """Force the GPU backend and stub the kernel and XLA entry points with
    recorders that return correctly-shaped zeros."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")

    def fake_kernel(key, Q_shared, h_extra, num_reads, *a, **kw):
        record.append("kernel")
        G, B, n = h_extra.shape
        return jnp.zeros((G, B, num_reads, n), jnp.float32)

    def fake_xla(key, Q, num_reads, *a, **kw):
        record.append("xla")
        return jnp.zeros((Q.shape[0], num_reads, Q.shape[-1]), jnp.float32)

    # routing is shape-only: skip the real densify (it jit-compiles a new
    # vmapped diagflat per distinct shape)
    monkeypatch.setattr(api, "densify_groups", lambda Q, h: jnp.zeros(
        (h.shape[0] * h.shape[1], Q.shape[-1], Q.shape[-1]), jnp.float32))
    monkeypatch.setattr(ak, "anneal_groups", fake_kernel)
    monkeypatch.setattr(sa_jax, "sa_sample_batch", fake_xla)
    monkeypatch.setattr(gibbs, "gibbs_sample_batch", fake_xla)


@pytest.mark.parametrize("make_sampler", [
    lambda: SASampler(num_sweeps=4),
    lambda: GibbsSampler(num_warmup=4),
], ids=["SASampler", "GibbsSampler"])
class TestRouteMatchesRule:
    def test_executed_route_equals_rule(self, monkeypatch, make_sampler):
        record = []
        _route_recorder(monkeypatch, record)
        sampler = make_sampler()
        seen = set()
        checked = 0
        for n, B, R, G in _tuples(2000, seed=7):
            if checked >= 40:
                break
            if n > 128 or B * G > 1400 or R > 256:
                continue  # keep stub arrays small; the rule only reads n
            record.clear()
            out = api.sampler_sample_groups(
                sampler, jax.random.key(0), jnp.zeros((G, n, n)),
                jnp.zeros((G, B, n)), R)
            assert out.shape == (G, B, R, n)
            assert record == ["kernel" if n <= ak.MAX_N else "xla"], (
                n, B, R, G, record)
            seen.add(record[0])
            checked += 1
        assert checked >= 40 and seen == {"kernel", "xla"}

    def test_every_route_scans(self, monkeypatch, make_sampler):
        """The epoch-launch contract: whichever route a shape takes, the
        sampler declares it scan-safe at that exact shape."""
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        sampler = make_sampler()
        for n, B, R, G in _tuples(200, seed=8):
            assert api.sampler_scan_safe_groups(sampler, n, B, R, groups=G)
            assert api.sampler_scan_safe(sampler, n, R)


class TestDensifyFallback:
    def test_dense_fallback_shapes(self):
        """Samplers without a structured path (PT, EXACT) get the densified
        (G·B, n, n) batch and return (G, B, R, n)."""
        calls = []

        class Spy:
            def sample_batch(self, key, Q, num_reads):
                calls.append(Q.shape)
                return jnp.zeros((Q.shape[0], num_reads, Q.shape[-1]))

        for n, B, R, G in _tuples(20, seed=9):
            if n > 64 or B * G > 600:
                continue
            out = api.sampler_sample_groups(Spy(), jax.random.key(0),
                                            jnp.zeros((G, n, n)),
                                            jnp.zeros((G, B, n)), 4)
            assert out.shape == (G, B, 4, n)
            assert calls[-1] == (G * B, n, n)
        assert calls

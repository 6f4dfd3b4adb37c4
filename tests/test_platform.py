"""Device plumbing: compile-cache placement, the native sampler's jit
capability, the GPU-only measurement entry points, and matmul precision
in the DQBM field builders."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


class TestCompileCache:
    def test_env_var_wins(self, monkeypatch, tmp_path):
        from qbmx.cli import _common

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert _common.compile_cache_dir() == str(tmp_path)

    def test_default_is_repo_dot_compile_cache(self, monkeypatch):
        from qbmx.cli import _common

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert _common.compile_cache_dir() == str(REPO / ".compile_cache")
        assert ".compile_cache/" in (REPO / ".gitignore").read_text().split()

    def test_enable_sets_jax_config(self, monkeypatch, tmp_path):
        from qbmx.cli import _common

        old = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        try:
            assert _common.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        finally:
            jax.config.update("jax_compilation_cache_dir", old)


class TestNativeJitSafe:
    def test_jit_safe_everywhere(self):
        from qbmx.models.dqbm import DiscQBM
        from qbmx.samplers.api import get_sampler, sampler_jit_safe

        s = get_sampler("SA-NATIVE", num_sweeps=4)
        assert s.jit_safe is True and sampler_jit_safe(s)
        m = DiscQBM(dim_input=3, n_hidden_nodes=2, seed=0, sample_count=8,
                    sampler=s)
        assert m.supports_whole_epoch_jit()

    def test_traced_call_runs_through_callback(self):
        from qbmx.samplers.native import NativeSASampler, native_available

        if not native_available():
            pytest.skip("no C++ compiler for the native sampler")
        s = NativeSASampler(num_sweeps=8)
        Q = jnp.asarray(np.triu(np.random.default_rng(0).uniform(-1, 1, (2, 4, 4))),
                        jnp.float32)
        keys = jax.random.split(jax.random.key(0), 2)
        out = jax.jit(lambda k, q: s.sample_batch(k, q, 16))(keys, Q)
        eager = s.sample_batch(keys, Q, 16)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(eager))


class TestGpuOnlyEntryPoints:
    def test_bench_refuses_cpu(self):
        sys.path.insert(0, str(REPO))
        import bench

        with pytest.raises(RuntimeError, match="GPU"):
            bench.gpu_device()

    def test_chip_smoke_fails_without_gpu(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                           capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout and "no GPU" in r.stderr

    def test_chip_smoke_fails_alone(self, tmp_path):
        """Outside a checkout of the repository the script cannot import
        the program and must fail without a result line."""
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode != 0 and '"ok"' not in r.stdout


class TestFieldPrecision:
    BUILDERS = ["clamped_qubo", "unclamped_qubo", "clamped_fields",
                "unclamped_fields"]

    def _inputs(self):
        from qbmx.models.dqbm import init_params

        params = init_params(jax.random.key(0), 784, 5, 1, False)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.uniform(0, 1, (784,)), jnp.float32)
        y = jnp.asarray([1.0], jnp.float32)
        return params, x, y

    def _call(self, name, params, x, y):
        from qbmx.models import dqbm

        fn = getattr(dqbm, name)
        if name == "clamped_qubo":
            return fn(params, x, y, 1.0)
        if name == "clamped_fields":
            return fn(params, x[None], y[None], 1.0)
        if name == "unclamped_fields":
            return fn(params, x[None], 1.0)
        return fn(params, x, 1.0)

    @pytest.mark.parametrize("name", BUILDERS)
    def test_builders_pin_highest_precision(self, name):
        """Every input-by-weight product asks for full float32: on a GPU
        the default would be TF32."""
        params, x, y = self._inputs()
        jaxpr = jax.make_jaxpr(lambda p, a, b: self._call(name, p, a, b))(
            params, x, y)
        dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
        assert dots, name
        for e in dots:
            assert "HIGHEST" in str(e.params["precision"]), (name, e.params)

    @pytest.mark.parametrize("name", BUILDERS)
    def test_builders_match_float64(self, name):
        """784-input fields against a float64 product: TF32 (about 1e-3
        relative) would miss this tolerance by two orders of magnitude."""
        params, x, y = self._inputs()
        got = np.asarray(self._call(name, params, x, y), np.float64)
        p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        x64 = np.asarray(x, np.float64)
        v64 = np.concatenate([np.asarray(y, np.float64), x64])
        n_out = p64.b_o.shape[0]
        if name in ("clamped_qubo", "clamped_fields"):
            want = v64 @ p64.w_vh
            got = np.diagonal(got) - p64.b_h if name == "clamped_qubo" else got[0]
        else:
            want = np.concatenate([x64 @ p64.w_vo, x64 @ p64.w_vh[n_out:]])
            if name == "unclamped_qubo":
                got = np.diagonal(got) - np.concatenate([p64.b_o, p64.b_h])
            else:
                got = got[0]
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)

"""ctypes bridge to the native C++ SA sampler (``native/sa_sampler.cpp``).

The shared library is compiled on first use with g++ (no pip/pybind
dependency) and cached next to the source; set ``QBMX_NATIVE_CC`` to point
at a different compiler.  Exposed as the ``"SA-NATIVE"`` solver — the
host-CPU counterpart of the on-device samplers, playing the role dwave-neal
played for the reference (a fast local backend that works with no
accelerator attached, ``src/qubo/sampler.py:19-33``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import jax
import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "sa_sampler.cpp"
_LIB = _REPO_ROOT / "native" / "_qbmx_sa.so"

_lock = threading.Lock()
_lib = None


def _build() -> Path:
    cc = os.environ.get("QBMX_NATIVE_CC", "g++")
    cmd = [
        cc, "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", str(_SRC), "-o", str(_LIB),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return _LIB


def load_library():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_LIB))
        lib.qbmx_sa_sample_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.qbmx_sa_sample_batch.restype = None
        lib.qbmx_sa_sample_batch_seeds.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.qbmx_sa_sample_batch_seeds.restype = None
        lib.qbmx_sa_default_beta_range.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.qbmx_sa_default_beta_range.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    try:
        load_library()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def sa_sample_batch_native(seed: int, Q: np.ndarray, num_reads: int, num_sweeps: int) -> np.ndarray:
    """(B, n, n) float32 QUBOs → (B, num_reads, n) float32 samples."""
    lib = load_library()
    Q = np.ascontiguousarray(np.asarray(Q), dtype=np.float32)
    B, n = Q.shape[0], Q.shape[-1]
    out = np.empty((B, num_reads, n), dtype=np.float32)
    lib.qbmx_sa_sample_batch(
        Q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        B, n, num_reads, num_sweeps, ctypes.c_uint64(seed & (2**64 - 1)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def _combine_seed_words(kd: np.ndarray) -> np.ndarray:
    """(B, words) uint32 PRNG-key data → (B,) uint64 chain-seed bases (the
    per-problem entries for ``qbmx_sa_sample_batch_seeds``)."""
    kd = np.asarray(kd, dtype=np.uint64)
    if kd.ndim != 2:
        raise ValueError(f"expected (B, words) key data, got {kd.shape}")
    if kd.shape[-1] == 1:
        return np.ascontiguousarray(kd[:, 0])
    return np.ascontiguousarray((kd[:, 0] << np.uint64(32)) | kd[:, -1])


def sa_sample_batch_native_seeds(seeds: np.ndarray, Q: np.ndarray,
                                 num_reads: int, num_sweeps: int) -> np.ndarray:
    """Per-problem-seed variant: ``seeds`` (B,) uint64, one chain-seed base
    per problem — problem b's samples depend on ``seeds[b]`` alone (true
    per-problem stream reproducibility; see the C++ twin
    ``qbmx_sa_sample_batch_seeds``)."""
    lib = load_library()
    Q = np.ascontiguousarray(np.asarray(Q), dtype=np.float32)
    B, n = Q.shape[0], Q.shape[-1]
    seeds = np.ascontiguousarray(np.asarray(seeds), dtype=np.uint64)
    if seeds.shape != (B,):
        raise ValueError(f"seeds must be ({B},) uint64, got {seeds.shape}")
    out = np.empty((B, num_reads, n), dtype=np.float32)
    lib.qbmx_sa_sample_batch_seeds(
        Q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        B, n, num_reads, num_sweeps,
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


class NativeSASampler:
    """Sampler-protocol wrapper.  Host-side: the QUBO batch is pulled to the
    host, annealed in C++ threads, and the samples pushed back — usable from
    eager code and (via pure_callback) inside jitted steps."""

    def __init__(self, num_sweeps: int = 1000):
        self.num_sweeps = int(num_sweeps)

    #: Inside jit the host call runs through ``jax.pure_callback``, which the
    #: CPU and GPU runtimes both support.
    jit_safe = True

    def sample_batch(self, key, Q, num_reads: int):
        import jax.numpy as jnp

        B, n = Q.shape[0], Q.shape[-1]
        out_shape = jax.ShapeDtypeStruct((B, num_reads, n), jnp.float32)

        if key.ndim:
            # Per-problem (B,) key arrays (the protocol everywhere else, and
            # what sampler_sample_groups' densify fallback forwards): the
            # C++ seeds entry gives TRUE per-problem streams — problem b's
            # samples depend on key[b] alone.
            kd = jax.random.key_data(key.reshape(-1))  # (B, words) uint32

            if not isinstance(jnp.asarray(Q), jax.core.Tracer) and not isinstance(
                kd, jax.core.Tracer
            ):
                out = sa_sample_batch_native_seeds(
                    _combine_seed_words(np.asarray(kd)), np.asarray(Q),
                    num_reads, self.num_sweeps)
                return jnp.asarray(out)

            def host_fn_seeds(kd_np, Q_np):
                return sa_sample_batch_native_seeds(
                    _combine_seed_words(kd_np), Q_np, num_reads, self.num_sweeps)

            return jax.pure_callback(host_fn_seeds, out_shape, kd, Q,
                                     vmap_method="sequential")

        seed_arr = jax.random.randint(
            key, (), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)

        if not isinstance(jnp.asarray(Q), jax.core.Tracer) and not isinstance(
            seed_arr, jax.core.Tracer
        ):
            # Eager path: concrete arrays → run directly on the host.
            out = sa_sample_batch_native(
                int(seed_arr), np.asarray(Q), num_reads, self.num_sweeps
            )
            return jnp.asarray(out)

        def host_fn(seed_np, Q_np):
            return sa_sample_batch_native(int(seed_np), Q_np, num_reads, self.num_sweeps)

        return jax.pure_callback(host_fn, out_shape, seed_arr, Q, vmap_method="sequential")

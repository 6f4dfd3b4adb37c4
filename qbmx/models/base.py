"""Abstract model base — the qbmx counterpart of the reference ``MODEL`` abc
(``src/model/model_ab.py``): common checkpoint/predict protocol shared by
the QBM families.  Parameters live in jax pytrees and randomness in explicit
PRNG keys (the reference seeds global numpy instead)."""

from __future__ import annotations

import abc
import pickle
from pathlib import Path

import numpy as np


def save_weight_pickle(objs: list, title: str, path: str = "out") -> None:
    """Write a reference-format weight list pickle (``<path>/<title>.pkl``)
    — the one save path shared by every model family and the sweeps'
    best-epoch capture (reference ``MODEL.save_weights``,
    ``src/model/model_ab.py:33-35``)."""
    Path(path).mkdir(parents=True, exist_ok=True)
    with open(f"{path}/{title}.pkl", "wb") as f:
        pickle.dump(objs, f)


def load_weight_pickle(file_path, missing_msg: str = "params file not found"):
    """Read a weight-list pickle, raising ``FileNotFoundError(missing_msg)``
    when absent — shared by ``load_params``/``load_savepoint`` across the
    model families (each rebuilds its own params pytree from the list)."""
    file_path = Path(file_path)
    if not file_path.exists():
        raise FileNotFoundError(missing_msg)
    with open(file_path, "rb") as f:
        return pickle.load(f)


def pad_rows(x, total: int):
    """Zero-pad axis 0 of a device array up to ``total`` rows — for the
    ragged TAIL chunk of chunked prediction/embedding loops (a second
    jitted program per tail size would pay another compile;
    static-shapes invariant, CLAUDE.md).  Callers slice the padding back
    off the output."""
    import jax.numpy as jnp

    if x.shape[0] == total:
        return x
    return jnp.concatenate(
        [x, jnp.zeros((total - x.shape[0],) + x.shape[1:], x.dtype)]
    )


def clip_by_global_norm(tree, max_norm: float):
    """Scale a gradient pytree so its global L2 norm is at most ``max_norm``.

    Flag-gated stability extension (OFF by default everywhere = reference
    parity): sampled moment-matching gradients occasionally spike when the
    annealer lands in a rare configuration, and a fraction of seeds then
    flatline at the majority-class prediction (the reference shows the same
    pathology in its AUC spread, e.g. the 0.6243±0.1289 band of
    ``out/paper_data/QuCUN_Breast``).  Standard global-norm clipping bounds
    the step without changing its direction."""
    import jax
    import jax.numpy as jnp

    leaves = jax.tree.leaves(tree)
    gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(l)) for l in leaves))
    scale = jnp.minimum(1.0, max_norm / jnp.maximum(gnorm, 1e-12))
    return jax.tree.map(lambda l: l * scale, tree)


class QBMModel(abc.ABC):
    """Protocol every qbmx model family satisfies (DiscQBM, CDQBM, and the
    RBM wrapper follow the same surface; see each class)."""

    @abc.abstractmethod
    def weight_objects(self) -> list:
        """Reference-format weight list for pickle checkpoints."""

    @abc.abstractmethod
    def train_for_one_iteration(self, x_batch, y_batch, learning_rate, mask=None):
        """One masked moment-matching update; returns (err, nll)."""

    @abc.abstractmethod
    def predict_batch(self, X):
        """(predictions, class_probs) for a batch of inputs."""

    def save_weights(self, title: str, path: str = "out"):
        save_weight_pickle(self.weight_objects(), title, path)

    def predict(self, data):
        preds, _ = self.predict_batch(np.asarray(data)[None])
        return int(preds[0])

    def get_num_params(self):
        """Total trainable parameter count (reference ``get_num_params``,
        ``src/ClassificationRBM.py:297-307``)."""
        import jax

        return sum(int(np.prod(np.asarray(p).shape)) for p in jax.tree.leaves(self.params))


class EpochLaunchMixin:
    """Whole-epoch device launches for models with a jitted ``_step``.

    An epoch dispatches as ONE computation (lax.scan over batches) when the
    sampler tolerates scan (every built-in jit-safe sampler does), or as
    unrolled segments of ``EPOCH_UNROLL_SEGMENT`` jitted steps for a
    sampler that declines it.  Either way the per-batch host round trips of
    the reference-style loop disappear, and the padded+batched dataset
    stays resident on device across epochs (re-uploading it each epoch
    costs more than the epoch's compute).

    Requirements on the host class: ``_step(params, x, y, mask, lr, key)``
    jitted, ``params``, ``key``, ``sampler``, ``sample_count``, and
    ``_qubo_n()`` (unclamped QUBO side, for the sampler's capability check).
    """

    EPOCH_UNROLL_SEGMENT = 16

    def _qubo_n(self) -> int:  # pragma: no cover - overridden
        raise NotImplementedError

    def _sampler_call_groups(self) -> int:
        """Hook: how many shared-coupling GROUPS the training step's
        structured sampler call carries (2 = clamped+unclamped phases)."""
        return 2

    def _prepare_inputs(self, x: np.ndarray) -> np.ndarray:
        """Hook: reshape host inputs to the step's expected layout."""
        return x

    # -- device-copy caches ----------------------------------------------
    # Keyed by WEAK references to the original host objects: id() alone can
    # be recycled by a new same-length array after the old one is freed,
    # silently serving stale device data.  A dead referent fails the
    # identity check, so recycled ids can never hit.

    def _cache_lookup(self, attr: str, objs: tuple, extra):
        entry = getattr(self, attr, None)
        if entry is None:
            return None
        refs, stored_extra, value = entry
        if stored_extra != extra or len(refs) != len(objs):
            return None
        for ref, obj in zip(refs, objs):
            if ref() is not obj:
                return None
        return value

    def _cache_store(self, attr: str, objs: tuple, extra, value):
        import weakref

        try:
            refs = tuple(weakref.ref(o) for o in objs)
        except TypeError:
            return  # unreferenceable host object: skip caching
        setattr(self, attr, (refs, extra, value))

    def _cached_device_input(self, X):
        """Device copy of a repeatedly-used input set (e.g. per-epoch
        validation), cached by identity of the host object."""
        import jax.numpy as jnp

        x = self._cache_lookup("_predict_data", (X,), None)
        if x is None:
            x = jnp.asarray(self._prepare_inputs(np.asarray(X, dtype="float32")))
            self._cache_store("_predict_data", (X,), None, x)
        return x

    def supports_epoch_scan(self, batch_size: int | None = None) -> bool:
        """lax.scan over batches — declined by the sampler itself when it
        cannot live inside scan or cannot be traced at all (capability
        flags in qbmx.samplers.api).  With ``batch_size`` the decision uses
        the EXACT structured-call shapes the training step makes — group
        count from ``_sampler_call_groups()`` (2 phase groups normally; 1
        when a model's step samples only one phase, e.g. the DQBM linear
        shortcut) × batch problems.  Mesh-sharded models
        (``qbmx.parallel.mesh.shard_model``) probe the PER-SHARD shapes
        their step's local sampler call makes — batch ``B / dp`` problems
        at ``sample_count / chains`` reads."""
        from qbmx.samplers.api import (
            sampler_scan_safe,
            sampler_scan_safe_groups,
        )

        mesh = getattr(self, "mesh", None)
        dp = mesh.shape["dp"] if mesh is not None else 1
        chains = mesh.shape["chains"] if mesh is not None else 1
        reads = max(self.sample_count // chains, 1)
        if batch_size is not None:
            return sampler_scan_safe_groups(
                self.sampler, self._qubo_n(), max(int(batch_size) // dp, 1),
                reads, groups=self._sampler_call_groups(),
            )
        return sampler_scan_safe(self.sampler, self._qubo_n(), reads)

    def supports_whole_epoch_jit(self) -> bool:
        """Broader than scan support: jit-safe samplers that can't scan
        are unrolled; host-bound samplers (QPU adapter) stay on the eager
        per-batch path."""
        from qbmx.samplers.api import sampler_jit_safe

        return sampler_jit_safe(self.sampler)

    def _build_epoch_scan(self):
        import jax
        import jax.numpy as jnp  # noqa: F401

        inner = self._step

        @jax.jit
        def epoch(params, xb, yb, maskb, lr, key):
            def body(carry, xs):
                params, key = carry
                key, k = jax.random.split(key)
                x, y, m = xs
                params, nll, err = inner(params, x, y, m, lr, k)
                return (params, key), (nll, err)

            (params, key), (nlls, errs) = jax.lax.scan(body, (params, key), (xb, yb, maskb))
            return params, nlls, errs

        return epoch

    def _build_epoch_unrolled(self, nb: int):
        import jax
        import jax.numpy as jnp

        inner = self._step

        @jax.jit
        def epoch(params, xb, yb, maskb, lr, key):
            nlls, errs = [], []
            for i in range(nb):  # static unroll
                key, k = jax.random.split(key)
                params, nll, err = inner(params, xb[i], yb[i], maskb[i], lr, k)
                nlls.append(nll)
                errs.append(err)
            return params, jnp.stack(nlls), jnp.stack(errs)

        return epoch

    def train_epoch(self, x, y, batch_size, learning_rate):
        """One epoch of whole-batch device launches; the ragged tail batch
        is zero-padded and masked.  Returns per-batch (nll, err) arrays.
        Callers must not mutate ``x``/``y`` in place between epochs (the
        device copy is cached by array identity)."""
        import jax
        import jax.numpy as jnp

        cached = self._cache_lookup("_epoch_data", (x, y), batch_size)
        if cached is not None:
            xb, yb, maskb, nb = cached
        else:
            xh = self._prepare_inputs(np.asarray(x, dtype="float32"))
            yh = np.asarray(y)
            n = len(xh)
            nb = -(-n // batch_size)
            pad = nb * batch_size - n
            mask = np.concatenate([np.ones(n, "float32"), np.zeros(pad, "float32")])
            xp = np.concatenate([xh, np.zeros((pad,) + xh.shape[1:], xh.dtype)]) if pad else xh
            yp = np.concatenate([yh, np.zeros((pad,) + yh.shape[1:], yh.dtype)]) if pad else yh
            xb = jnp.asarray(xp.reshape((nb, batch_size) + xh.shape[1:]))
            yb = jnp.asarray(yp.reshape(nb, batch_size))
            maskb = jnp.asarray(mask.reshape(nb, batch_size))
            self._cache_store("_epoch_data", (x, y), batch_size, (xb, yb, maskb, nb))

        if self.supports_epoch_scan(batch_size):
            if not hasattr(self, "_epoch_scan_fn"):
                self._epoch_scan_fn = self._build_epoch_scan()
            self.key, k = jax.random.split(self.key)
            self.params, nlls, errs = self._epoch_scan_fn(
                self.params, xb, yb, maskb, learning_rate, k
            )
            return np.asarray(nlls), np.asarray(errs)

        # unrolled-segment fallback (sampler declines scan): ceil(nb/K) launches
        if not hasattr(self, "_epoch_unrolled"):
            self._epoch_unrolled = {}
        K = self.EPOCH_UNROLL_SEGMENT
        nlls_l, errs_l = [], []
        for s in range(0, nb, K):
            seg = min(K, nb - s)
            if seg not in self._epoch_unrolled:
                self._epoch_unrolled[seg] = self._build_epoch_unrolled(seg)
            self.key, k = jax.random.split(self.key)
            self.params, nl, er = self._epoch_unrolled[seg](
                self.params, xb[s : s + seg], yb[s : s + seg],
                maskb[s : s + seg], learning_rate, k,
            )
            nlls_l.append(nl)
            errs_l.append(er)
        return (
            np.concatenate([np.asarray(v) for v in nlls_l]),
            np.concatenate([np.asarray(v) for v in errs_l]),
        )

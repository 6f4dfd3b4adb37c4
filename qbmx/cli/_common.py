"""Shared CLI helpers: dataset resolution and flag plumbing."""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import jax
import numpy as np

from qbmx.data import loaders


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when it is set, else ``<repo>/.compile_cache``
    (listed in ``.gitignore``)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        Path(__file__).resolve().parents[2] / ".compile_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    (sweep CLIs spawn one process per seed and would otherwise recompile
    every program).  Shared with ``bench.py`` and ``chip_smoke.py`` so the
    knobs cannot drift.  Returns the directory."""
    cache_dir = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


enable_compile_cache()


def str2bool(v) -> bool:
    """Proper boolean flag parsing (the reference's ``type=bool`` treats any
    non-empty string as True, SURVEY.md §2c.8)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def load_dataset(data_set: str, seed: int = 42, samples_per_class=None,
                 num_classes: int = 2):
    """Resolve a dataset by the reference CLI vocabulary
    (``qbm_main.py:33-49``): mnist / breastmnist / pneumoniamnist /
    fashionmnist / synthetic.  Returns (train, val, test) tuples of
    (images NxHxW, labels N).  ``num_classes`` selects the first N classes
    for the class-filterable datasets (the reference hardcoded [0, 1]).
    ``samples_per_class`` subsamples BOTH the train and test splits —
    evaluation runs on a subsampled test set, mirroring the reference's
    hardcoded 50-train / 20-test subsamples (``cdqbm_main.py:38-43``)."""
    classes = list(range(num_classes))
    if data_set == "mnist":
        # Reference tree ships only the t10k images (train blob missing);
        # split test 80/10/10 when train images are unavailable.
        try:
            train = loaders.get_mnist(
                "mnist/train-images-idx3-ubyte.gz", "mnist/train-labels-idx1-ubyte.gz",
                classes=classes, samples_per_class=samples_per_class, seed=seed)
            test = loaders.get_mnist(
                "mnist/t10k-images-idx3-ubyte.gz", "mnist/t10k-labels-idx1-ubyte.gz",
                classes=classes, samples_per_class=samples_per_class, seed=seed)
            return train, (None, None), test
        except FileNotFoundError:
            x, y = loaders.get_mnist(
                "mnist/t10k-images-idx3-ubyte.gz", "mnist/t10k-labels-idx1-ubyte.gz",
                classes=classes, samples_per_class=samples_per_class, seed=seed)
            # per-class subsampling concatenates classes in order — shuffle
            # before splitting or the tail split is single-class
            x, y = loaders.shuffle_images(x, y, seed)
            n = len(x)
            a, b = int(0.8 * n), int(0.9 * n)
            return (x[:a], y[:a]), (x[a:b], y[a:b]), (x[b:], y[b:])
    if data_set in ("breastmnist", "pneumoniamnist"):
        return loaders.get_medmnist(f"medmnist/{data_set}.npz", seed=seed)
    if data_set == "fashionmnist":
        # subdir-hinted paths: MNIST and FashionMNIST share bare filenames
        train = loaders.get_fashionmnist(
            "fashionmnist/train-images-idx3-ubyte", "fashionmnist/train-labels-idx1-ubyte",
            classes=classes, samples_per_class=samples_per_class, seed=seed)
        test = loaders.get_fashionmnist(
            "fashionmnist/t10k-images-idx3-ubyte", "fashionmnist/t10k-labels-idx1-ubyte",
            classes=classes, samples_per_class=samples_per_class, seed=seed)
        return train, (None, None), test
    if data_set == "cifar-10":
        train = loaders.get_cifar10(classes=classes if num_classes != 2 else [3, 5],
                                    samples_per_class=samples_per_class or 200,
                                    seed=seed, train=True)
        test = loaders.get_cifar10(classes=classes if num_classes != 2 else [3, 5],
                                   samples_per_class=50, seed=seed, train=False)
        return train, (None, None), test
    if data_set == "synthetic":
        x, y = loaders.synthetic_images(800, num_classes=num_classes, seed=seed)
        return (x[:600], y[:600]), (x[600:700], y[600:700]), (x[700:], y[700:])
    raise ValueError(
        f"Invalid dataset {data_set!r}. Options: mnist, breastmnist, "
        "pneumoniamnist, fashionmnist, cifar-10, synthetic"
    )


def qpu_sampler_kwargs(qpu_copies=1, qpu_embedding="first_party",
                       embedding_cache=""):
    """Collect the QPU-seam flags into the ``sampler_kwargs`` dict models
    thread to the registry; ``None`` when every flag is at its default (so
    on-device solver paths stay byte-identical to earlier rounds)."""
    kw = {}
    if qpu_copies > 1:
        kw["copies"] = qpu_copies
    if qpu_embedding != "first_party":
        kw["embedding"] = qpu_embedding
    if embedding_cache:
        kw["cache_dir"] = embedding_cache
    return kw or None


def param_string(**kw) -> str:
    """Run-identity filename encoding (reference ``qbm_main.py:57-58``)."""
    return "".join(f"_{k}{v}" for k, v in kw.items())


def finish_seed_sweep(sweep, seeds, hists, save, name):
    """Shared tail of every ``--seed_sweep`` CLI path: per-seed best-epoch
    summary, reference-style per-seed acc/auc pickles
    (``src/model/faster_dqbm.py:1161-1166``), best-epoch weight pickles
    under ``best_model/`` (``:1069-1077``), and the mean±std print.
    Returns ``(accs, aucs)`` — one best-epoch value per seed."""
    import pickle
    from pathlib import Path

    from qbmx.train.loop import get_best_combined_acc_auc

    accs, aucs = [], []
    for s, h in zip(seeds, hists):
        _, acc, auc, _ = get_best_combined_acc_auc(h)
        accs.append(acc)
        aucs.append(auc)
        if save:
            out = Path(save)
            out.mkdir(parents=True, exist_ok=True)
            with open(out / f"{name}acc_per_epoch{s}.pkl", "wb") as f:
                pickle.dump(h.acc_per_epoch, f)
            with open(out / f"{name}auc_per_epoch{s}.pkl", "wb") as f:
                pickle.dump(h.auc_per_epoch, f)
        print(f"seed {s}: best acc {acc:.4f} auc {auc:.4f}")
    if save:
        paths = sweep.save_best_models(
            save, name_fn=lambda s_, e_: f"{name}_se{s_}_e{e_}_best")
        print(f"best-epoch checkpoints: {len(paths)} pickles under "
              f"{Path(save) / 'best_model'}")
    print(f"MEAN acc {np.mean(accs):.4f}±{np.std(accs):.4f} "
          f"auc {np.mean(aucs):.4f}±{np.std(aucs):.4f}")
    return accs, aucs

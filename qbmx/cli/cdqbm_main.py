"""Conv-Deep-QBM CLI — flag-parity entry point for the reference
``cdqbm_main.py`` (argparse ``cdqbm_main.py:160-244``) with proper boolean
flags and headless metrics output (figures optional)."""

from __future__ import annotations

import argparse
import os
import random

import numpy as np

from qbmx.cli._common import (load_dataset, param_string, qpu_sampler_kwargs,
                              str2bool)
from qbmx.data import loaders
from qbmx.models.cdqbm import CDQBM
from qbmx.train.loop import train_model
from qbmx.utils import metrics


def main(
    seed=44, solver="SA", sample_count=100, anneal=1000, beta_eff=1.0, epochs=20,
    batch_size=3, learning_rate=0.01, restricted=False, data_set="mnist",
    num_classes=2, save="out/", name="run", pooling_size=4,
    pooling_type="deterministic", hidden_bias_type="shared", one_hot=False,
    sequential_layer_sizes=(4,), kernel_size=3, stride=1, n_kernels=1,
    coreset_budget=0,
    samples_per_class=50, pool_select="min", center_fmap=False,
    signed_input=False, prob_penalty=0.8225, grad_clip=0.0, progress=False,
    seed_sweep=None, reinit_on_collapse=0, learn_penalty=False,
    checkpoint_every=0, resume="", qpu_copies=1,
    qpu_embedding="first_party", embedding_cache="",
):
    if seed_sweep and (resume or checkpoint_every):
        # same guard as rbm_main: silently ignoring these would lose
        # checkpoints / retrain from scratch while the user believes the
        # flags took effect
        raise ValueError("--resume/--checkpoint_every need the "
                         "single-model path (omit --seed_sweep)")
    print("Start")
    random.seed(seed)
    np.random.seed(seed)
    print("Seed is", seed)

    print("Loading data...")
    (train_x, train_y), _, (test_x, test_y) = load_dataset(
        data_set, seed=seed, num_classes=num_classes,
        samples_per_class=samples_per_class if data_set in ("mnist", "fashionmnist") else None,
    )
    print("Data loaded")

    train_x, train_y = loaders.shuffle_images(train_x, train_y, seed)

    if signed_input:
        # flag-gated extension (PARITY.md §4): remap inputs to {-1, +1}
        train_x = np.asarray(train_x, dtype=np.float32) * 2.0 - 1.0
        test_x = np.asarray(test_x, dtype=np.float32) * 2.0 - 1.0

    image_shape = np.asarray(train_x[0]).shape[:2]
    num_label_nodes = 1 if (num_classes == 2 and not one_hot) else int(num_classes)
    class_names = ["0", "1"] if num_label_nodes == 1 else [str(i) for i in range(num_classes)]

    pstr = param_string(
        se=seed, sol=solver, sc=sample_count, b=beta_eff, e=epochs,
        bs=batch_size, l=learning_rate, r=restricted, data=data_set, n_=name,
    )
    print(pstr)

    print("Creating QBM...")
    qbm = CDQBM(
        image_shape=tuple(image_shape), num_label_nodes=num_label_nodes,
        seed=seed, kernel_size=kernel_size, n_kernels=n_kernels,
        pooling_size=pooling_size,
        pooling_type=pooling_type, stride=stride,
        sequential_layer_sizes=list(sequential_layer_sizes),
        is_restricted=bool(restricted), hidden_bias_type=hidden_bias_type,
        solver=solver, anneal=anneal, sample_count=sample_count,
        beta_eff=beta_eff, num_classes=num_classes,
        pool_select=pool_select, center_fmap=center_fmap,
        prob_penalty=prob_penalty, grad_clip=grad_clip,
        learn_penalty=bool(learn_penalty),
        sampler_kwargs=qpu_sampler_kwargs(qpu_copies, qpu_embedding,
                                          embedding_cache),
    )
    print(f"QBM created (hidden={qbm.geo.n_hidden}, total={qbm.geo.n_total})")

    if reinit_on_collapse and not seed_sweep:
        raise ValueError(
            "--reinit_on_collapse requires --seed_sweep here: the "
            "single-model cdqbm path has no per-epoch validation for the "
            "collapse check (qbm_main wires it for single models)")
    if seed_sweep:
        if coreset_budget:
            raise ValueError("--seed_sweep does not compose with "
                             "--coreset_budget (the coreset depends on one "
                             "model's embedding)")
        return _seed_sweep(qbm, seed_sweep, train_x, train_y, test_x, test_y,
                           epochs, batch_size, learning_rate, save, name,
                           class_names, reinit_on_collapse)

    if coreset_budget:
        from qbmx.data.coreset import downsample_kcenter_with_light_model

        print(f"Selecting {coreset_budget}-example coreset...")
        train_x, train_y = downsample_kcenter_with_light_model(
            qbm, train_x, train_y, coreset_budget, seed
        )

    # full-state resume (VERDICT r3 Missing #3; see qbm_main)
    start_epoch, prev_history = 0, None
    if resume:
        from qbmx.utils.checkpoint import load_checkpoint

        prev_history, start_epoch = load_checkpoint(resume, qbm)
        print(f"Resumed full state from {resume} "
              f"(completed epochs: {start_epoch})")
    if checkpoint_every and not save:
        # checkpoints land under the run folder; with no --save there is
        # nowhere to write them and the flag would silently no-op
        raise ValueError("--checkpoint_every needs --save")
    ckpt_path = f"{save}{pstr}/state" if save and checkpoint_every else None

    print("Training QBM...")
    history = train_model(
        qbm, train_x, train_y, batch_size=batch_size,
        learning_rate=learning_rate, epochs=epochs,
        save_folder=f"{save}{pstr}" if save else None,
        class_titles=class_names, progress=progress, history=prev_history,
        checkpoint_every=checkpoint_every, checkpoint_path=ckpt_path,
        start_epoch=start_epoch,
    )
    print("QBM trained")

    print("Predict on test data...")
    predictions, probs_all = qbm.predict_batch(test_x)

    acc, f1, precision, recall, _ = metrics.get_metrics(test_y, predictions, class_names)
    if num_classes == 2:
        # binary AUC from the positive-class score
        auc = metrics.binary_auc(test_y, probs_all[:, 1])
    else:
        auc = metrics.ovr_auc(test_y, probs_all)

    if save:
        metrics.save_result(
            save + name, qbm, history, qbm.weight_objects(), test_y, predictions,
            class_names, batch_size, epochs, solver, learning_rate, save=True,
        )

    print("Accuracy: ", acc)
    print("F1 Score: ", f1)
    print("Precision: ", precision)
    print("Recall: ", recall)
    print("AUC Score: ", auc)
    return acc, f1, precision, recall, auc


def _seed_sweep(qbm, seeds, train_x, train_y, test_x, test_y, epochs,
                batch_size, learning_rate, save, name, class_names,
                reinit_on_collapse=0):
    """All seeds as one batched device sweep (``SeedParallelCDQBM``); per-
    epoch test metrics per seed, reference-style per-seed pickles (the
    shared tail lives in ``_common.finish_seed_sweep``)."""
    from qbmx.cli._common import finish_seed_sweep
    from qbmx.train.sweep import SeedParallelCDQBM

    sweep = SeedParallelCDQBM(seeds, qbm)
    hists = sweep.train(train_x, train_y, test_x, test_y, epochs=epochs,
                        batch_size=batch_size, learning_rate=learning_rate,
                        class_titles=class_names, verbose=True,
                        reinit_on_collapse=reinit_on_collapse)
    return finish_seed_sweep(sweep, seeds, hists, save, name)


def build_parser():
    p = argparse.ArgumentParser(description="Run Conv-Deep-QBM experiments.")
    p.add_argument("-lr", "--learning_rate", type=float, default=0.01)
    p.add_argument("-r", "--restricted", type=str2bool, default=False)
    p.add_argument("-e", "--epochs", type=int, default=20)
    p.add_argument("-b", "--batch_size", type=int, default=3)
    p.add_argument("-s", "--seed", type=int, default=44)
    p.add_argument("-sc", "--sample_count", type=int, default=100)
    p.add_argument("--anneal", type=int, default=1000,
                   help="Num sweeps for SA")
    p.add_argument("--solver", type=str, default="SA")
    p.add_argument("--data_set", type=str, default="mnist")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--save", "--out", dest="save", type=str, default="out/")
    p.add_argument("--name", type=str, default="run")
    p.add_argument("--pooling_size", type=int, default=4,
                   help="Pooling window size (0/1 disables)")
    p.add_argument("--pooling_type", type=str, default="deterministic",
                   help="'probabilistic' or 'deterministic'")
    p.add_argument("--hidden_bias_type", type=str, default="shared",
                   help="'shared', 'none', or 'per-unit'")
    p.add_argument("--one_hot", action="store_true")
    p.add_argument("--parallelize", type=str2bool, default=False,
                   help="Kept for flag parity with the reference CLI "
                        "(cdqbm_main.py:212, process-pool chain fan-out / "
                        "parallel-QA selection); chains always run batched "
                        "on device here, and the QPU parallel-QA role is "
                        "--qpu_copies")
    p.add_argument("--kernel_size", type=int, default=3)
    p.add_argument("--n_kernels", type=int, default=1,
                   help="conv channels (flag-gated capacity extension; the "
                        "reference has ONE shared kernel, "
                        "src/model/cdqbm.py:289-381 — 1 = parity)")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--seq_sizes", type=int, nargs="*", default=[4])
    p.add_argument("--coreset_budget", type=int, default=0,
                   help="k-center coreset size (0 = use all training data)")
    p.add_argument("--progress", action="store_true",
                   help="tqdm bar over per-batch loops (eager path only)")
    p.add_argument("--beta_eff", type=float, default=1.0,
                   help="effective inverse temperature divisor (the reference "
                        "hardcodes 1.0; raise it to soften saturated conv units)")
    p.add_argument("--samples_per_class", type=int, default=50,
                   help="per-class subsample for mnist/fashionmnist, applied "
                        "to BOTH splits — metrics are on a subsampled test "
                        "set, like the reference's hardcoded 50 train / "
                        "20 test (cdqbm_main.py:38-43)")
    p.add_argument("--pool_select", type=str, default="min",
                   choices=["min", "max", "absmax"],
                   help="deterministic-pooling unit choice; 'min' is reference "
                        "parity, 'absmax' lifts the pooling ceiling "
                        "(PARITY.md §4 exact study)")
    p.add_argument("--center_fmap", type=str2bool, default=False,
                   help="zero-mean the conv feature map per image (flag-gated "
                        "extension)")
    p.add_argument("--signed_input", type=str2bool, default=False,
                   help="remap inputs to {-1,+1} before training")
    p.add_argument("--prob_penalty", type=float, default=0.8225,
                   help="probabilistic-pooling penalty strength (reference "
                        "hardcodes 0.8225)")
    p.add_argument("--learn_penalty", type=str2bool, default=False,
                   help="learn a per-window probabilistic-pooling penalty "
                        "vector (init at --prob_penalty) by moment matching "
                        "instead of the reference's fixed constant "
                        "(flag-gated extension; needs probabilistic pooling)")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="max gradient global L2 norm (0 = off, reference "
                        "parity; flag-gated stability extension)")
    p.add_argument("--reinit_on_collapse", type=int, default=0,
                   help="seed-sweep only: after N epochs, re-draw the "
                        "params of seeds stuck at the majority-class "
                        "prediction (flag-gated; the flatline mode is an "
                        "init-basin property, PARITY.md §4)")
    p.add_argument("--seed_sweep", type=int, nargs="+", default=None,
                   help="train ALL listed seeds as one batched device sweep "
                        "(qbmx.train.sweep.SeedParallelCDQBM); -s still "
                        "seeds the data subsample/shuffle")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="every N epochs write a full-state npz (params + "
                        "PRNG + history) under the run folder; resume with "
                        "--resume for a bit-identical continuation")
    p.add_argument("--resume", type=str, default="",
                   help="full-state npz from --checkpoint_every to resume "
                        "from (single-model path only)")
    p.add_argument("--qpu_copies", type=int, default=1,
                   help="QPU solvers only: pack this many QUBO replicas per "
                        "anneal (the reference's parallel-QA trick, "
                        "src/model/cdqbm.py:794-815); ignored by on-device "
                        "solvers")
    p.add_argument("--qpu_embedding", choices=["first_party", "composite"],
                   default="first_party",
                   help="QPU solvers only: 'first_party' runs qbmx's own "
                        "cached, partition-aware embedding pipeline "
                        "(qbmx.embedding); 'composite' delegates to Ocean's "
                        "EmbeddingComposite")
    p.add_argument("--embedding_cache", type=str, default="",
                   help="QPU solvers only: directory for persisted embedding "
                        "pickles (the reference's src/embeddings/* cache)")
    return p


if __name__ == "__main__":
    flags = build_parser().parse_args()
    print("Running with solver", flags.solver)
    if flags.save:
        os.makedirs(flags.save, exist_ok=True)
    main(
        seed=flags.seed, solver=flags.solver, sample_count=flags.sample_count,
        anneal=flags.anneal, beta_eff=flags.beta_eff, epochs=flags.epochs,
        batch_size=flags.batch_size, learning_rate=flags.learning_rate,
        restricted=flags.restricted, data_set=flags.data_set,
        num_classes=flags.num_classes, save=flags.save, name=flags.name,
        pooling_size=flags.pooling_size, pooling_type=flags.pooling_type,
        hidden_bias_type=flags.hidden_bias_type, one_hot=flags.one_hot,
        sequential_layer_sizes=flags.seq_sizes, kernel_size=flags.kernel_size,
        n_kernels=flags.n_kernels,
        stride=flags.stride, coreset_budget=flags.coreset_budget,
        samples_per_class=flags.samples_per_class,
        pool_select=flags.pool_select, center_fmap=flags.center_fmap,
        signed_input=flags.signed_input, prob_penalty=flags.prob_penalty,
        grad_clip=flags.grad_clip, progress=flags.progress,
        seed_sweep=flags.seed_sweep, reinit_on_collapse=flags.reinit_on_collapse,
        learn_penalty=flags.learn_penalty,
        checkpoint_every=flags.checkpoint_every, resume=flags.resume,
        qpu_copies=flags.qpu_copies, qpu_embedding=flags.qpu_embedding,
        embedding_cache=flags.embedding_cache,
    )

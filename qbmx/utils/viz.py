"""Architecture visualization for the CDQBM stack.

Parity with the reference's ``visualize_architecture``
(``src/model/cdqbm.py:1662-1723``): a schematic of input → conv units →
pooling → sequential layers → output nodes with unit counts, rendered with
matplotlib (Agg backend; returns the figure, optionally saves)."""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def visualize_architecture(model, save_path: str | None = None):
    geo = model.geo
    layers = [
        ("input", f"{geo.image_shape[0]}×{geo.image_shape[1]}",
         geo.image_shape[0] * geo.image_shape[1]),
        ("conv", f"{geo.conv_dim[0]}×{geo.conv_dim[1]} (k={geo.kernel_size}, "
         f"s={geo.stride}"
         + (f", C={geo.n_kernels}" if geo.n_kernels > 1 else "") + ")",
         geo.conv_units_total),
    ]
    if geo.has_pooling:
        layers.append((f"pool ({geo.pooling_type})",
                       f"{geo.n_windows} windows of {geo.pooling_size}²",
                       geo.n_pooled))
    for i, s in enumerate(geo.seq_sizes):
        layers.append((f"seq {i}", "dense", s))
    layers.append(("output", "label nodes", geo.n_out))

    fig, ax = plt.subplots(figsize=(2 + 1.6 * len(layers), 4))
    max_units = max(c for _, _, c in layers)
    for i, (name, desc, count) in enumerate(layers):
        height = 0.2 + 2.6 * np.sqrt(count / max_units)
        ax.add_patch(plt.Rectangle((i * 1.6, -height / 2), 1.0, height,
                                   facecolor="#7aa6c2", edgecolor="black"))
        ax.text(i * 1.6 + 0.5, height / 2 + 0.25, name, ha="center", fontsize=9,
                weight="bold")
        ax.text(i * 1.6 + 0.5, -height / 2 - 0.3, f"{count}\n{desc}", ha="center",
                fontsize=7, va="top")
        if i:
            ax.annotate("", xy=(i * 1.6, 0), xytext=((i - 1) * 1.6 + 1.0, 0),
                        arrowprops=dict(arrowstyle="->"))
    ax.set_xlim(-0.5, len(layers) * 1.6)
    ax.set_ylim(-2.6, 2.6)
    ax.axis("off")
    ax.set_title(
        f"CDQBM: {geo.n_hidden} hidden + {geo.n_out} output QUBO variables"
    )
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    return fig

"""Matplotlib wrappers over analysis.stats (port of ``analysis/plots.py``;
``matplotlib`` is an optional dependency, imported at the first plot)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .stats import codeword_histogram, exponent_histogram, fp16_bit_sparsity


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_codeword_histogram(qt, save_path: str, title: Optional[str] = None):
    plt = _plt()
    values, counts = codeword_histogram(qt)
    fig, ax = plt.subplots(figsize=(8, 3.5))
    ax.bar(range(len(values)), counts,
           tick_label=[f"{v:.3g}" for v in values])
    ax.set_xlabel("codeword value")
    ax.set_ylabel("count")
    ax.set_title(title or f"{qt.spec.fmt}{qt.spec.storage_bits} codeword histogram")
    ax.tick_params(axis="x", rotation=45)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


def plot_exponent_histogram(qt, save_path: str):
    plt = _plt()
    fields, counts = exponent_histogram(qt)
    fig, ax = plt.subplots(figsize=(6, 3))
    ax.bar(fields, counts)
    ax.set_xlabel("exponent field")
    ax.set_ylabel("count")
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


def plot_bit_sparsity(data: np.ndarray, save_path: str):
    plt = _plt()
    out = fp16_bit_sparsity(data)
    zc = out["zero_counts"]
    fig, ax = plt.subplots(figsize=(8, 3.5))
    ax.bar(range(len(zc) - 1, -1, -1), zc)
    ax.set_xlabel("aligned mantissa bit (MSB left)")
    ax.set_ylabel("zero count")
    ax.set_title("fp16 aligned mantissa bit sparsity")
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path

"""Dataset loaders (the port's own copy of ``data/loaders.py``), after the
reference's ``gptq/datautils.py``.

Kept for PPL parity:

* a local ``load_from_disk`` first (the ``LOCAL_PPL_DATASET_DIR``
  environment variable), the HF hub after it (datautils.py:14-24);
* the slow tokenizer (``use_fast=False``), ``"\\n\\n".join`` for wikitext2
  and ptb, ``" ".join`` for the *-new variants;
* seeded random calibration windows with the same ``random.randint``
  draws; c4 validation = 256 random seqlen windows, seed 0, hstacked.

Token arrays are numpy.  ``synthetic`` gives deterministic random tokens
for offline runs, bit-equal to the JAX package's for the same seed.  The
real datasets need ``datasets`` and ``transformers``, imported only when
asked for; ``tokenshard:<path>`` reads a pre-tokenized raw int32 file
through the host library's memory-mapped reader (``native/``).
"""

from __future__ import annotations

import importlib
import os
import random
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

LOCAL_DIR_ENV = "LOCAL_PPL_DATASET_DIR"


@dataclass
class TokenizedText:
    input_ids: np.ndarray  # [1, T] int64


@dataclass
class CalibSample:
    input_ids: np.ndarray  # [1, S]


def _need(module: str, dataset: str):
    """Import ``module`` for ``dataset``, or raise saying what is missing."""
    try:
        return importlib.import_module(module)
    except ImportError as err:
        raise ImportError(
            f"dataset {dataset!r} needs the '{module}' package, which is not "
            f"installed; use 'synthetic' for offline runs") from err


def _local_dataset(name: str):
    base = os.environ.get(LOCAL_DIR_ENV)
    if not base:
        return None
    path = Path(base) / name
    if not path.exists():
        return None
    try:
        return _need("datasets", name).load_from_disk(str(path))
    except Exception as err:  # an unreadable local copy: fall back to the hub
        print(f"warning: failed to load local dataset {name}: {err}")
        return None


def _split(ds, name: str):
    if ds is None:
        return None
    try:
        return ds[name]
    except Exception:
        return getattr(ds, name, None)


def _tokenizer(model_path: str):
    transformers = _need("transformers", "tokenizer")
    return transformers.AutoTokenizer.from_pretrained(model_path, use_fast=False)


def _windows(token_ids: np.ndarray, nsamples: int, seed: int,
             seqlen: int) -> List[CalibSample]:
    rng = random.Random(seed)
    out = []
    for _ in range(nsamples):
        i = rng.randint(0, token_ids.shape[1] - seqlen - 1)
        out.append(CalibSample(token_ids[:, i : i + seqlen]))
    return out


def _encode(tokenizer, text: str) -> np.ndarray:
    ids = tokenizer(text, return_tensors="np").input_ids
    return ids.astype(np.int64)


def get_wikitext2(nsamples, seed, seqlen, model):
    ds = _local_dataset("wikitext")
    train, test = _split(ds, "train"), _split(ds, "test")
    if train is None or test is None:
        load_dataset = _need("datasets", "wikitext2").load_dataset
        train = load_dataset("wikitext", "wikitext-2-raw-v1", split="train")
        test = load_dataset("wikitext", "wikitext-2-raw-v1", split="test")
    tok = _tokenizer(model)
    trainenc = _encode(tok, "\n\n".join(train["text"]))
    testenc = _encode(tok, "\n\n".join(test["text"]))
    return _windows(trainenc, nsamples, seed, seqlen), TokenizedText(testenc)


def get_ptb(nsamples, seed, seqlen, model, new: bool = False):
    ds = _local_dataset("ptb")
    train = _split(ds, "train")
    val = _split(ds, "test" if new else "validation") or _split(ds, "valid")
    if train is None or val is None:
        load_dataset = _need("datasets", "ptb").load_dataset
        train = load_dataset("ptb_text_only", "penn_treebank", split="train")
        val = load_dataset("ptb_text_only", "penn_treebank",
                           split="test" if new else "validation")
    tok = _tokenizer(model)
    joiner = " " if new else "\n\n"
    trainenc = _encode(tok, joiner.join(train["sentence"]))
    testenc = _encode(tok, joiner.join(val["sentence"]))
    return _windows(trainenc, nsamples, seed, seqlen), TokenizedText(testenc)


def get_c4(nsamples, seed, seqlen, model, new: bool = False):
    ds = _local_dataset("c4")
    train, val = _split(ds, "train"), _split(ds, "validation")
    if train is None and val is None:
        load_dataset = _need("datasets", "c4").load_dataset
        train = load_dataset(
            "allenai/c4", "allenai--c4",
            data_files={"train": "en/c4-train.00000-of-01024.json.gz"}, split="train")
        val = load_dataset(
            "allenai/c4", "allenai--c4",
            data_files={"validation": "en/c4-validation.00000-of-00008.json.gz"},
            split="validation")
    tok = _tokenizer(model)

    if new:
        rng = random.Random(seed)
        samples = []
        for _ in range(nsamples):
            while True:
                i = rng.randint(0, len(train) - 1)
                enc = _encode(tok, train[i]["text"])
                if enc.shape[1] >= seqlen:
                    break
            i = rng.randint(0, enc.shape[1] - seqlen - 1)
            samples.append(CalibSample(enc[:, i : i + seqlen]))
        valenc = _encode(tok, " ".join(val[:1100]["text"]))[:, : 256 * seqlen]
        return samples, TokenizedText(valenc)

    # classic c4: no calibration windows (the training split is too large
    # to scan); validation = 256 random windows, seed 0 (datautils.py:120-131)
    rng = random.Random(0)
    windows = []
    for _ in range(256):
        while True:
            i = rng.randint(0, len(val) - 1)
            enc = _encode(tok, val[i]["text"])
            if enc.shape[1] >= seqlen:
                break
        i = rng.randint(0, enc.shape[1] - seqlen - 1)
        windows.append(enc[:, i : i + seqlen])
    return None, TokenizedText(np.hstack(windows))


def get_synthetic(nsamples, seed, seqlen, model=None, vocab_size: int = 256):
    """Deterministic random tokens, the offline stand-in: a test split of
    ``8 * seqlen`` tokens and calibration windows from ``16 * seqlen``."""
    rng = np.random.default_rng(seed)
    test = rng.integers(0, vocab_size, size=(1, seqlen * 8), dtype=np.int64)
    train = rng.integers(0, vocab_size, size=(1, seqlen * 16), dtype=np.int64)
    return _windows(train, nsamples, seed, seqlen), TokenizedText(test)


def get_tokenshard(path: str, nsamples, seed, seqlen):
    """Pre-tokenized raw-int32 shard (memory-mapped via the host library's
    reader, ``csrc/host/iwoq_native.cpp``): seeded random calibration
    windows + the first ``256 * seqlen`` tokens (or all) as the test
    split, as in the JAX package."""
    from .. import native

    with native.TokenShardReader(path) as reader:
        total = len(reader)
        if total < seqlen + 1:
            raise ValueError(f"token shard {path} shorter than seqlen")
        rng = random.Random(seed)
        offs = [rng.randint(0, total - seqlen - 1) for _ in range(nsamples)]
        batch = reader.batch(offs, seqlen)
        samples = [CalibSample(batch[i : i + 1].astype(np.int64))
                   for i in range(nsamples)]
        n_test = min(total, 256 * seqlen)
        test = reader.batch([0], n_test).astype(np.int64)
    return samples, TokenizedText(test)


def get_loaders(
    name: str,
    nsamples: int = 128,
    seed: int = 0,
    seqlen: int = 2048,
    model: str = "",
    vocab_size: int = 256,
) -> Tuple[Optional[List[CalibSample]], TokenizedText]:
    """The reference's ``datautils.get_loaders`` dispatch (lines 205-217),
    with ``synthetic`` (offline random tokens) and ``tokenshard:<path>``
    (a pre-tokenized corpus, memory-mapped) beside it."""
    if name.startswith("tokenshard:"):
        return get_tokenshard(name.split(":", 1)[1], nsamples, seed, seqlen)
    if "synthetic" in name:
        return get_synthetic(nsamples, seed, seqlen, model, vocab_size)
    if "wikitext2" in name or name == "wikitext":
        return get_wikitext2(nsamples, seed, seqlen, model)
    if "ptb" in name:
        return get_ptb(nsamples, seed, seqlen, model, new="new" in name)
    if "c4" in name:
        return get_c4(nsamples, seed, seqlen, model, new="new" in name)
    raise ValueError(f"unknown dataset {name!r}")

"""Port parity: the dataset loaders and the sequential perplexity evaluator.

* ``get_synthetic`` and ``get_loaders("synthetic")`` give the JAX
  package's arrays bit for bit (calibration windows and test split); the
  real datasets raise a clear ImportError without ``datasets``, and
  ``tokenshard:`` names the unported host library.
* ``SequentialPPLEvaluator`` on a tiny LLaMA, dense and W4-quantized, in
  float32: perplexity within rel 1e-5 of the JAX evaluator's, token and
  chunk counts equal, also with ``max_chunks`` (a partial batch) and the
  same error for a dataset shorter than ``seqlen``.
"""

import sys

import numpy as np
import pytest
import torch

import jax

from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.data import loaders as j_loaders
from iron_weight_only_quant_tpu.evals import ppl as j_ppl
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.quantize.model_pass import quantize_model_params as j_qmp
from iron_weight_only_quant_tpu_torch.data import loaders as t_loaders
from iron_weight_only_quant_tpu_torch.evals import ppl as t_ppl
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor

J_CFG = j_llama.LlamaConfig.tiny()
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
SEQLEN = 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """kind -> (JAX params, port params): the tiny LLaMA dense and W4 g32."""
    dense = j_llama.llama_init(J_CFG, jax.random.PRNGKey(7))
    w4, _ = j_qmp(dense, JSpec(fmt="int", bits=4, group_size=32, symmetric=False))
    return {k: (p, params_from_numpy(_np_tree(p), "cpu"))
            for k, p in (("dense", dense), ("w4", w4))}


@pytest.mark.parametrize("nsamples,seed,seqlen,vocab", [
    (4, 0, 32, 256), (16, 3, 512, 32000), (1, 11, 7, 50)])
def test_synthetic_loader_bit_equal(nsamples, seed, seqlen, vocab):
    for name in ("synthetic", "synthetic-anything"):
        jtr, jte = j_loaders.get_loaders(name, nsamples=nsamples, seed=seed, seqlen=seqlen,
                                         vocab_size=vocab)
        ttr, tte = t_loaders.get_loaders(name, nsamples=nsamples, seed=seed, seqlen=seqlen,
                                         vocab_size=vocab)
        assert len(ttr) == len(jtr) == nsamples
        for a, b in zip(ttr, jtr):
            assert a.input_ids.dtype == b.input_ids.dtype
            np.testing.assert_array_equal(a.input_ids, b.input_ids)
        assert tte.input_ids.dtype == jte.input_ids.dtype
        np.testing.assert_array_equal(tte.input_ids, jte.input_ids)
    assert t_ppl.DATASET_MAP == j_ppl.DATASET_MAP


@pytest.mark.parametrize("name", ["wikitext2", "ptb", "c4", "ptb-new", "c4-new"])
def test_real_datasets_need_their_packages(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "datasets", None)  # import now raises
    monkeypatch.delenv(t_loaders.LOCAL_DIR_ENV, raising=False)
    with pytest.raises(ImportError, match="'datasets' package"):
        t_loaders.get_loaders(name, nsamples=1, seqlen=8, model="m")


def test_other_dataset_names():
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        t_loaders.get_loaders("tokenshard:/nowhere.bin")
    with pytest.raises(ValueError, match="unknown dataset"):
        t_loaders.get_loaders("imagenet")


@pytest.mark.parametrize("kind", ["dense", "w4"])
@pytest.mark.parametrize("max_chunks", [None, 3])
def test_ppl_matches_jax(models, kind, max_chunks):
    jp, tp = models[kind]
    if kind == "w4":
        assert isinstance(tp["layers"][0]["q"]["w"], QuantizedTensor)
    jev = j_ppl.SequentialPPLEvaluator(jp, j_llama.llama_forward, J_CFG, seqlen=SEQLEN)
    tev = t_ppl.SequentialPPLEvaluator(tp, t_llama.llama_forward, T_CFG, seqlen=SEQLEN)
    want = jev.calculate_ppl("synthetic", max_chunks=max_chunks)
    got = tev.calculate_ppl("synthetic", max_chunks=max_chunks)
    n_chunks = max_chunks or 8  # the synthetic test split is 8 * seqlen tokens
    assert got[1:] == want[1:] == (n_chunks * (SEQLEN - 1), n_chunks)
    assert got[0] == pytest.approx(want[0], rel=1e-5)


def test_ppl_short_dataset_raises_as_jax(models):
    jp, tp = models["dense"]
    short = np.arange(SEQLEN - 1, dtype=np.int64)[None]
    errs = []
    for mod, p, fwd, cfg in ((j_ppl, jp, j_llama.llama_forward, J_CFG),
                             (t_ppl, tp, t_llama.llama_forward, T_CFG)):
        ev = mod.SequentialPPLEvaluator(p, fwd, cfg, seqlen=SEQLEN)
        ev._token_cache["wikitext2"] = short
        with pytest.raises(ValueError) as e:
            ev.calculate_ppl("wikitext")
        errs.append(str(e.value))
    assert errs[0] == errs[1]

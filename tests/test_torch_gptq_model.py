"""Port parity: the calibration seam, whole-model GPTQ and smoothing.

Tiny random LLaMA (norms folded and not), OPT and BLOOM models are built
once by the JAX package and carried to the port as numpy; the calibration
samples come from both packages' ``synthetic`` loader (bit-equal).

* ``recording_linears``: the port's seam records the same linears, in the
  same order, with the same inputs as the JAX seam (the normalized input
  where a folded norm runs as ``pre_norm``); never a stacked linear.
* ``quantize_model_gptq`` (LLaMA, OPT, BLOOM; packed and fake-quant; with
  and without ``true_sequential``; the TrueOBS solver): layer 0's codes at
  least 99% equal to the JAX package's, synthetic perplexity within rel
  2e-3 of JAX's (GPTQ is chaotic in the last bits, ROADMAP C4; sample order
  alone moves PPL by 5.3e-4, ``NOTES.md``), and the output error below
  RTN's, as ``tests/test_gptq_model.py`` holds; the ``observer`` hears of
  every block's phases and every linear's solve.
* ``smooth_model`` gives the JAX package's params and keeps the function.
* The refusals raise as in the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import GPTQConfig as JGPTQConfig
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.config import fp_spec as j_fp_spec
from iron_weight_only_quant_tpu.data import get_loaders as j_get_loaders
from iron_weight_only_quant_tpu.evals.ppl import SequentialPPLEvaluator as JPPL
from iron_weight_only_quant_tpu.models import bloom as j_bloom
from iron_weight_only_quant_tpu.models import common as j_common
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.models import opt as j_opt
from iron_weight_only_quant_tpu.quantize import gptq_model as j_gm
from iron_weight_only_quant_tpu.quantize import smooth as j_smooth
from iron_weight_only_quant_tpu_torch.config import GPTQConfig, QuantSpec, fp_spec
from iron_weight_only_quant_tpu_torch.data import get_loaders
from iron_weight_only_quant_tpu_torch.evals import SequentialPPLEvaluator
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import bloom as t_bloom
from iron_weight_only_quant_tpu_torch.models import common as t_common
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.models import opt as t_opt
from iron_weight_only_quant_tpu_torch.ops.packing import unpack_codes
from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor
from iron_weight_only_quant_tpu_torch.quantize import gptq_model as t_gm
from iron_weight_only_quant_tpu_torch.quantize import smooth as t_smooth
from iron_weight_only_quant_tpu_torch.quantize.model_pass import quantize_model_params

SEQLEN = 32
NSAMPLES = 4
# name -> (family, JAX module, port module, JAX config)
MODELS = {
    "llama": ("llama", j_llama, t_llama, j_llama.LlamaConfig.tiny()),
    "opt": ("opt", j_opt, t_opt, j_opt.OPTConfig.tiny()),
    "bloom": ("bloom", j_bloom, t_bloom, j_bloom.BloomConfig.tiny()),
}
W4 = dict(fmt="int", bits=4, group_size=32, symmetric=False)
W3_PC = dict(fmt="int", bits=3, group_size=-2, symmetric=False)
# (model, folded norms, spec, GPTQConfig fields, pack, true_sequential); the
# two cases of a family share their solver settings, so the JAX package
# compiles its solves once a family
GPTQ_CASES = {
    "llama_packed": ("llama", False, W4, {}, True, False),
    "llama_folded_fake_seq": ("llama", True, W4, {}, False, True),
    "opt_packed_act_order_seq": ("opt", False, W3_PC, dict(act_order=True), True, True),
    "opt_fake_act_order": ("opt", False, W3_PC, dict(act_order=True), False, False),
    "bloom_trueobs_packed": ("bloom", False, W3_PC, dict(solver="trueobs"), True, False),
    "bloom_trueobs_sparseout_seq": ("bloom", False, W3_PC,
                                    dict(solver="trueobs", sparseout=True), True, True),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t_cfg(name):
    _, jmod, tmod, jcfg = MODELS[name]
    cls = type(jcfg).__name__
    return getattr(tmod, cls)(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """name -> (JAX dense params, port dense params), with non-trivial
    norms and biases, built on first use."""
    return {}


def _pair(models, name, folded=False):
    key = (name, folded)
    if key not in models:
        family, jmod, _, jcfg = MODELS[name]
        p = getattr(jmod, f"{family}_init")(jcfg, jax.random.PRNGKey(5))
        rng = np.random.default_rng(6)

        def perturb(node):
            if isinstance(node, dict):
                return {k: perturb(v) for k, v in node.items()}
            if isinstance(node, list):
                return [perturb(v) for v in node]
            if getattr(node, "ndim", 0) == 1:
                return node + jnp.asarray(0.1 * rng.normal(size=node.shape), node.dtype)
            return node

        p = perturb(p)
        if folded:
            p = j_llama.fold_llama_norms(p)
        models[key] = (p, params_from_numpy(_np_tree(p), "cpu"))
    return models[key]


def _forwards(name):
    family, jmod, tmod, _ = MODELS[name]
    return getattr(jmod, f"{family}_forward"), getattr(tmod, f"{family}_forward")


@pytest.fixture(scope="module")
def calib():
    """The calibration windows of both packages' synthetic loader."""
    jtrain, _ = j_get_loaders("synthetic", nsamples=NSAMPLES, seed=0, seqlen=SEQLEN)
    ttrain, _ = get_loaders("synthetic", nsamples=NSAMPLES, seed=0, seqlen=SEQLEN)
    for a, b in zip(jtrain, ttrain, strict=True):
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
    return [s.input_ids for s in ttrain]


def _annotated(jp, tp):
    return ({**jp, "layers": [j_smooth._annotate_with_layer(b, i)
                              for i, b in enumerate(jp["layers"])]},
            {**tp, "layers": [t_smooth._annotate_with_layer(b, i)
                              for i, b in enumerate(tp["layers"])]})


@pytest.mark.parametrize("name,folded", [("llama", False), ("llama", True), ("opt", False),
                                         ("bloom", False)])
def test_recording_linears_matches_jax(models, calib, name, folded):
    jp, tp = _annotated(*_pair(models, name, folded))
    jfwd, tfwd = _forwards(name)
    jrec, trec = [], []
    with j_common.recording_linears(lambda n, x: jrec.append((n, np.asarray(x)))):
        jfwd(jp, jnp.asarray(calib[0], jnp.int32), MODELS[name][3])
    with t_common.recording_linears(lambda n, x: trec.append((n, x.numpy()))):
        tfwd(tp, torch.from_numpy(calib[0]), _t_cfg(name))
    assert [n for n, _ in trec] == [n for n, _ in jrec]
    assert len(trec) == 7 * 2 if name == "llama" else 6 * 2
    for (n, a), (_, b) in zip(trec, jrec):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-5, err_msg=n)
    if folded:  # q's recorded input is the normalized one: x / rms(x)
        x = trec[0][1].reshape(-1, trec[0][1].shape[-1])
        rms = np.sqrt((x**2).mean(-1))
        assert (rms > 0.9).all() and (rms <= 1.0 + 1e-6).all()


def test_recording_skips_stacked_linears(models, calib):
    stacked = t_common.stack_model_layers(_pair(models, "llama")[1])
    layers = stacked["layers_stacked"]
    for k, v in layers.items():
        if isinstance(v, dict) and getattr(v.get("w"), "ndim", 0) == 3:
            layers[k] = {**v, "name": k}
    rec = []
    with t_common.recording_linears(lambda n, x: rec.append(n)):
        t_llama.llama_forward_scan(stacked, torch.from_numpy(calib[0]), _t_cfg("llama"))
    assert rec == []


def _layer0_codes(lin):
    """Layer-0 codes (packed) or dense weights (fake-quant) as numpy."""
    w = lin["w"]
    if isinstance(w, QuantizedTensor) or hasattr(w, "qweight"):
        return unpack_codes(torch.from_numpy(np.array(w.qweight)), w.spec.bits,
                            w.shape[0]).numpy()
    return np.asarray(w.detach().numpy() if torch.is_tensor(w) else w)


def _out_err(logits, ref):
    a, b = np.asarray(logits, np.float32), np.asarray(ref, np.float32)
    return float(np.mean((a - b) ** 2))


@pytest.mark.parametrize("case", [c for c in GPTQ_CASES if c.startswith("llama")])
def test_quantize_model_gptq_matches_jax(models, calib, case):
    check_gptq_case(models, calib, case)


def check_gptq_case(models, calib, case):
    """One case of ``GPTQ_CASES`` against the JAX package (also run by
    ``tests/test_torch_gptq_opt_bloom.py``)."""
    name, folded, spec, gfields, pack, seq = GPTQ_CASES[case]
    family = MODELS[name][0]
    jp, tp = _pair(models, name, folded)
    jcfg, tcfg = MODELS[name][3], _t_cfg(name)
    kw = dict(nsamples=NSAMPLES, blocksize=32, **gfields)
    jq = j_gm.quantize_model_gptq(jp, jcfg, family, calib, JSpec(**spec), JGPTQConfig(**kw),
                                  pack=pack, progress=None, true_sequential=seq)
    heard = []
    tq = t_gm.quantize_model_gptq(
        tp, tcfg, family, calib, QuantSpec(**spec), GPTQConfig(**kw), pack=pack,
        progress=None, true_sequential=seq,
        observer=lambda li, phase, secs, info: heard.append((li, phase, secs, info)))

    n_lin = 7 if family == "llama" else 6
    n_stages = 4 if seq else 1
    for li in range(2):
        phases = [p for b, p, _, _ in heard if b == li]
        assert phases.count("hessian") == n_stages and phases.count("solve") == n_lin
        assert phases[-1] == "forward" and phases.count("forward") == 1
    assert all(secs >= 0 for _, _, secs, _ in heard)
    solved = [(li, i["name"], i["h"].shape, tuple(i["w"].shape))
              for li, p, _, i in heard if p == "solve"]
    assert len(solved) == 2 * n_lin and all(h == (w[0], w[0]) for _, _, h, w in solved)
    if seq:
        assert [n for li, n, _, _ in solved if li == 0][:3] == ["k", "v", "q"]

    packed = pack and not (gfields.get("act_order") and spec["group_size"] > 0) \
        and not gfields.get("sparseout")
    for key, lin in tq["layers"][0].items():
        if not (isinstance(lin, dict) and "w" in lin and lin["w"] is not None
                and (isinstance(lin["w"], QuantizedTensor) or lin["w"].dim() == 2)):
            continue
        assert isinstance(lin["w"], QuantizedTensor) == packed, key
        got, want = _layer0_codes(lin), _layer0_codes(jq["layers"][0][key])
        if packed:
            frac = (got == want).mean()
        else:
            frac = np.isclose(got, want, rtol=1e-5, atol=1e-7).mean()
        assert frac >= 0.99, (key, frac)
    assert "lm_head" not in tq or not isinstance(tq["lm_head"]["w"], QuantizedTensor)

    jfwd, tfwd = _forwards(name)
    ppl_j = JPPL(jq, jfwd, jcfg, seqlen=SEQLEN).calculate_ppl("synthetic")
    ppl_t = SequentialPPLEvaluator(tq, tfwd, tcfg, seqlen=SEQLEN).calculate_ppl("synthetic")
    assert ppl_t[1:] == ppl_j[1:]
    assert ppl_t[0] == pytest.approx(ppl_j[0], rel=2e-3)

    toks = torch.from_numpy(np.concatenate(calib, axis=0))
    with torch.no_grad():
        ref = tfwd(tp, toks, tcfg)[0]
        rtn, _ = quantize_model_params(tp, QuantSpec(**spec), device="cpu")
        err_rtn = _out_err(tfwd(rtn, toks, tcfg)[0], ref)
        err_gptq = _out_err(tfwd(tq, toks, tcfg)[0], ref)
    assert err_gptq < err_rtn, (err_gptq, err_rtn)


def test_gptq_refusals_match_jax(models, calib):
    jp, tp = _pair(models, "llama")
    jcfg, tcfg = MODELS["llama"][3], _t_cfg("llama")

    for jspec, tspec, gkw in [
            (j_fp_spec("fp4", 2, 1, group_size=32), fp_spec("fp4", 2, 1, group_size=32), {}),
            (JSpec(**W4), QuantSpec(**W4), dict(solver="trueobs"))]:
        with pytest.raises(NotImplementedError) as je:
            j_gm.quantize_model_gptq(jp, jcfg, "llama", calib, jspec,
                                     JGPTQConfig(nsamples=1, **gkw), progress=None)
        with pytest.raises(NotImplementedError) as te:
            t_gm.quantize_model_gptq(tp, tcfg, "llama", calib, tspec,
                                     GPTQConfig(nsamples=1, **gkw), progress=None)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name,alpha", [("llama", 0.5), ("opt", 0.8)])
def test_smooth_model_matches_jax(models, calib, name, alpha):
    family = MODELS[name][0]
    jp, tp = _pair(models, name)
    jfwd, tfwd = _forwards(name)
    js = j_smooth.smooth_model(jp, MODELS[name][3], family, jfwd, calib[:3], alpha=alpha)
    ts = t_smooth.smooth_model(tp, _t_cfg(name), family, tfwd, calib[:3], alpha=alpha)

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in t for x in leaves(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]

    for a, b in zip(leaves(ts), leaves(js), strict=True):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    toks = torch.from_numpy(calib[0])
    with torch.no_grad():
        np.testing.assert_allclose(tfwd(ts, toks, _t_cfg(name))[0].numpy(),
                                   tfwd(tp, toks, _t_cfg(name))[0].numpy(),
                                   rtol=2e-4, atol=2e-4)

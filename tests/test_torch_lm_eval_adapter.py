"""Port parity: the lm-evaluation-harness adapter, through the same stub
``lm_eval`` module as ``tests/test_lm_eval_adapter.py`` (the real package
is optional and absent here).

The port's adapter over the port's ``EvalLM`` and the JAX adapter over
the JAX ``EvalLM``, both on the same deterministic toy model (logits favour
``token + 1``), answer the same requests alike: loglikelihoods within 1e-5
and equal greedy flags, rolling sums within 1e-5, equal generated text;
without ``lm_eval`` both raise the same ImportError.
"""

import dataclasses
import sys
import types

import pytest
import torch

import jax.numpy as jnp

from iron_weight_only_quant_tpu.evals import lm_eval_adapter as j_adapter
from iron_weight_only_quant_tpu.evals.lm import EvalLM as JEvalLM
from iron_weight_only_quant_tpu_torch.evals import lm_eval_adapter as t_adapter
from iron_weight_only_quant_tpu_torch.evals.lm import EvalLM as TEvalLM

VOCAB = 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def stub_lm_eval(monkeypatch):
    """Install a minimal lm_eval.api.model.LM base class."""
    api_model = types.ModuleType("lm_eval.api.model")

    class LM:
        def __init__(self):
            pass

    api_model.LM = LM
    api = types.ModuleType("lm_eval.api")
    api.model = api_model
    pkg = types.ModuleType("lm_eval")
    pkg.api = api
    monkeypatch.setitem(sys.modules, "lm_eval", pkg)
    monkeypatch.setitem(sys.modules, "lm_eval.api", api)
    monkeypatch.setitem(sys.modules, "lm_eval.api.model", api_model)
    return pkg


class Req:
    def __init__(self, *args):
        self.args = args


def _word_encode(s):
    return [sum(map(ord, w)) % (VOCAB - 2) + 2 for w in s.split()] or [1]


def _decode(toks):
    return " ".join(f"t{t}" for t in toks)


@dataclasses.dataclass(frozen=True)
class Cfg:
    max_position_embeddings: int = 64


def _j_forward(params, tokens, cfg):
    return jnp.eye(VOCAB)[(tokens + 1) % VOCAB] * 5.0, None


def _t_forward(params, tokens, cfg):
    return torch.eye(VOCAB)[(tokens + 1) % VOCAB] * 5.0, None


@pytest.fixture()
def models(stub_lm_eval):
    """(port adapter, JAX adapter) over the toy model, EOT id 3."""
    t_lm = TEvalLM({"embed": torch.zeros(1)}, _t_forward, Cfg(), batch_size=2,
                   eot_token_id=3)
    j_lm = JEvalLM(None, _j_forward, Cfg(), batch_size=2, eot_token_id=3)
    return (t_adapter.make_lm_eval_model(t_lm, _word_encode, _decode, eot_token="<e>"),
            j_adapter.make_lm_eval_model(j_lm, _word_encode, _decode, eot_token="<e>"))


def test_import_error_without_lm_eval(monkeypatch):
    # other test modules may have stubbed lm_eval into sys.modules; scrub so
    # both adapters see a truly absent package
    for name in list(sys.modules):
        if name == "lm_eval" or name.startswith("lm_eval."):
            monkeypatch.delitem(sys.modules, name)
    lm = TEvalLM({"embed": torch.zeros(1)}, _t_forward, Cfg())
    with pytest.raises(ImportError, match="native harness") as e:
        t_adapter.make_lm_eval_model(lm, _word_encode, _decode)
    assert "iron_weight_only_quant_tpu_torch.evals.zeroshot" in str(e.value)


@pytest.mark.parametrize("reqs", [
    [("a b c", " d"), ("x y", " z")],
    [("", " a b"), ("one two  ", "three")],  # an empty context, trailing spaces
], ids=["plain", "edges"])
def test_loglikelihood_requests_match_jax(models, reqs):
    port, ref = models
    got = port.loglikelihood([Req(*r) for r in reqs])
    want = ref.loglikelihood([Req(*r) for r in reqs])
    assert len(got) == len(want) == len(reqs)
    for (a, ga), (b, gb) in zip(got, want):
        assert isinstance(ga, bool) and ga == gb
        assert a == pytest.approx(b, abs=1e-5)


def test_loglikelihood_rolling_matches_jax(models):
    port, ref = models
    reqs = [Req("a b c d e"), Req(" ".join(f"w{i}" for i in range(150)))]
    got, want = port.loglikelihood_rolling(reqs), ref.loglikelihood_rolling(reqs)
    assert got == pytest.approx(want, abs=1e-5) and all(g < 0 for g in got)


def test_generate_until_matches_jax(models):
    port, ref = models
    reqs = [Req("a b", {"max_gen_toks": 4}), Req("a b", {"until": "t9", "max_gen_toks": 6}),
            Req("c", {"until": ["t7 t8"], "max_gen_toks": 5})]
    got = port.generate_until(reqs)
    assert got == ref.generate_until(reqs)
    assert len(got[0].split()) == 4
    assert port.greedy_until(reqs[:1]) == got[:1]  # the legacy alias

"""The engine's decode programs as capturable bodies (the CPU side of
``engine/graphs.py``).

On the card the engine captures ``_generate_chunk``, ``_serve_chunk`` and
``_serve_combo`` as CUDA graphs (``tests/test_torch_cuda.py``, ``-k graph``);
here, on the CPU, it runs the same bodies eagerly.  What makes them
capturable is held against the JAX package on one tiny W4 LLaMA (2 layers,
hidden 64, g32, norms folded, projections fused), prompts and requests
drawn with numpy from a seed:

* ``generate``'s timeline is a 0-d device tensor: greedy ``generate`` and
  ``serve`` tokens equal the JAX engine's on flat and scan params, 16-bit,
  int8, int4 and paged KV caches;
* the engine keeps one cache set per batch size and resets it in place:
  successive calls on one engine give a fresh engine's tokens, and a reset
  set holds a fresh set's bytes;
* ``write_columns`` with a 0-d tensor start writes the bytes of its int
  start;
* each program's graph key lists the JAX function's static arguments.
"""

import inspect
import re

import numpy as np
import pytest
import torch

import jax

from iron_weight_only_quant_tpu.config import EngineConfig as JEngineConfig
from iron_weight_only_quant_tpu.config import KVCacheConfig as JKV
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.engine import InferenceEngine as JEngine
from iron_weight_only_quant_tpu.engine import engine as j_engine
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.quantize.model_pass import quantize_model_params as j_qmp
from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.engine import graphs
from iron_weight_only_quant_tpu_torch.engine.kvcache import reset_caches
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.models.common import write_columns

J_CFG = j_llama.LlamaConfig.tiny(vocab_size=256)
T_CFG = t_llama.LlamaConfig(**{f: getattr(J_CFG, f) for f in J_CFG.__dataclass_fields__})
_RNG = np.random.default_rng(11)
PROMPTS = [_RNG.integers(1, 256, n).tolist() for n in (5, 2, 9)]
REQS = [_RNG.integers(1, 256, n).tolist() for n in (3, 11, 6, 1, 8)]
KV = {  # KV cache settings: the four kinds, flat and scan
    "scan_kv16": ({}, True),
    "flat_kv8": (dict(kv_bits=8, kv_group_size=16), False),
    "scan_kv4": (dict(kv_bits=4, kv_group_size=16), True),
    "flat_paged16": (dict(paged=True, page_size=8), False),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The plain CPU path runs many small ops that gain nothing from many
    torch threads; in the parallel test run those threads only contend for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(JAX params, port params): W4 g32 asym, norms folded (the engines
    fuse the projections)."""
    p = j_llama.fold_llama_norms(j_llama.llama_init(J_CFG, jax.random.PRNGKey(3)))
    jp, _ = j_qmp(p, JSpec(fmt="int", bits=4, group_size=32, symmetric=False))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _kv(setting):
    kw, scan = KV[setting]
    return dict(max_seq_len=32, **kw), scan


def _port_engine(model, setting):
    kv, scan = _kv(setting)
    fwd = t_llama.llama_forward_scan if scan else t_llama.llama_forward
    return InferenceEngine(model[1], T_CFG, fwd, family="llama",
                           engine_cfg=EngineConfig(kv=KVCacheConfig(**kv), max_batch_size=3,
                                                   fuse_projections=True, decode_chunk=4),
                           device="cpu")


def _calls(eng):
    """generate (7 new tokens: chunks of 4 and 2 steps) and serve."""
    return (eng.generate(PROMPTS, max_new_tokens=7),
            eng.serve(REQS, max_new_tokens=5, chunk=3))


@pytest.mark.parametrize("setting", list(KV))
def test_tensor_timeline_tokens_match_jax(model, setting):
    """The port's ``generate`` runs its decode chunks on a 0-d device
    timeline; its tokens, and ``serve``'s, are the JAX engine's."""
    kv, scan = _kv(setting)
    fwd = j_llama.llama_forward_scan if scan else j_llama.llama_forward
    je = JEngine(model[0], J_CFG, fwd, family="llama",
                 engine_cfg=JEngineConfig(kv=JKV(**kv), max_batch_size=3,
                                          fuse_projections=True, decode_chunk=4))
    assert _calls(_port_engine(model, setting)) == _calls(je)


@pytest.mark.parametrize("setting", ["scan_kv16", "flat_kv8", "flat_paged16"])
def test_kept_caches_reset_in_place(model, setting):
    """One engine, one cache set per batch size, reset at each call: every
    call gives a fresh engine's tokens, and a reset set holds the bytes of
    a freshly allocated one."""

    def calls(eng):  # batch 3, 3 and 2
        return _calls(eng) + (eng.generate(PROMPTS[:2], max_new_tokens=3),)

    eng = _port_engine(model, setting)
    got = calls(eng)
    sets = dict(eng._cache_sets)
    assert sorted(sets) == [2, 3]
    fresh = [_port_engine(model, setting) for _ in range(3)]
    want = (fresh[0].generate(PROMPTS, max_new_tokens=7),
            fresh[1].serve(REQS, max_new_tokens=5, chunk=3),
            fresh[2].generate(PROMPTS[:2], max_new_tokens=3))
    assert got == want
    assert calls(eng) == want
    assert all(eng._cache_sets[b] is sets[b] for b in sets)  # kept, not reallocated
    for b, caches in sets.items():
        with torch.inference_mode():  # the engine's buffers are inference tensors
            reset_caches(caches)
        views = [caches] if hasattr(caches, "_fields") else caches
        new = eng._fresh_caches(b)
        for view, ref in zip(views, [new] if hasattr(new, "_fields") else new, strict=True):
            for name, t, r in zip(view._fields, view, ref):
                if torch.is_tensor(t):
                    assert t.dtype == r.dtype and torch.equal(t, r), name
                else:
                    assert t == r, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("start", [0, 5, 30, 31])
def test_write_columns_with_a_0d_start_writes_the_int_starts_bytes(start, s, dtype):
    """Starts near the end are clamped so the S tokens fit, as for an int."""
    g = torch.Generator().manual_seed(start * 10 + s)

    def bufs():
        return [(torch.randn((2, 32, 3, 4), generator=g) * 50).to(dtype) for _ in range(2)]

    a = bufs()
    b = [t.clone() for t in a]
    news = [(torch.randn((2, s, 3, 4), generator=g) * 50).to(dtype) for _ in range(2)]
    got = write_columns(b, news, torch.tensor(start))
    want = write_columns(a, news, start)
    assert torch.is_tensor(got) and got.dim() == 0 and int(got) == want == start + s
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _jax_static_argnames(name):
    """The ``static_argnames`` of the JAX engine's jitted ``name``, read
    from its decorator."""
    src = inspect.getsource(j_engine)
    m = re.search(r"static_argnames=\(([^)]*)\),[^@]*?\ndef " + name + r"\(", src, re.S)
    assert m, name
    return tuple(re.findall(r'"(\w+)"', m.group(1)))


@pytest.mark.parametrize("program", ["_generate_chunk", "_serve_chunk", "_serve_combo"])
def test_graph_keys_list_the_jax_static_arguments(program):
    """A key holds JAX's static arguments (the program is compiled once for
    each set of them), then the shapes of the port's body; ``graph_key``
    refuses any other set of fields."""
    fields = graphs.KEYS[program]
    jax_static = _jax_static_argnames(program)
    assert fields[: len(jax_static)] == jax_static
    assert set(fields[len(jax_static):]) <= {"batch", "ns", "mp"}
    key = graphs.graph_key(program, **{f: i for i, f in enumerate(fields)})
    assert key == (program,) + tuple(range(len(fields)))
    with pytest.raises(ValueError, match="keys on"):
        graphs.graph_key(program, **{f: 0 for f in fields[1:]})


def test_the_cpu_engine_runs_the_eager_bodies(model):
    """On the CPU the engine holds no graphs: its chunk dispatch calls the
    eager body (the plain path's rule)."""
    eng = _port_engine(model, "flat_kv8")
    assert eng._graphs is None
    assert eng._chunk(("any",), lambda x: x + 1, {"x": torch.tensor(1)}) == 2

"""Port parity: two gloo ranks on the CPU against one process and against the
JAX package.

One ``torch.multiprocessing`` spawn of two ranks (gloo, a file store in
``tmp_path``, one torch thread a rank) runs every case below; the inputs
go to the ranks as one ``torch.save`` file, each rank writes its results
to another, and the tests compare them here.  Tiny LLaMA (W4 g32, folded
norms, a W4 lm_head without N padding), OPT (W4 g32) and BLOOM (W8 g32),
their biases random, are built by the JAX package and carried across:

* ``tp_column_matmul`` / ``tp_row_matmul`` (int4 and int8 g32) equal the
  JAX shard_map ops on the virtual 8-device mesh (f32, rtol 1e-4);
* the LLaMA TP forward's logits equal ``make_tp_llama_forward``'s at
  d = 2 (f32, rtol 1e-4), its prefill on head-split caches gives them
  too, and its decode step after it the one-process forward's;
* LLaMA, OPT and BLOOM, flat and scan, ``generate`` and ``serve`` on 16-bit
  and int8 KV caches at model = 2, LLaMA also on paged 16-bit and int8
  caches, and every family at data = 2: greedy tokens equal one process's
  (the plain engine here), on both ranks;
* the OPT and BLOOM flat TP forwards' logits (one-layer models with their
  own random biases) equal ``make_tp_opt_forward``'s and
  ``make_tp_bloom_forward``'s at d = 2 (f32, rtol 1e-4), and every
  family's stacked TP forward gives its flat one's logits;
* the GPipe forward over 2 stages, 2 micro-batches, equals
  ``make_pp_llama_forward``'s logits (1e-4), with the vocab-parallel dense
  head and with the packed head that falls back to the last stage.

A second spawn of two processes joins a group through ``multihost_init``
from the ``IWOQ_*`` variables alone, as a launcher's ranks do.

The ranks import this module but not JAX: the JAX package is only used by
the fixtures and tests, which run here.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from iron_weight_only_quant_tpu_torch.config import EngineConfig, KVCacheConfig, MeshConfig
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.engine.kvcache import make_caches
from iron_weight_only_quant_tpu_torch.models import bloom as t_bloom
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.models import opt as t_opt
from iron_weight_only_quant_tpu_torch.parallel import pp as t_pp
from iron_weight_only_quant_tpu_torch.parallel import tp as t_tp
from iron_weight_only_quant_tpu_torch.parallel import tp_block as t_tpb
from iron_weight_only_quant_tpu_torch.parallel.mesh import (
    all_gather,
    all_gather_object,
    make_mesh,
    spawn_ranks,
)
from iron_weight_only_quant_tpu_torch.parallel.sharding import apply_sharding, param_specs

TOL = 1e-4  # f32, port vs JAX
MODULES = {"llama": t_llama, "opt": t_opt, "bloom": t_bloom}
PROMPTS = [[1, 7, 3, 9, 2], [5, 2], [8, 8, 1], [4, 4, 4, 4, 4, 4], [9, 3]]
NEW = 5
KV = {"kv16": {}, "kv8": {"kv_bits": 8, "kv_group_size": 16},
      "paged16": {"paged": True, "page_size": 8},
      "paged8": {"paged": True, "page_size": 8, "kv_bits": 8, "kv_group_size": 16}}
# (family, scan, kv) at model = 2; (family, scan) at data = 2 (16-bit cache)
MODEL_CASES = [(f, s, kv) for f in MODULES for s in (False, True) for kv in ("kv16", "kv8")]
MODEL_CASES += [("llama", False, "paged16"), ("llama", False, "paged8")]
DATA_CASES = [(f, s) for f in MODULES for s in (False, True)]


def _ecfg(family, kv, mesh=MeshConfig()):
    return EngineConfig(kv=KVCacheConfig(max_seq_len=32, **KV[kv]), max_batch_size=3,
                        fuse_projections=family == "llama", mesh=mesh)


def _forward(family, scan):
    name = f"{family}_forward" + ("_scan" if scan else "")
    return getattr(MODULES[family], name)


def run_engine(params, cfg, family, scan, kv, mesh=MeshConfig()):
    """(generate tokens, serve tokens) of ``params`` on ``mesh`` (the plain
    one-process engine for the default mesh)."""
    eng = InferenceEngine(params, cfg, _forward(family, scan), family=family,
                          engine_cfg=_ecfg(family, kv, mesh), device="cpu")
    return (eng.generate(PROMPTS, max_new_tokens=NEW),
            eng.serve(PROMPTS, max_new_tokens=NEW, chunk=2))


# ------------------------------------------------------------ rank side

def _tp_logits(params, cfg, family, stacked, toks, mesh):
    """No-cache logits of the TP forward (by its JAX name) on this rank's
    shard of TP-prepared ``params``."""
    specs = param_specs(family, params)
    specs["embed"] = ()
    make = getattr(t_tpb, f"make_tp_{family}_forward" + ("_stacked" if stacked else ""))
    return make(cfg, mesh)(apply_sharding(params, specs, mesh), toks)[0]


def _rank_cases(rank, world, device, inputs, out_prefix):
    """Every case on this rank; writes ``{out_prefix}.{rank}``."""
    inp = torch.load(inputs, weights_only=False)
    res = {}
    mesh = make_mesh(MeshConfig(data=1, model=2), device)

    for key, (x, qt_col, qt_row) in inp["matmul"].items():
        res["col", key] = all_gather(t_tp.tp_column_matmul(x, qt_col, mesh), mesh.model_group)
        res["row", key] = t_tp.tp_row_matmul(x, qt_row, mesh)

    cfg, flat, toks = inp["llama_tp"]
    specs = param_specs("llama", flat)
    specs["embed"] = ()
    local = apply_sharding(flat, specs, mesh)
    fwd = t_tpb.make_tp_llama_forward(cfg, mesh)
    caches = make_caches(cfg.num_layers, toks.shape[0], cfg.num_kv_heads // 2, cfg.hd,
                         KVCacheConfig(max_seq_len=32), torch.float32, "cpu")
    res["tp_logits"], _ = fwd(local, toks)
    res["tp_prefill"], caches = fwd(local, toks, caches=caches)
    res["tp_decode"], _ = fwd(local, inp["llama_next"], caches=caches)
    for family in MODULES:
        cfg, flat, plain = inp["tp"][family]
        if family != "llama":
            res["tp_flat", family] = _tp_logits(flat, cfg, family, False, toks, mesh)
        res["tp_stacked", family] = _tp_logits(
            t_tpb.prepare_tp_stacked(plain, 2, family=family), cfg, family, True, toks, mesh)

    for family, scan, kv in MODEL_CASES:
        cfg, params = inp["models"][family]
        res["model", family, scan, kv] = run_engine(params, cfg, family, scan, kv,
                                                    MeshConfig(model=2))
    for family, scan in DATA_CASES:
        cfg, params = inp["models"][family]
        res["data", family, scan] = run_engine(params, cfg, family, scan, "kv16",
                                               MeshConfig(data=2))

    cfg4, toks4 = inp["pp_cfg"], inp["pp_tokens"]
    for key, staged in inp["pp"].items():
        staged = apply_sharding(staged, t_pp.pp_param_specs(staged), mesh)
        res["pp", key] = t_pp.make_pp_llama_forward(cfg4, mesh, n_microbatches=2)(staged, toks4)
    res["ranks"] = all_gather_object(rank, mesh.model_group)
    torch.save(res, f"{out_prefix}.{rank}")


# ------------------------------------------------------------ parent side

def _jax():
    import jax

    return jax


def _port(tree):
    from iron_weight_only_quant_tpu_torch.interop import params_from_numpy

    return params_from_numpy(_jax().tree.map(np.asarray, tree), "cpu")


def _configs(family, num_layers=None):
    from iron_weight_only_quant_tpu.models import bloom, llama, opt

    jm = {"llama": llama, "opt": opt, "bloom": bloom}[family]
    name = {"llama": "LlamaConfig", "opt": "OPTConfig", "bloom": "BloomConfig"}[family]
    jc = getattr(jm, name).tiny()
    if num_layers is not None:
        jc = dataclasses.replace(jc, num_layers=num_layers)
    return jc, getattr(MODULES[family], name)(**{f: getattr(jc, f)
                                                 for f in jc.__dataclass_fields__})


def _jspec(bits):
    from iron_weight_only_quant_tpu.config import QuantSpec

    return QuantSpec(fmt="int", bits=bits, group_size=32, symmetric=False)


def _jax_model(family, bits, seed, num_layers=None):
    """The JAX package's tiny model (``num_layers`` deep if given), random
    biases and norm gammas, W``bits`` g32; LLaMA folded, with a W4 lm_head
    (N = 256: no padding)."""
    import jax.numpy as jnp

    from iron_weight_only_quant_tpu.models import bloom, llama, opt
    from iron_weight_only_quant_tpu.quantize.model_pass import quantize_model_params
    from iron_weight_only_quant_tpu.quantize.rtn import quantize_tensor

    jax = _jax()
    jc, _ = _configs(family, num_layers)
    init = {"llama": llama.llama_init, "opt": opt.opt_init, "bloom": bloom.bloom_init}[family]
    p = init(jc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def rand(node):
        return jnp.asarray(0.02 * rng.normal(size=node.shape), jnp.float32)

    layers = []
    for lay in p["layers"]:
        lay = dict(lay)
        for key, v in lay.items():
            if isinstance(v, dict) and v.get("b") is not None:
                lay[key] = {**v, "b": rand(v["b"])}
            elif family == "llama" and key.endswith("norm"):
                lay[key] = jnp.asarray(1 + 0.1 * rng.normal(size=v.shape), jnp.float32)
        layers.append(lay)
    p = {**p, "layers": layers}
    if family == "llama":
        p = llama.fold_llama_norms(p)
        p["lm_head"] = {"w": quantize_tensor(p["lm_head"]["w"], _jspec(4)), "b": None}
    return quantize_model_params(p, _jspec(bits))[0]


@pytest.fixture(scope="module")
def two_ranks(cpu_devices, tmp_path_factory):
    """Runs the spawn once: (the inputs as the JAX package holds them,
    the results of rank 0, the results of rank 1)."""
    import jax.numpy as jnp

    from iron_weight_only_quant_tpu.models import llama
    from iron_weight_only_quant_tpu.parallel import tp_block as j_tpb
    from iron_weight_only_quant_tpu.quantize.rtn import quantize_tensor

    jax = _jax()
    rng = np.random.default_rng(0)
    jin = {"matmul": {}}
    inp = {"matmul": {}}
    for bits in (4, 8):
        w = jnp.asarray(0.05 * rng.normal(size=(128, 96)), jnp.float32)
        x = rng.normal(size=(3, 128)).astype(np.float32)
        jcol = quantize_tensor(w, _jspec(bits))
        jrow = quantize_tensor(w, _jspec(bits), k_shards=2)
        jin["matmul"][bits] = (x, jcol, jrow)
        inp["matmul"][bits] = (torch.from_numpy(x), _port(jcol), _port(jrow))

    jc, tc = _configs("llama")
    jplain = _jax_model("llama", 4, 7)
    jflat = {**jplain, "layers": [j_tpb.tp_prepare_layer(lay, 2) for lay in jplain["layers"]]}
    inp["llama_ref"] = _port(jplain)
    toks = rng.integers(0, 250, size=(2, 10))
    nxt = rng.integers(0, 250, size=(2, 1))
    jin["llama_tp"] = (jc, jflat, toks, nxt)
    inp["llama_tp"] = (tc, _port(jflat), torch.from_numpy(toks))
    inp["llama_next"] = torch.from_numpy(nxt)

    jin["models"], inp["models"] = {}, {}
    for family, bits in (("llama", 4), ("opt", 4), ("bloom", 8)):
        jp = _jax_model(family, bits, 1)
        jin["models"][family] = jp
        inp["models"][family] = (_configs(family)[1], _port(jp))
    # the TP forwards' logits on the same tokens: OPT/BLOOM flat (TP-prepared
    # by the JAX package; one layer, as a JAX TP forward costs about 14 s a
    # layer here) against JAX, every family's stacked form (prepared on the
    # rank) against its flat one
    jin["tp"] = {}
    inp["tp"] = {"llama": (tc, inp["llama_tp"][1], inp["llama_ref"])}
    for family, bits in (("opt", 4), ("bloom", 8)):
        jc1, tc1 = _configs(family, num_layers=1)
        jp = _jax_model(family, bits, 2, num_layers=1)
        jf = {**jp, "layers": [j_tpb.tp_prepare_layer(lay, 2, family=family)
                               for lay in jp["layers"]]}
        jin["tp"][family] = (jc1, jf)
        inp["tp"][family] = (tc1, _port(jf), _port(jp))

    jc4 = llama.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                            num_layers=4, num_heads=4, num_kv_heads=2,
                            max_position_embeddings=128)
    jp4 = llama.llama_init(jc4, jax.random.PRNGKey(3))
    jp4_packed = {**jp4, "lm_head": {"w": quantize_tensor(jp4["lm_head"]["w"], _jspec(8)),
                                     "b": None}}
    jin["pp"] = {"dense_head": jp4, "packed_head": jp4_packed}
    inp["pp"] = {k: t_pp.stage_stack_llama_layers(_port(v), 2) for k, v in jin["pp"].items()}
    toks4 = rng.integers(0, 250, size=(4, 10))
    jin["pp_cfg"], jin["pp_tokens"] = jc4, toks4
    inp["pp_cfg"] = t_llama.LlamaConfig(**{f: getattr(jc4, f) for f in jc4.__dataclass_fields__})
    inp["pp_tokens"] = torch.from_numpy(toks4)

    folder = tmp_path_factory.mktemp("ranks")
    path = str(folder / "inputs.pt")
    torch.save(inp, path)
    spawn_ranks(_rank_cases, 2, (path, str(folder / "out")), platform="cpu", threads=1)
    outs = [torch.load(str(folder / f"out.{r}"), weights_only=False) for r in range(2)]
    return jin, inp, outs


@pytest.mark.parametrize("bits", [4, 8])
def test_tp_matmuls_equal_jax(two_ranks, bits):
    from iron_weight_only_quant_tpu.config import MeshConfig as JMesh
    from iron_weight_only_quant_tpu.parallel import make_mesh as j_make_mesh
    from iron_weight_only_quant_tpu.parallel import tp as j_tp

    jin, _, outs = two_ranks
    x, jcol, jrow = jin["matmul"][bits]
    jmesh = j_make_mesh(JMesh(data=1, model=2))
    want_col = np.asarray(j_tp.tp_column_matmul(x, jcol, jmesh))
    want_row = np.asarray(j_tp.tp_row_matmul(x, jrow, jmesh))
    for res in outs:
        np.testing.assert_allclose(res["col", bits].numpy(), want_col, rtol=TOL, atol=1e-5)
        np.testing.assert_allclose(res["row", bits].numpy(), want_row, rtol=TOL, atol=1e-5)


def test_llama_tp_logits_equal_jax(two_ranks):
    """The no-cache logits against the JAX shard_map forward; the prefill on
    head-split caches against them, and the decode step after it against the
    one-process forward on a whole cache."""
    from iron_weight_only_quant_tpu.config import MeshConfig as JMesh
    from iron_weight_only_quant_tpu.parallel import make_mesh as j_make_mesh
    from iron_weight_only_quant_tpu.parallel import tp_block as j_tpb

    jin, inp, outs = two_ranks
    jc, jflat, toks, nxt = jin["llama_tp"]
    want, _ = j_tpb.make_tp_llama_forward(jc, j_make_mesh(JMesh(data=1, model=2)))(jflat, toks)
    tc, ref = inp["llama_tp"][0], inp["llama_ref"]
    caches = make_caches(tc.num_layers, 2, tc.num_kv_heads, tc.hd,
                         KVCacheConfig(max_seq_len=32), torch.float32, "cpu")
    _, caches = t_llama.llama_forward(ref, torch.from_numpy(toks), tc, caches=caches)
    want_dec, _ = t_llama.llama_forward(ref, torch.from_numpy(nxt), tc, caches=caches)
    for res in outs:
        np.testing.assert_allclose(res["tp_logits"].numpy(), np.asarray(want), rtol=TOL,
                                   atol=1e-5)
        np.testing.assert_allclose(res["tp_prefill"].numpy(), res["tp_logits"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["tp_decode"].numpy(), want_dec.numpy(), rtol=TOL,
                                   atol=1e-5)


@pytest.mark.parametrize("family", ["opt", "bloom"])
def test_opt_bloom_tp_logits_equal_jax(two_ranks, family):
    """The flat OPT/BLOOM TP forwards (the row-parallel bias added once after
    the reduce, BLOOM's per-shard ALiBi slopes) against the JAX shard_map
    forwards on the same random-bias weights."""
    from iron_weight_only_quant_tpu.config import MeshConfig as JMesh
    from iron_weight_only_quant_tpu.parallel import make_mesh as j_make_mesh
    from iron_weight_only_quant_tpu.parallel import tp_block as j_tpb

    jin, _, outs = two_ranks
    jc, jflat = jin["tp"][family]
    make = {"opt": j_tpb.make_tp_opt_forward, "bloom": j_tpb.make_tp_bloom_forward}[family]
    want, _ = make(jc, j_make_mesh(JMesh(data=1, model=2)))(jflat, jin["llama_tp"][2])
    for res in outs:
        np.testing.assert_allclose(res["tp_flat", family].numpy(), np.asarray(want),
                                   rtol=TOL, atol=1e-5)


@pytest.mark.parametrize("family", list(MODULES))
def test_stacked_tp_logits_equal_flat(two_ranks, family):
    _, _, outs = two_ranks
    for res in outs:
        flat = res["tp_logits"] if family == "llama" else res["tp_flat", family]
        np.testing.assert_allclose(res["tp_stacked", family].numpy(), flat.numpy(),
                                   rtol=TOL, atol=1e-5)


@pytest.fixture(scope="module")
def one_process(two_ranks):
    """The plain one-process engine's tokens for each model case."""
    _, inp, _ = two_ranks
    out = {}
    for f, s, kv in MODEL_CASES + [(f, s, "kv16") for f, s in DATA_CASES]:
        cfg, params = inp["models"][f]
        out[f, s, kv] = run_engine(params, cfg, f, s, kv)
    return out


@pytest.mark.parametrize("family,scan,kv", MODEL_CASES,
                         ids=[f"{f}-{'scan' if s else 'flat'}-{kv}" for f, s, kv in MODEL_CASES])
def test_model_2_tokens_equal_one_process(two_ranks, one_process, family, scan, kv):
    _, _, outs = two_ranks
    want = one_process[family, scan, kv]
    assert all(len(o) == NEW for o in want[0] + want[1])
    for res in outs:
        assert res["model", family, scan, kv] == want


@pytest.mark.parametrize("family,scan", DATA_CASES,
                         ids=[f"{f}-{'scan' if s else 'flat'}" for f, s in DATA_CASES])
def test_data_2_tokens_equal_one_process(two_ranks, one_process, family, scan):
    _, _, outs = two_ranks
    for res in outs:
        assert res["data", family, scan] == one_process[family, scan, "kv16"]


@pytest.mark.parametrize("head", ["dense_head", "packed_head"])
def test_pp_logits_equal_jax(two_ranks, head):
    from jax.sharding import Mesh as JaxMesh

    from iron_weight_only_quant_tpu.parallel.pp import (
        make_pp_llama_forward,
        stage_stack_llama_layers,
    )

    jax = _jax()
    jin, _, outs = two_ranks
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("stage",))
    fwd = make_pp_llama_forward(jin["pp_cfg"], mesh, n_microbatches=2)
    want = np.asarray(fwd(stage_stack_llama_layers(jin["pp"][head], 2), jin["pp_tokens"]))
    for res in outs:
        np.testing.assert_allclose(res["pp", head].numpy(), want, rtol=TOL, atol=1e-5)


def test_both_ranks_ran(two_ranks):
    _, _, outs = two_ranks
    assert [res["ranks"] for res in outs] == [[0, 1], [0, 1]]
    assert not os.environ.get("IWOQ_NUM_PROCESSES")


def _launched_rank(index, port, out):
    """A rank as a launcher starts it: only the environment says where."""
    import torch.distributed as dist

    from iron_weight_only_quant_tpu_torch.parallel.mesh import multihost_init

    torch.set_num_threads(1)
    os.environ.update(IWOQ_NUM_PROCESSES="2", IWOQ_PROCESS_ID=str(index),
                      IWOQ_COORDINATOR=f"127.0.0.1:{port}")
    backend = multihost_init(platform="cpu")
    t = torch.tensor([index + 1.0])
    dist.all_reduce(t)
    torch.save((backend, dist.get_rank(), dist.get_world_size(), t.item()), f"{out}.{index}")
    dist.destroy_process_group()


def test_multihost_init_joins_a_launchers_group(tmp_path):
    """Two processes joined by ``multihost_init`` from ``IWOQ_*`` alone (a
    TCP store on 127.0.0.1): each takes its rank from ``IWOQ_PROCESS_ID``."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_launched_rank, args=(port, str(tmp_path / "out")), nprocs=2, join=True)
    got = [torch.load(str(tmp_path / f"out.{i}")) for i in range(2)]
    assert got == [("gloo", 0, 2, 3.0), ("gloo", 1, 2, 3.0)]


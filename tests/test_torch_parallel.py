"""Port parity: the parallel package's transforms, specs and one-rank runs.

Tiny LLaMA, OPT and BLOOM models (``*Config.tiny()``: hidden 64, 4 heads;
LLaMA 2 KV heads) are built by the JAX package, int4 and int8 with groups
of 32, and carried to the port as numpy (``interop.params_from_numpy``):

* the TP transforms write the JAX package's bytes: ``_slice_cols``,
  ``_pad_cols_zero``, ``fuse_projections_tp``, ``tp_prepare_layer``,
  ``prepare_tp_stacked``, ``shard_model_params`` at d = 2 and
  ``stage_stack_llama_layers``;
* ``param_specs`` maps leaf by leaf onto the JAX ``PartitionSpec`` tree,
  flat and stacked, and each rank's ``apply_sharding`` slice equals the
  JAX shard of that device on the virtual 8-device mesh;
* ``validate_tp_stacked`` refuses what the JAX one refuses; a padded
  column-parallel artifact (the lm_head of a d > 1 mesh), a row-parallel
  one not repacked to ``k_shards = d`` and head counts that do not divide
  the model axis raise ``ValueError``;
* ``tp_block=True`` on one rank (with and without a one-rank gloo group)
  gives the plain engine's greedy tokens, flat and scan.

The two-rank runs are in ``tests/test_torch_parallel_ranks.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from iron_weight_only_quant_tpu.config import MeshConfig as JMesh
from iron_weight_only_quant_tpu.config import QuantSpec as JSpec
from iron_weight_only_quant_tpu.models import bloom as j_bloom
from iron_weight_only_quant_tpu.models import llama as j_llama
from iron_weight_only_quant_tpu.models import opt as j_opt
from iron_weight_only_quant_tpu.parallel import make_mesh as j_make_mesh
from iron_weight_only_quant_tpu.parallel import pp as j_pp
from iron_weight_only_quant_tpu.parallel import sharding as j_sharding
from iron_weight_only_quant_tpu.parallel import tp_block as j_tpb
from iron_weight_only_quant_tpu.quantize.model_pass import quantize_model_params as j_qmp
from iron_weight_only_quant_tpu.quantize.rtn import quantize_tensor as j_quantize
from iron_weight_only_quant_tpu_torch.config import (
    EngineConfig,
    KVCacheConfig,
    MeshConfig,
    QuantSpec,
)
from iron_weight_only_quant_tpu_torch.engine import InferenceEngine
from iron_weight_only_quant_tpu_torch.interop import params_from_numpy
from iron_weight_only_quant_tpu_torch.models import bloom as t_bloom
from iron_weight_only_quant_tpu_torch.models import llama as t_llama
from iron_weight_only_quant_tpu_torch.models import opt as t_opt
from iron_weight_only_quant_tpu_torch.models.common import FusedLinear, stack_model_layers
from iron_weight_only_quant_tpu_torch.parallel import pp as t_pp
from iron_weight_only_quant_tpu_torch.parallel import sharding as t_sharding
from iron_weight_only_quant_tpu_torch.parallel import tp_block as t_tpb
from iron_weight_only_quant_tpu_torch.parallel.mesh import Mesh
from iron_weight_only_quant_tpu_torch.quantize import QuantizedTensor
from iron_weight_only_quant_tpu_torch.quantize import quantize_tensor as t_quantize
from iron_weight_only_quant_tpu_torch.quantize.model_pass import quantize_model_params as t_qmp
from iron_weight_only_quant_tpu_torch.quantize.qtensor import repack_k_shards

FAMILIES = {  # family -> (JAX module, port module, init, forward name)
    "llama": (j_llama, t_llama, "llama_init", "llama_forward"),
    "opt": (j_opt, t_opt, "opt_init", "opt_forward"),
    "bloom": (j_bloom, t_bloom, "bloom_init", "bloom_forward"),
}
CONFIGS = {"llama": "LlamaConfig", "opt": "OPTConfig", "bloom": "BloomConfig"}
BITS = (4, 8)
PROMPTS = [[1, 7, 3, 9], [5, 2], [8, 8, 1]]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small ops gain nothing from many torch threads; in the parallel test
    run those threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec(bits):
    return JSpec(fmt="int", bits=bits, group_size=32, symmetric=False)


def _tspec(bits):
    return QuantSpec(fmt="int", bits=bits, group_size=32, symmetric=False)


def configs(family):
    jm, tm, _, _ = FAMILIES[family]
    jc = getattr(jm, CONFIGS[family]).tiny()
    return jc, getattr(tm, CONFIGS[family])(**{f: getattr(jc, f)
                                               for f in jc.__dataclass_fields__})


def jax_dense(family, seed=0):
    jm, _, init, _ = FAMILIES[family]
    return getattr(jm, init)(configs(family)[0], jax.random.PRNGKey(seed))


def port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _bits(a):
    return a.detach().contiguous().view(torch.uint8).numpy()


def assert_same_tree(got, want):
    """Equal structure; tensors equal in dtype, shape and bytes; equal
    artifact and fused-linear fields.  ``want`` is a port tree (a JAX tree
    carried across)."""
    if isinstance(want, QuantizedTensor):
        assert isinstance(got, QuantizedTensor)
        for f in ("spec", "shape", "mode", "k_shards", "n_pad", "k_pad", "side_pad"):
            assert getattr(got, f) == getattr(want, f), f
        for f in ("qweight", "scales", "zeros", "codebook"):
            assert_same_tree(getattr(got, f), getattr(want, f))
    elif isinstance(want, FusedLinear):
        assert isinstance(got, FusedLinear) and got.spans == want.spans
        assert_same_tree(got.w, want.w)
        assert_same_tree(got.b, want.b)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            assert_same_tree(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_tree(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(_bits(got), _bits(want))


# ------------------------------------------------------------ transforms

@pytest.mark.parametrize("bits", BITS)
def test_slice_and_pad_cols_equal_jax(bits):
    w = jnp.asarray(np.random.default_rng(bits).normal(size=(128, 300)), jnp.float32)
    jq = j_quantize(w, _spec(bits), pad_n_to=512)
    tq = port(jq)
    for a, b in ((0, 100), (100, 300), (37, 211)):
        js = j_tpb._slice_cols(jq, a, b)
        assert_same_tree(t_tpb._slice_cols(tq, a, b), port(js))
        assert_same_tree(t_tpb._pad_cols_zero(t_tpb._slice_cols(tq, a, b), 128),
                         port(j_tpb._pad_cols_zero(js, 128)))


@pytest.fixture(scope="module")
def quantized():
    """(family, bits) -> JAX params quantized with row-parallel k_shards=1
    (the model pass), built on first use; LLaMA's norms folded."""
    return {}


def jax_quantized(quantized, family, bits):
    if (family, bits) not in quantized:
        p = jax_dense(family)
        if family == "llama":
            rng = np.random.default_rng(5)
            p["layers"] = [{**l, "input_norm": jnp.asarray(1 + 0.1 * rng.normal(size=64),
                                                          jnp.float32),
                            "post_norm": jnp.asarray(1 + 0.1 * rng.normal(size=64),
                                                     jnp.float32)} for l in p["layers"]]
            p = j_llama.fold_llama_norms(p)
        quantized[family, bits] = j_qmp(p, _spec(bits))[0]
    return quantized[family, bits]


@pytest.mark.parametrize("bits", BITS)
def test_fuse_projections_tp_equals_jax(quantized, bits):
    jp = j_tpb.shard_llama_params(jax_quantized(quantized, "llama", bits), None, None, 2)
    tp = port(jp)
    for d in (1, 2):
        got = t_tpb.fuse_projections_tp(tp, d)
        assert_same_tree(got, port(j_tpb.fuse_projections_tp(jp, d)))
        assert "qkv" in got["layers"][0] and "gate_up" in got["layers"][0]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("bits", BITS)
def test_tp_prepare_layer_and_stacked_equal_jax(quantized, family, bits):
    jp = jax_quantized(quantized, family, bits)
    tp = port(jp)
    got = t_tpb.tp_prepare_layer(tp["layers"][0], 2, family=family)
    assert_same_tree(got, port(j_tpb.tp_prepare_layer(jp["layers"][0], 2, family=family)))
    assert got["o"]["w"].k_shards == 2
    got = t_tpb.prepare_tp_stacked(tp, 2, family=family)
    assert "layers" in tp  # the caller's tree is kept
    assert_same_tree(got, port(j_tpb.prepare_tp_stacked(jp, 2, family=family)))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("bits", BITS)
def test_shard_model_params_equals_jax(family, bits):
    jd = jax_dense(family, seed=1)
    want = port(j_tpb.shard_model_params(jd, None, _spec(bits), 2, family))
    got = t_tpb.shard_model_params(port(jd), None, _tspec(bits), 2, family)
    assert_same_tree(got, want)
    _, row_keys = t_tpb._FAMILY_LINEARS[family]
    assert all(got["layers"][0][k]["w"].k_shards == 2 for k in row_keys)


@pytest.mark.parametrize("bits", BITS)
def test_stage_stack_equals_jax(quantized, bits):
    jp = j_llama.llama_init(dataclasses.replace(configs("llama")[0], num_layers=4),
                            jax.random.PRNGKey(2))
    jp = j_qmp(jp, _spec(bits))[0]
    got = t_pp.stage_stack_llama_layers(port(jp), 2)
    assert_same_tree(got, port(j_pp.stage_stack_llama_layers(jp, 2)))
    assert got["stages"]["q"]["w"].qweight.shape[:2] == (2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        t_pp.stage_stack_llama_layers(port(jp), 3)


# ------------------------------------------------------------ specs, shards

def _same_specs(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _same_specs(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_specs(g, w)
    else:
        assert got == tuple(want), (got, want)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("layout", ["flat", "stacked"])
def test_param_specs_map_onto_jax(quantized, family, layout):
    jp = jax_quantized(quantized, family, 4)
    if layout == "stacked":
        jp = j_tpb.prepare_tp_stacked(jp, 2, family=family)
    elif family == "llama":
        jp = j_tpb.fuse_projections_tp(jp, 2)
    _same_specs(t_sharding.param_specs(family, port(jp)), j_sharding.param_specs(family, jp))


def _mesh(model, index, data=1, data_index=0):
    return Mesh(data, model, data_index * model + index, data * model, data_index, index,
                None, None, [data_index * model + j for j in range(model)],
                torch.device("cpu"))


def _jax_shards(tree, i):
    """Device i's shard of every array of a JAX tree placed by apply_sharding."""
    dev = jax.devices()[i]

    def shard(a):
        for s in a.addressable_shards:
            if s.device == dev:
                return np.asarray(s.data)
        raise AssertionError("no shard on the device")

    return jax.tree.map(shard, tree)


@pytest.mark.parametrize("layout", ["flat", "stacked"])
def test_apply_sharding_gives_each_rank_its_jax_shard(cpu_devices, quantized, layout):
    jp = jax_quantized(quantized, "llama", 4)
    jp = {**jp, "lm_head": {"w": j_quantize(jp["lm_head"]["w"], _spec(4)), "b": None}}
    jp = (j_tpb.prepare_tp_stacked(jp, 2) if layout == "stacked"
          else j_tpb.fuse_projections_tp(j_tpb.shard_llama_params(jp, None, None, 2), 2))
    placed = j_sharding.apply_sharding(jp, j_sharding.param_specs("llama", jp),
                                       j_make_mesh(JMesh(data=1, model=2)))
    tp = port(jp)
    for i in range(2):
        got = t_sharding.apply_sharding(tp, t_sharding.param_specs("llama", tp), _mesh(2, i))
        assert_same_tree(got, params_from_numpy(_jax_shards(placed, i), "cpu"))


# ------------------------------------------------------------ refusals

def test_validate_tp_stacked_refuses_as_jax(quantized):
    jp = jax_quantized(quantized, "llama", 4)
    unprepared = j_llama.stack_llama_layers(jp)
    with pytest.raises(ValueError, match="k_shards"):
        j_tpb.validate_tp_stacked(unprepared, 2)
    with pytest.raises(ValueError, match="k_shards"):
        t_tpb.validate_tp_stacked(port(unprepared), 2)
    # row-parallel biases (OPT) under stacked TP: the JAX package refuses them
    jo = j_tpb.prepare_tp_stacked(jax_quantized(quantized, "opt", 4), 2, family="opt")
    with pytest.raises(NotImplementedError, match="bias"):
        j_tpb.validate_tp_stacked(jo, 2, "opt")
    with pytest.raises(NotImplementedError, match="bias"):
        t_tpb.validate_tp_stacked(port(jo), 2, "opt")
    # a padded column-parallel artifact (unfused, pad_n_to) at d > 1
    padded = {**jp, "layers": [{**l, "q": {"w": j_quantize(
        jnp.ones((64, 96), jnp.float32), _spec(4), pad_n_to=128), "b": None}}
        for l in jp["layers"]]}
    stacked = j_tpb.prepare_tp_stacked(padded, 2, fuse=False)
    for validate, tree in ((j_tpb.validate_tp_stacked, stacked),
                           (t_tpb.validate_tp_stacked, port(stacked))):
        with pytest.raises(ValueError, match="n_pad"):
            validate(tree, 2)


def test_padded_lm_head_under_model_2_raises(quantized):
    """A quantized lm_head with N padding under d > 1: the JAX package
    computes wrong logits there; the port refuses it."""
    tp = port(jax_quantized(quantized, "llama", 4))
    prepared = {**tp, "layers": [t_tpb.tp_prepare_layer(lay, 2) for lay in tp["layers"]]}
    head = {"w": t_quantize(tp["lm_head"]["w"], _tspec(4), pad_n_to=384), "b": None}
    assert head["w"].n_pad == 128
    fwd = t_tpb.make_tp_llama_forward(configs("llama")[1], _mesh(2, 0))
    tree = {**prepared, "lm_head": head}
    local = t_sharding.apply_sharding(tree, t_sharding.param_specs("llama", tree), _mesh(2, 0))
    with pytest.raises(ValueError, match="n_pad=128"):
        fwd(local, torch.zeros((1, 2), dtype=torch.int64))
    t_tpb._local_view(head, 1, row=False)  # whole on one rank: allowed


def test_row_parallel_artifact_not_repacked_under_model_2_raises(quantized):
    """A row-parallel artifact packed with k_shards=1: a bare row slice of it
    splits its code pairs (the JAX forward computes wrong products there);
    the port refuses it."""
    tp = port(jax_quantized(quantized, "llama", 4))
    fwd = t_tpb.make_tp_llama_forward(configs("llama")[1], _mesh(2, 0))
    with pytest.raises(ValueError, match="k_shards=1 under model=2"):
        fwd(tp, torch.zeros((1, 2), dtype=torch.int64))


def _split_groups_model():
    """A W4 g16 LLaMA whose down (K = 160, 10 groups) splits into whole
    groups over 2 ranks but not over 4 (K/4 = 40), and whose 10 side rows
    the sharding keeps whole at 4; o (K = 64) splits at both."""
    cfg = t_llama.LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=160,
                              num_layers=2, num_heads=4, num_kv_heads=4,
                              max_position_embeddings=64)
    dense = t_llama.llama_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    spec = QuantSpec(fmt="int", bits=4, group_size=16, symmetric=False)
    return cfg, t_qmp(dense, spec, device="cpu")[0]


@pytest.mark.parametrize("scan", [False, True], ids=["flat", "scan"])
def test_row_parallel_groups_that_do_not_split_raise(monkeypatch, scan):
    """model = 4 over a down of K = 160, g = 16: each rank's 40 rows are not
    whole groups.  The engine refuses it (flat and scan) before sharding;
    sharded anyway, the local view refuses the side rows kept whole; a
    pre-stacked tree of such artifacts is refused too."""
    from iron_weight_only_quant_tpu_torch.parallel import mesh as t_mesh

    cfg, qp = _split_groups_model()
    monkeypatch.setattr(t_mesh, "make_mesh", lambda mcfg, device=None: _mesh(4, 0))
    fwd = t_llama.llama_forward_scan if scan else t_llama.llama_forward
    with pytest.raises(ValueError, match="row-parallel 'down': K=160 must split into 4"):
        InferenceEngine(qp, cfg, fwd, family="llama", device="cpu",
                        engine_cfg=EngineConfig(mesh=MeshConfig(model=4)))
    down = qp["layers"][0]["down"]
    for d, ok in ((2, True), (4, False)):
        w = repack_k_shards(down["w"], d)
        local = t_sharding._leaf_sharding(w, t_sharding.ROW, _mesh(d, d - 1))
        if ok:
            view = t_tpb._local_view({**down, "w": local}, d, row=True)["w"]
            assert view.shape == (160 // d, 64) and tuple(local.scales.shape) == (10 // d, 64)
        else:
            assert tuple(local.scales.shape) == (10, 64)  # 10 rows do not split 4 ways
            with pytest.raises(ValueError, match="local side rows"):
                t_tpb._local_view({**down, "w": local}, d, row=True)
    layers = [{**lay, "o": {**lay["o"], "w": repack_k_shards(lay["o"]["w"], 4)},
               "down": {**lay["down"], "w": repack_k_shards(lay["down"]["w"], 4)}}
              for lay in qp["layers"]]
    stacked = stack_model_layers({**qp, "layers": layers}, tp_segments=True)
    with pytest.raises(ValueError, match="whole quantization groups"):
        t_tpb.validate_tp_stacked(stacked, 4)


def test_rank_device_refuses_to_share_a_card_unasked(monkeypatch):
    from iron_weight_only_quant_tpu_torch.parallel import mesh as t_mesh

    monkeypatch.setattr(t_mesh, "resolve_device", lambda platform: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks on this host but 1 card"):
        t_mesh.rank_device("cuda", 1, 2)
    assert t_mesh.rank_device("cuda", 1, 2, share_card=True) == torch.device("cuda", 0)
    assert t_mesh.rank_device("cuda", 0, 1) == torch.device("cuda", 0)
    assert t_mesh.rank_device("cpu", 1, 2) == torch.device("cpu")


def test_multihost_init_takes_the_local_rank_from_the_launcher(monkeypatch):
    """The environment path to a card: this host's count of ranks is
    required; the card is LOCAL_RANK, else the process id modulo that count;
    too few cards raise before any group is joined."""
    from iron_weight_only_quant_tpu_torch.parallel import mesh as t_mesh

    joined = []
    monkeypatch.setattr(t_mesh, "resolve_device", lambda platform: None)
    monkeypatch.setattr(t_mesh, "init_rank", lambda *a: joined.append(a) or "nccl")
    for name in ("LOCAL_WORLD_SIZE", "IWOQ_LOCAL_RANKS", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("IWOQ_NUM_PROCESSES", "1")
    assert t_mesh.multihost_init() is None
    monkeypatch.setenv("IWOQ_NUM_PROCESSES", "4")
    monkeypatch.setenv("IWOQ_PROCESS_ID", "3")
    monkeypatch.setenv("IWOQ_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="IWOQ_LOCAL_RANKS"):
        t_mesh.multihost_init()
    monkeypatch.setenv("IWOQ_LOCAL_RANKS", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks on this host but 1 card"):
        t_mesh.multihost_init()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert t_mesh.multihost_init() == "nccl"
    assert joined[-1] == (3, 4, "tcp://localhost:1", torch.device("cuda", 1), 2)
    monkeypatch.setenv("LOCAL_RANK", "0")
    t_mesh.multihost_init()
    assert joined[-1][3] == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(ValueError, match="local rank 2"):
        t_mesh.multihost_init()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")  # torchrun's count comes first
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    t_mesh.multihost_init()
    assert joined[-1][3:] == (torch.device("cuda", 2), 4)
    assert len(joined) == 3


@pytest.mark.parametrize("family", FAMILIES)
def test_heads_that_do_not_divide_the_model_axis_raise(family):
    jc, tc = configs(family)
    field = "num_kv_heads" if family == "llama" else "num_heads"
    jbad = dataclasses.replace(jc, **{field: 3})
    tbad = dataclasses.replace(tc, **{field: 3})
    jmake = {"llama": j_tpb.make_tp_llama_forward, "opt": j_tpb.make_tp_opt_forward,
             "bloom": j_tpb.make_tp_bloom_forward}[family]
    with pytest.raises(ValueError):
        jmake(jbad, j_make_mesh(JMesh(data=1, model=2)))
    for stacked in (False, True):
        with pytest.raises(ValueError, match="must divide"):
            t_tpb.make_tp_forward(tbad, _mesh(2, 0), family, stacked)


def test_engine_refuses_a_world_that_is_not_the_mesh(quantized):
    tp = port(jax_quantized(quantized, "llama", 4))
    with pytest.raises(ValueError, match="world size 1 differs"):
        InferenceEngine(tp, configs("llama")[1], t_llama.llama_forward, family="llama",
                        engine_cfg=EngineConfig(mesh=MeshConfig(data=2)), device="cpu")


# ------------------------------------------------------------ one rank

@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _engines(tp, family, scan, kv_bits, tp_block=True):
    _, tc = configs(family)
    tm = FAMILIES[family][1]
    fwd = getattr(tm, FAMILIES[family][3] + ("_scan" if scan else ""))
    ecfg = EngineConfig(kv=KVCacheConfig(max_seq_len=32, kv_bits=kv_bits), max_batch_size=2,
                        fuse_projections=family == "llama")
    return (InferenceEngine(tp, tc, fwd, family=family, engine_cfg=ecfg, device="cpu",
                            tp_block=tp_block),
            InferenceEngine(tp, tc, fwd, family=family, engine_cfg=ecfg, device="cpu"))


@pytest.mark.parametrize("family,scan", [("llama", False), ("llama", True), ("opt", False),
                                         ("bloom", True)])
def test_tp_block_on_one_rank_gives_the_plain_tokens(quantized, one_rank_group, family, scan):
    tp = port(jax_quantized(quantized, family, 4))
    eng_tp, eng = _engines(tp, family, scan, 16)
    assert eng_tp.mesh.world == 1 and eng_tp.mesh.model == 1
    assert eng_tp.generate(PROMPTS, max_new_tokens=5) == eng.generate(PROMPTS, max_new_tokens=5)
    assert (eng_tp.serve(PROMPTS, max_new_tokens=4, chunk=2)
            == eng.serve(PROMPTS, max_new_tokens=4, chunk=2))
    if family == "llama":  # the shard-blocked fusion, the row-parallel repack
        layers = eng_tp.params["layers_stacked"] if scan else eng_tp.params["layers"][0]
        assert "qkv" in layers and layers["o"]["w"].k_shards == 1


def test_tp_block_without_a_process_group(quantized):
    """tp_block=True on one process that never joined a group runs, as the
    JAX engine's tp_block on a one-device mesh."""
    assert not dist.is_initialized()
    tp = port(jax_quantized(quantized, "llama", 8))
    eng_tp, eng = _engines(tp, "llama", False, 8)
    assert eng_tp.generate(PROMPTS, max_new_tokens=4) == eng.generate(PROMPTS, max_new_tokens=4)

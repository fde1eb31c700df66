"""HF checkpoint conversion (port of ``models/convert_hf.py``): HF weights
-> the port's param trees.

Two entry points:
  * :func:`from_hf_model` -- convert an in-memory ``transformers`` model
    (used by the CPU tests against tiny random models);
  * :func:`load_checkpoint_dir` -- read ``config.json`` + ``*.safetensors``
    directly, with no ``transformers`` and no ``safetensors`` package: the
    files are read by :func:`read_safetensors`, a memory-mapped numpy view
    of their raw bytes, and each weight goes straight onto the device.

HF linear weights are ``[out, in]``; ours are ``[in, out]`` -- transposed
here once at conversion (on the device, into a contiguous tensor).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .bloom import BloomConfig, bloom_forward
from .llama import LlamaConfig, llama_forward
from .opt import OPTConfig, opt_forward

# safetensors dtype codes -> numpy (the ``safetensors.numpy`` table).  BF16
# is looked up by name, as ``safe_open(framework="numpy")`` does: numpy
# knows it only once ``ml_dtypes`` is loaded, and raises TypeError without it
_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "U64": np.uint64, "I32": np.int32, "U32": np.uint32,
    "I16": np.int16, "U16": np.uint16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_, "C64": np.complex64,
}


def _np_dtype(code: str) -> np.dtype:
    if code == "BF16":
        return np.dtype("bfloat16")
    if code not in _DTYPES:
        raise TypeError(f"safetensors dtype {code!r} has no numpy type")
    return np.dtype(_DTYPES[code])


def read_safetensors(path) -> Dict[str, np.ndarray]:
    """``{name: array}`` of one ``.safetensors`` file, as
    ``safe_open(path, framework="numpy")`` gives them.

    The format: an 8-byte little-endian header length, a JSON header
    ``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (and an
    optional ``"__metadata__"``), then the raw little-endian bytes.  Each
    array is a view of a copy-on-write memory map: nothing is read before
    it is used, and a caller's writes never reach the file.
    """
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (no header length)")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the file's end")
        header = json.loads(f.read(n))
    start = 8 + n
    raw = np.memmap(path, dtype=np.uint8, mode="c") if size > start else np.zeros(0, np.uint8)
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _np_dtype(info["dtype"])
        shape = tuple(int(d) for d in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= size - start or end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end}, "
                             f"which do not hold {shape} {info['dtype']}")
        out[name] = raw[start + begin:start + end].view(dtype).reshape(shape)
    return out


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    """numpy array -> ``dtype`` tensor on ``device``: the array is moved in
    its own dtype and converted there."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device).to(dtype)


def _lin(sd: Dict[str, np.ndarray], prefix: str, dtype, device) -> Dict[str, Any]:
    w = _tensor(sd[prefix + ".weight"], dtype, device).t().contiguous()
    b = sd.get(prefix + ".bias")
    return {"w": w, "b": _tensor(b, dtype, device) if b is not None else None}


def _ln(sd, prefix, dtype, device):
    return {
        "w": _tensor(sd[prefix + ".weight"], dtype, device),
        "b": _tensor(sd[prefix + ".bias"], dtype, device),
    }


# ----------------------------------------------------------------- llama

def llama_config_from_hf(c) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=c.vocab_size,
        hidden_size=c.hidden_size,
        intermediate_size=c.intermediate_size,
        num_layers=c.num_hidden_layers,
        num_heads=c.num_attention_heads,
        num_kv_heads=getattr(c, "num_key_value_heads", c.num_attention_heads),
        head_dim=getattr(c, "head_dim", None),
        max_position_embeddings=c.max_position_embeddings,
        rms_norm_eps=c.rms_norm_eps,
        rope_theta=getattr(c, "rope_theta", 10000.0),
        tie_word_embeddings=getattr(c, "tie_word_embeddings", False),
    )


def convert_llama(sd: Dict[str, np.ndarray], cfg: LlamaConfig, dtype=torch.float32,
                  device=None):
    device = resolve_device(device)
    pre = "model."
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{pre}layers.{i}."
        layers.append({
            "input_norm": _tensor(sd[lp + "input_layernorm.weight"], dtype, device),
            "q": _lin(sd, lp + "self_attn.q_proj", dtype, device),
            "k": _lin(sd, lp + "self_attn.k_proj", dtype, device),
            "v": _lin(sd, lp + "self_attn.v_proj", dtype, device),
            "o": _lin(sd, lp + "self_attn.o_proj", dtype, device),
            "post_norm": _tensor(sd[lp + "post_attention_layernorm.weight"], dtype, device),
            "gate": _lin(sd, lp + "mlp.gate_proj", dtype, device),
            "up": _lin(sd, lp + "mlp.up_proj", dtype, device),
            "down": _lin(sd, lp + "mlp.down_proj", dtype, device),
        })
    params = {
        "embed": _tensor(sd[pre + "embed_tokens.weight"], dtype, device),
        "layers": layers,
        "final_norm": _tensor(sd[pre + "norm.weight"], dtype, device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _lin(sd, "lm_head", dtype, device)
    return params


# ------------------------------------------------------------------- opt

def opt_config_from_hf(c) -> OPTConfig:
    return OPTConfig(
        vocab_size=c.vocab_size,
        hidden_size=c.hidden_size,
        ffn_dim=c.ffn_dim,
        num_layers=c.num_hidden_layers,
        num_heads=c.num_attention_heads,
        max_position_embeddings=c.max_position_embeddings,
        do_layer_norm_before=c.do_layer_norm_before,
    )


def convert_opt(sd: Dict[str, np.ndarray], cfg: OPTConfig, dtype=torch.float32, device=None):
    device = resolve_device(device)
    pre = "model.decoder."
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{pre}layers.{i}."
        layers.append({
            "attn_norm": _ln(sd, lp + "self_attn_layer_norm", dtype, device),
            "q": _lin(sd, lp + "self_attn.q_proj", dtype, device),
            "k": _lin(sd, lp + "self_attn.k_proj", dtype, device),
            "v": _lin(sd, lp + "self_attn.v_proj", dtype, device),
            "o": _lin(sd, lp + "self_attn.out_proj", dtype, device),
            "final_norm": _ln(sd, lp + "final_layer_norm", dtype, device),
            "fc1": _lin(sd, lp + "fc1", dtype, device),
            "fc2": _lin(sd, lp + "fc2", dtype, device),
        })
    params = {
        "embed": _tensor(sd[pre + "embed_tokens.weight"], dtype, device),
        "embed_pos": _tensor(sd[pre + "embed_positions.weight"], dtype, device),
        "layers": layers,
    }
    # post-LN OPT variants (e.g. 350m) have no top-level final layer norm
    if pre + "final_layer_norm.weight" in sd:
        params["final_norm"] = _ln(sd, pre + "final_layer_norm", dtype, device)
    return params


# ----------------------------------------------------------------- bloom

def bloom_config_from_hf(c) -> BloomConfig:
    return BloomConfig(
        vocab_size=c.vocab_size,
        hidden_size=c.hidden_size,
        num_layers=c.n_layer,
        num_heads=c.n_head,
        layer_norm_eps=getattr(c, "layer_norm_epsilon", 1e-5),
    )


def _split_bloom_qkv(w_fused, b_fused, cfg: BloomConfig, dtype, device=None):
    """Fused [3H, H] qkv with per-head [heads, 3, hd] layout -> 3 linears."""
    device = resolve_device(device)
    h, hd = cfg.hidden_size, cfg.hd
    wt = np.asarray(w_fused).T.reshape(h, cfg.num_heads, 3, hd)  # [in, heads, 3, hd]
    bt = np.asarray(b_fused).reshape(cfg.num_heads, 3, hd)
    out = []
    for j in range(3):
        wj = wt[:, :, j, :].reshape(h, h)
        bj = bt[:, j, :].reshape(h)
        out.append({"w": _tensor(wj, dtype, device), "b": _tensor(bj, dtype, device)})
    return out


def convert_bloom(sd: Dict[str, np.ndarray], cfg: BloomConfig, dtype=torch.float32,
                  device=None):
    device = resolve_device(device)
    pre = "transformer."
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{pre}h.{i}."
        q, k, v = _split_bloom_qkv(
            sd[lp + "self_attention.query_key_value.weight"],
            sd[lp + "self_attention.query_key_value.bias"],
            cfg, dtype, device,
        )
        layers.append({
            "attn_norm": _ln(sd, lp + "input_layernorm", dtype, device),
            "q": q, "k": k, "v": v,
            "o": _lin(sd, lp + "self_attention.dense", dtype, device),
            "post_norm": _ln(sd, lp + "post_attention_layernorm", dtype, device),
            "fc1": _lin(sd, lp + "mlp.dense_h_to_4h", dtype, device),
            "fc2": _lin(sd, lp + "mlp.dense_4h_to_h", dtype, device),
        })
    return {
        "embed": _tensor(sd[pre + "word_embeddings.weight"], dtype, device),
        "embed_norm": _ln(sd, pre + "word_embeddings_layernorm", dtype, device),
        "layers": layers,
        "final_norm": _ln(sd, pre + "ln_f", dtype, device),
    }


# ------------------------------------------------------------ entry points

FAMILIES: Dict[str, Tuple[Callable, Callable, Callable]] = {
    "llama": (llama_config_from_hf, convert_llama, llama_forward),
    "opt": (opt_config_from_hf, convert_opt, opt_forward),
    "bloom": (bloom_config_from_hf, convert_bloom, bloom_forward),
}


def _family(family: str):
    if family not in FAMILIES:
        raise ValueError(f"unsupported model family {family!r}")
    return FAMILIES[family]


def from_hf_model(model, dtype=torch.float32, device=None):
    """transformers model -> (cfg, params, forward_fn), params on ``device``."""
    cfg_fn, conv_fn, fwd = _family(model.config.model_type)
    cfg = cfg_fn(model.config)
    sd = {k: v.detach().cpu().float().numpy() for k, v in model.state_dict().items()}
    return cfg, conv_fn(sd, cfg, dtype, device), fwd


def load_checkpoint_dir(path: str, dtype=torch.bfloat16, device=None):
    """safetensors checkpoint dir -> (cfg, params, forward_fn), params on
    ``device`` (the card unless named); no ``transformers``, no
    ``safetensors``."""
    device = resolve_device(device)
    p = Path(path)
    hf_cfg = json.loads((p / "config.json").read_text())

    class _Cfg:
        def __init__(self, d):
            self.__dict__.update(d)

    cfg_fn, conv_fn, fwd = _family(hf_cfg["model_type"])
    cfg = cfg_fn(_Cfg(hf_cfg))

    sd: Dict[str, np.ndarray] = {}
    for f in sorted(p.glob("*.safetensors")):
        sd.update(read_safetensors(f))
    return cfg, conv_fn(sd, cfg, dtype, device), fwd

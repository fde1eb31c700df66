"""Packed-artifact serialization (port of ``quantize/artifact.py``).

A model is quantized once and served many times: the whole params tree
(dense tensors and packed :class:`QuantizedTensor` s) goes to one
``params.npz`` plus a ``manifest.json`` describing the tree, the model
config and the quant specs.  The format is the JAX package's, version 2,
byte for byte: the same keys in the same walk order, written by numpy's
``savez_compressed`` machinery, and the manifest by ``json.dumps(...,
indent=2)``.

bfloat16 tensors are stored as the JAX package stores them through
``ml_dtypes``: their 16 bits under the npy descr ``'<V2'``.  Numpy
without ``ml_dtypes`` reads such an array as the void type ``V2``, which
``interop.tensor_from_numpy`` reinterprets as bfloat16 (the only 2-byte
void type the format holds).
"""

from __future__ import annotations

import dataclasses
import json
import zipfile
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..config import AlignSpec, FloatFormat, QuantSpec
from ..device import resolve_device
from ..interop import tensor_from_numpy
from .qtensor import QuantizedTensor

# v2: 3-bit packing is the s21 layout (2-bit quads + MSB plane)
_FORMAT_VERSION = 2
_BF16_DESCR = "<V2"  # what ml_dtypes' bfloat16 writes


def _spec_to_dict(spec: QuantSpec) -> dict:
    return dataclasses.asdict(spec)


def _spec_from_dict(d: dict) -> QuantSpec:
    d = dict(d)
    if d.get("float_format"):
        d["float_format"] = FloatFormat(**d["float_format"])
    if d.get("align"):
        d["align"] = AlignSpec(**d["align"])
    return QuantSpec(**d)


def _to_numpy(a) -> Tuple[np.ndarray, str]:
    """(host array, dtype name as the JAX package writes it); a bfloat16
    tensor becomes its 16 bits as ``uint16``."""
    if not torch.is_tensor(a):
        a = np.asarray(a)
        return a, str(a.dtype)
    a = a.detach().cpu().contiguous()
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = a.numpy()
    return a, str(a.dtype)


def _write_npy(fid, arr: np.ndarray, bf16: bool) -> None:
    """``np.lib.format.write_array``, with the descr ``'<V2'`` for bf16 bits."""
    if not bf16:
        np.lib.format.write_array(fid, arr, allow_pickle=True)
        return
    np.lib.format.write_array_header_1_0(
        fid, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
    # the data in write_array's own chunks
    buffersize = max(16 * 1024**2 // arr.itemsize, 1)
    for chunk in np.nditer(arr, flags=["external_loop", "buffered", "zerosize_ok"],
                           buffersize=buffersize, order="C"):
        fid.write(chunk.tobytes("C"))


def _savez_compressed(path: Path, arrays: Dict[str, Tuple[np.ndarray, bool]]) -> None:
    """``np.savez_compressed(path, **arrays)`` (its zip calls exactly)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_DEFLATED,
                         allowZip64=True) as zipf:
        for key, (arr, bf16) in arrays.items():
            with zipf.open(key + ".npy", "w", force_zip64=True) as fid:
                _write_npy(fid, arr, bf16)


def save_artifact(path: str, family: str, cfg, params: Dict[str, Any]) -> None:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    arrays: Dict[str, Tuple[np.ndarray, bool]] = {}
    manifest: Dict[str, Any] = {
        "version": _FORMAT_VERSION,
        "family": family,
        "config": dataclasses.asdict(cfg),
        "nodes": {},
    }

    def put(key, a):
        arr, dtype = _to_numpy(a)
        arrays[key] = (arr, dtype == "bfloat16")
        return dtype

    def walk(node, key):
        if isinstance(node, QuantizedTensor):
            manifest["nodes"][key] = {
                "type": "qtensor",
                "spec": _spec_to_dict(node.spec),
                "shape": list(node.shape),
                "mode": node.mode,
                "k_shards": node.k_shards,
                "n_pad": node.n_pad,
                "k_pad": node.k_pad,
                "has_zeros": node.zeros is not None,
                "has_codebook": node.codebook is not None,
            }
            put(key + ".qweight", node.qweight)
            put(key + ".scales", node.scales)
            if node.zeros is not None:
                put(key + ".zeros", node.zeros)
            if node.codebook is not None:
                put(key + ".codebook", node.codebook)
            return
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "name":
                    continue
                walk(v, f"{key}.{k}" if key else k)
            return
        if isinstance(node, list):
            manifest["nodes"].setdefault("__lists__", {})[key] = len(node)
            for i, v in enumerate(node):
                walk(v, f"{key}.{i}")
            return
        if node is None:
            return
        manifest["nodes"][key] = {"type": "array", "dtype": put(key, node)}

    walk(params, "")
    _savez_compressed(p / "params.npz", arrays)
    (p / "manifest.json").write_text(json.dumps(manifest, indent=2))


def load_artifact(path: str, dtype=None, device=None) -> Tuple[str, Any, Dict[str, Any]]:
    """Returns (family, cfg, params) with every tensor on ``device`` (the
    card unless named).  ``dtype`` casts the floating dense arrays (not
    the packed artifacts' fields)."""
    device = resolve_device(device)
    p = Path(path)
    manifest = json.loads((p / "manifest.json").read_text())
    if manifest.get("version", 1) != _FORMAT_VERSION:
        raise ValueError(
            f"artifact format v{manifest.get('version', 1)} != "
            f"v{_FORMAT_VERSION}; re-run quantization (the sub-byte packing "
            "layout changed)")
    family = manifest["family"]
    from ..models import BloomConfig, LlamaConfig, OPTConfig

    cfg_cls = {"llama": LlamaConfig, "opt": OPTConfig, "bloom": BloomConfig}[family]
    cfg_fields = {f.name for f in dataclasses.fields(cfg_cls)}
    cfg = cfg_cls(**{k: v for k, v in manifest["config"].items() if k in cfg_fields})

    nodes = manifest["nodes"]
    lists = nodes.get("__lists__", {})
    root: Dict[str, Any] = {}

    def ensure(parts):
        cur = root
        for i, part in enumerate(parts[:-1]):
            nxt_is_list = ".".join(parts[: i + 1]) in lists
            if isinstance(cur, list):
                part = int(part)
                while len(cur) <= part:
                    cur.append({})
                if nxt_is_list and not isinstance(cur[part], list):
                    cur[part] = []
                cur = cur[part]
            else:
                if part not in cur:
                    cur[part] = [] if nxt_is_list else {}
                cur = cur[part]
        return cur

    def assign(key, value):
        parts = key.split(".")
        cur = ensure(parts)
        if isinstance(cur, list):
            idx = int(parts[-1])
            while len(cur) <= idx:
                cur.append(None)
            cur[idx] = value
        else:
            cur[parts[-1]] = value

    floating = (torch.float32, torch.float16, torch.bfloat16)
    with np.load(p / "params.npz") as data:
        for key, info in nodes.items():
            if key == "__lists__":
                continue
            if info["type"] == "qtensor":
                def opt(name, present):
                    return tensor_from_numpy(data[key + name], device) if present else None

                assign(key, QuantizedTensor(
                    tensor_from_numpy(data[key + ".qweight"], device),
                    tensor_from_numpy(data[key + ".scales"], device),
                    opt(".zeros", info["has_zeros"]),
                    opt(".codebook", info["has_codebook"]),
                    _spec_from_dict(info["spec"]),
                    tuple(info["shape"]),
                    info["mode"],
                    info.get("k_shards", 1),
                    info.get("n_pad", 0),
                    info.get("k_pad", 0),
                ))
            else:
                arr = tensor_from_numpy(data[key], device)
                if dtype is not None and arr.dtype in floating:
                    arr = arr.to(dtype)
                assign(key, arr)

    # linear dicts saved without an explicit b=None: restore the None biases
    def fix_linears(node):
        if isinstance(node, dict):
            if "w" in node and "b" not in node:
                node["b"] = None
            for v in node.values():
                fix_linears(v)
        elif isinstance(node, list):
            for v in node:
                fix_linears(v)

    fix_linears(root)
    return family, cfg, root

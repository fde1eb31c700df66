"""Inference engine (port of ``engine/engine.py``): batched ``generate``
and continuous-batching ``serve``.

``generate``: left-padded batched prefill, in chunks of
``EngineConfig.prefill_chunk`` tokens, then decode steps; greedy,
temperature or top-k sampling.  ``serve``: Orca-style continuous batching
over a request queue with slot-local KV timelines, prefill waves that
decode-ready slots ride along in, and ``chunk`` decode steps on the device
between two host syncs.

The JAX package's jitted decode programs ``_generate_chunk``,
``_serve_chunk`` and ``_serve_combo`` are plain functions here, the eager
bodies, in which nothing reads a device value on the host between two host
syncs.  On a CUDA device the engine runs each as a CUDA graph
(``engine/graphs.py``): captured once per key (JAX's static arguments and
the body's shapes) and replayed for every later chunk with that key, over
buffers that stay put: the engine keeps one cache set per batch size and
resets it in place at the start of each call, keeps one generator and
re-seeds it per call, and ``generate``'s shared timeline is a 0-d device
tensor, as the JAX engine's ``cur_j``.  By an explicit rule the eager
bodies run instead on the CPU (the plain path, as a kernel's plain
version is) and under a rank mesh (gloo collectives of CUDA tensors go
through host memory and cannot be captured; NCCL ranks have not been run
under graphs).  ``generate``'s chunked ``_prefill`` stays eager on every
device: its shapes follow each prompt length and each is used once (JAX
compiles it per length too).

``EngineConfig.activation_bits`` (8 or 16) runs every linear of the
decode steps through the int-activation kernels, and
``prefill_activation_bits`` (default: the same) those of ``generate``'s
prefill and ``serve``'s waves, by the ambient ``activation_quant`` setting
around each phase, as the reference does.

KV caches: contiguous 16-bit, quantized int8/int4 (``KVCacheConfig.kv_bits``)
and paged (``KVCacheConfig.paged``), 16-bit or quantized.  Under paging
``serve`` owns the page allocator and sends the page table to the device
inside the sync's one packed meta copy.

The scan path: a forward marked by ``models.common.scan_forward`` (the
LLaMA, OPT and BLOOM ``*_forward_scan``) runs layer-stacked params
(``params["layers_stacked"]``; flat params are stacked here, after the
projections are fused) with ONE stacked contiguous cache view, 16-bit or
quantized; paged caches raise on it, as in the reference.

Parallelism (``EngineConfig.mesh``, ``tp_block``): one process a rank,
joined by ``torch.distributed`` (``parallel.mesh``).  Over the model axis
every rank holds its shard of the params and runs the rank-per-shard
tensor-parallel forward (``parallel.tp_block``: row-parallel linears
repacked to ``k_shards=d``, LLaMA's q|k|v and gate|up fused shard-blocked,
all-reduces after the row-parallel linears, the lm_head's logits
all-gathered), with caches of the rank's ``heads / d`` KV heads, paged ones
included; the same forward serves ``tp_block=False`` (the JAX package's
GSPMD route has no torch counterpart) and ``tp_block=True`` on one rank.
Over the data axis the prompts (``generate``) or requests (``serve``) are
split between the data ranks, and every rank gets all outputs back in the
caller's order.  ``serve``'s ``stats`` are those of the rank's own share.
"""

from __future__ import annotations

import functools
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import EngineConfig
from ..device import resolve_device
from ..models.common import first_cache as _cache0
from ..models.common import is_scan_forward, stacked_depth
from ..ops.qmatmul import activation_quant
from .graphs import ChunkGraphs, graph_key
from .kvcache import (
    PageAllocator,
    PagedKVCacheView,
    cache_max_len,
    make_caches,
    make_stacked_caches,
    pages_per_seq,
    pool_pages,
    reset_caches,
)


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float, top_k: int = 0) -> torch.Tensor:
    """logits [B, V] -> tokens [B] (int64).

    Greedy (``temperature <= 0``) takes the first maximum, as ``jnp.argmax``
    does.  Sampling draws from ``generator``; its numbers differ from
    ``jax.random``'s, so only greedy tokens match the JAX engine.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    if top_k > 0:
        thresh = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < thresh, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _prefill(params, tokens, positions, mask, caches, forward, cfg, abits=None):
    with activation_quant(abits):
        logits, caches = forward(params, tokens, cfg, caches=caches,
                                 positions=positions, attn_mask=mask)
    return logits[:, -1], caches


def _stamp_timeline(caches, cur: torch.Tensor):
    """``generate``'s shared timeline ``cur`` (a 0-d device tensor) as the
    length of every view: 0-d on the contiguous views, ``[B]`` on the paged
    ones, one entry a layer on the stacked view."""
    if _is_view_list(caches):
        return [c._replace(length=cur.expand(c.page_table.shape[0])
                           if isinstance(c, PagedKVCacheView) else cur) for c in caches]
    return caches._replace(length=(cur,) * len(caches.length))


def _generate_chunk(params, tok0, pads, cur0, caches, generator, forward, cfg,
                    temperature, top_k, t_max, c, abits=None):
    """``c`` decode steps on the shared left-padded timeline, with no host
    sync: the timeline ``cur0`` is a 0-d device tensor, stamped on the
    caches as their length.  Returns ([B, c] sampled tokens on the device,
    caches)."""
    caches = _stamp_timeline(caches, cur0)
    cols = torch.arange(t_max, device=tok0.device)
    tok = tok0
    sampled = []
    for i in range(c):
        cur = cur0 + i
        positions = (cur - pads)[:, None]
        mask = ((cols[None, None, None, :] <= cur)
                & (cols[None, None, None, :] >= pads[:, None, None, None]))
        with activation_quant(abits):
            logits, caches = forward(params, tok, cfg, caches=caches,
                                     positions=positions, attn_mask=mask)
        nxt = sample_tokens(logits[:, -1], generator, temperature, top_k)
        sampled.append(nxt)
        tok = nxt[:, None]
    return torch.stack(sampled, dim=1), caches


def _tokens_of(program, *args, **kw) -> torch.Tensor:
    """The sampled tokens of a decode program (not the caches it returns:
    the engine passes its kept views to every chunk, and each chunk stamps
    their lengths anew)."""
    return program(*args, **kw)[0]


def _is_view_list(caches) -> bool:
    """A per-layer list of views, not one (stacked) view."""
    return _cache0(caches) is not caches


def _stamp(caches, lens: torch.Tensor, valid: Optional[torch.Tensor],
           page_table: Optional[torch.Tensor] = None):
    """Set the per-slot lengths ``[B]``, ``valid`` and (paged caches) the
    page table ``[B, MP]`` on every layer's view, or on the one stacked
    view, whose lengths become ``[L, B]``: ``lens`` once a layer (a tuple,
    see ``kvcache._stacked_update_and_fetch``), while ``valid`` stays
    ``[B]``, shared by the layers.

    All three are slices of the one meta vector copied to the device per
    sync, so no per-layer host->device copy is made.
    """
    upd = {"length": lens, "valid": valid}
    if page_table is not None:
        upd["page_table"] = page_table
    if _is_view_list(caches):
        return [c._replace(**upd) for c in caches]
    upd["length"] = (lens,) * len(caches.length)
    return caches._replace(**upd)


def _take_table(meta: torch.Tensor, ns: int, mp: int):
    """(meta without its trailing page table, the table [ns, mp] or None)."""
    if not mp:
        return meta, None
    return meta[: -ns * mp], meta[-ns * mp :].reshape(ns, mp)


def _clear_valid(caches):
    """valid=None on every view (per-slot partial-write scope ends)."""
    if _is_view_list(caches):
        return [c._replace(valid=None) for c in caches]
    return caches._replace(valid=None)


def _serve_steps(params, tok, caches, lens, feed_next, feed_len, generator,
                 forward, cfg, temperature, top_k, cols, t_max, c, abits=None):
    """``c`` decode steps on slot-local timelines, with no host sync.

    Per step, each slot's next input is its queued prompt token while its
    prompt is still streaming (``i + 1 < feed_len``), else the token just
    sampled: the device-side mirror of the host's per-token bookkeeping.
    Returns ([B, c] sampled tokens on the device, caches).
    """
    sampled = []
    for i in range(c):
        lens_c = torch.clamp(lens, max=t_max - 1)
        positions = lens_c[:, None]
        mask = cols[None, None, None, :] <= lens_c[:, None, None, None]
        with activation_quant(abits):
            logits, caches = forward(params, tok, cfg, caches=caches,
                                     positions=positions, attn_mask=mask)
        nxt = sample_tokens(logits[:, -1], generator, temperature, top_k)
        sampled.append(nxt)
        tok = torch.where(feed_len > i + 1, feed_next[:, i], nxt)[:, None]
        lens = lens + 1
    return torch.stack(sampled, dim=1), caches


def _serve_chunk(params, meta, caches, generator, forward, cfg, temperature,
                 top_k, t_max, c, abits=None, mp=0):
    """``c`` decode steps between two host syncs (continuous batching).

    ``meta`` packs [tok0 | feed_next.ravel | feed_len | lens0] into ONE int
    vector on the device (one host->device copy per sync), followed under
    paging by the page table ``[ns, mp]``.  Returns the [B, c] sampled
    tokens; the host decides which are real outputs.
    """
    ns = meta.shape[0] // (c + 3 + mp)
    meta, table = _take_table(meta, ns, mp)
    tok0 = meta[:ns][:, None]
    feed_next = meta[ns : ns + ns * c].reshape(ns, c)
    feed_len = meta[ns + ns * c : 2 * ns + ns * c]
    lens0 = meta[2 * ns + ns * c :]
    caches = _stamp(caches, lens0, None, table)
    cols = torch.arange(t_max, device=meta.device)
    return _serve_steps(params, tok0, caches, lens0, feed_next, feed_len,
                        generator, forward, cfg, temperature, top_k, cols,
                        t_max, c, abits)


def _serve_combo(params, meta, caches, generator, forward, cfg, temperature,
                 top_k, t_max, s_len, c, abits=None, p_abits=None, mp=0):
    """One prefill wave (under ``p_abits``) + ``c`` decode steps (under
    ``abits``) between two host syncs.

    The wave feeds each slot's pending prompt tokens ([B, S] right-padded,
    per-slot ``valid``); decode-ready slots ride along as 1-valid-token
    columns (Orca).  The chunk then decodes ``c`` further tokens for every
    slot, starting from ``where(tok_src, wave_sample, tok0_else)``: the host
    sets ``tok_src`` where a slot's prompt completes in the wave; a slot
    with prompt left starts from its next prompt token and streams the rest
    through the chunk's feed (``_serve_chunk`` conventions).

    ``meta`` packs [toks.ravel | n_valid | lens0 | tok_src | tok0_else |
    feed_next.ravel | feed_len] into ONE int vector, followed under paging
    by the page table ``[ns, mp]``, and the wave sample rides as column 0
    of the returned [B, 1 + c] tensor (one fetch).
    """
    ns = meta.shape[0] // (s_len + c + 5 + mp)
    meta, table = _take_table(meta, ns, mp)
    off = 0

    def take(count):
        nonlocal off
        v = meta[off : off + count]
        off += count
        return v

    toks = take(ns * s_len).reshape(ns, s_len)
    n_valid = take(ns)
    lens0 = take(ns)
    tok_src = take(ns) != 0
    tok0_else = take(ns)
    feed_next = take(ns * c).reshape(ns, c)
    feed_len = take(ns)

    caches = _stamp(caches, lens0, n_valid, table)
    dev = meta.device
    cols = torch.arange(t_max, device=dev)
    lens_c = torch.clamp(lens0, max=t_max - 1)
    positions = torch.clamp(lens_c[:, None] + torch.arange(s_len, device=dev)[None, :],
                            max=t_max - 1)
    mask = cols[None, None, None, :] <= positions[:, None, :, None]
    with activation_quant(p_abits):
        logits, caches = forward(params, toks, cfg, caches=caches,
                                 positions=positions, attn_mask=mask)
    idx = torch.clamp(n_valid - 1, 0, s_len - 1)
    last = torch.take_along_dim(logits, idx[:, None, None], dim=1)[:, 0]
    wave_tok = sample_tokens(last, generator, temperature, top_k)

    # chunk phase: lengths advanced by the wave's valid counts; every chunk
    # step writes one token per slot.  The flat per-layer views consumed
    # their valid on write; the reference's stacked view keeps it, so the
    # scope is ended here either way
    caches = _clear_valid(caches)
    tok0 = torch.where(tok_src, wave_tok, tok0_else)[:, None]
    sampled, caches = _serve_steps(params, tok0, caches, lens0 + n_valid,
                                   feed_next, feed_len, generator, forward,
                                   cfg, temperature, top_k, cols, t_max, c, abits)
    return torch.cat([wave_tok[:, None], sampled], dim=1), caches


class InferenceEngine:
    """Batch generation over a (possibly quantized, possibly sharded) model."""

    def __init__(
        self,
        params: Dict[str, Any],
        cfg,
        forward: Callable,
        family: Optional[str] = None,
        engine_cfg: EngineConfig = EngineConfig(),
        eos_token: int = -1,
        pad_token: int = 0,
        dtype=torch.float32,
        tp_block: bool = False,
        device=None,
    ):
        if "layers" not in params and "layers_stacked" not in params:
            raise ValueError("params hold neither 'layers' nor 'layers_stacked'")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.forward = forward
        self.engine_cfg = engine_cfg
        self.eos_token = eos_token
        self.pad_token = pad_token
        self.dtype = dtype
        self.mesh = None
        if engine_cfg.mesh.ndevices > 1 or tp_block:
            if family is None:
                raise ValueError("family required for sharded engines")
            from ..parallel.mesh import make_mesh

            self.mesh = make_mesh(engine_cfg.mesh, self.device)
        # one generator, re-seeded per call, and one cache set per batch
        # size, reset in place per call: the buffers the CUDA graphs read
        self._generator = torch.Generator(device=self.device)
        self._cache_sets: Dict[int, Any] = {}
        # the decode programs run as CUDA graphs on a card, and as their
        # eager bodies on the CPU and under a rank mesh (module docstring)
        self._graphs = None
        if self.device.type == "cuda" and self.mesh is None:
            self._graphs = ChunkGraphs(self.device, self._generator)
        if self.mesh is not None:
            if self.mesh.model > 1 or tp_block:
                self.params = self._tensor_parallel(params, forward, family)
                return
        if engine_cfg.fuse_projections and family is None:
            warnings.warn(
                "EngineConfig.fuse_projections is set but family is None: "
                "the fused qkv/gate_up path only applies with family='llama'",
                stacklevel=2)
        if engine_cfg.fuse_projections and family == "llama" and "layers" in params:
            # stacked params cannot be fused here: fuse each layer before
            # stacking (fuse_llama_layer); the stacked views keep the fusion
            from ..models.llama import fuse_llama_projections

            params = fuse_llama_projections(params)
        if "layers" in params and is_scan_forward(forward):
            # flat params with a scan forward: stack them here, after the
            # fusion above (the caller's tree is not consumed)
            from ..models.common import stack_model_layers

            params = stack_model_layers(params)
        self.params = params

    def _tensor_parallel(self, params, forward, family: str):
        """This rank's shard of TP-prepared params, and the rank-per-shard
        forward in ``self.forward`` (JAX engine ``tp_block`` branch)."""
        from ..parallel import tp_block as tpb
        from ..parallel.sharding import apply_sharding, param_specs

        d = self.mesh.model
        stacked = "layers_stacked" in params or is_scan_forward(forward)
        # built first: it refuses head counts that do not divide d
        self.forward = tpb.make_tp_forward(self.cfg, self.mesh, family, stacked)
        fuse = self.engine_cfg.fuse_projections
        if "layers_stacked" in params:
            # stacked params cannot be repacked or fused in place: they must
            # arrive TP-prepared (parallel.tp_block.prepare_tp_stacked)
            tpb.validate_tp_stacked(params, d, family)
        elif stacked:
            params = tpb.prepare_tp_stacked(params, d, fuse=fuse, family=family)
        else:
            # row-parallel artifacts repacked to k_shards=d (each rank's row
            # slice self-contained, in whole quantization groups), LLaMA's
            # projections fused shard-blocked
            params = {**params, "layers": [tpb.tp_prepare_layer(p, d, fuse, family=family)
                                           for p in params["layers"]]}
        specs = param_specs(family, params)
        specs["embed"] = ()  # the forwards read the embedding whole
        return apply_sharding(params, specs, self.mesh)

    def _n_kv_heads(self):
        """KV heads of this rank's caches: its ``1/d`` share under TP."""
        n = getattr(self.cfg, "num_kv_heads", getattr(self.cfg, "num_heads"))
        return n // (self.mesh.model if self.mesh is not None else 1)

    def _t_max(self) -> int:
        """The columns of a slot's cache timeline (the caches' ``T_max``)."""
        kv = self.engine_cfg.kv
        return pages_per_seq(kv) * kv.page_size if kv.paged else kv.max_seq_len

    def _over_data(self, run, items, max_new_tokens: int, what: str, **kw):
        """``run(items, ...)`` with the items split over the data ranks
        (rank i takes items i, i + data, ...), the outputs gathered to every
        rank in the items' order.  Refusals are made on the whole list
        first, so that no rank raises while the others wait to gather."""
        if any(len(p) == 0 for p in items):
            raise ValueError("empty prompts are not allowed")
        longest = max(len(p) for p in items)
        if longest + max_new_tokens > self._t_max():
            raise ValueError(f"{what} ({longest} tokens) + max_new ({max_new_tokens}) "
                             f"exceeds kv.max_seq_len ({self._t_max()})")
        from ..parallel.mesh import all_gather_object

        m = self.mesh
        mine = list(items)[m.data_index::m.data]
        outs = run(mine, max_new_tokens=max_new_tokens, **kw) if mine else []
        result: List[Any] = [None] * len(items)
        for i, part in enumerate(all_gather_object(outs, m.data_group)):
            result[i::m.data] = part
        return result

    def _fresh_caches(self, batch: int):
        """Per-layer views for flat params; one stacked view (no paging,
        as in the reference) for layer-stacked ones."""
        args = (batch, self._n_kv_heads(), self.cfg.hd, self.engine_cfg.kv,
                self.dtype, self.device)
        if "layers_stacked" in self.params:
            return make_stacked_caches(stacked_depth(self.params["layers_stacked"]), *args)
        return make_caches(len(self.params["layers"]), *args)

    def _caches(self, batch: int):
        """The engine's cache set for ``batch`` slots, allocated at its
        first use and reset in place at every later one (the KV config and
        the flat or stacked layout are the engine's own): the counterpart
        of the JAX engine's donated caches."""
        caches = self._cache_sets.get(batch)
        if caches is None:
            caches = self._cache_sets[batch] = self._fresh_caches(batch)
        else:
            reset_caches(caches)
        return caches

    def _chunk(self, key, body: Callable[..., torch.Tensor],
               inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One decode program, ``body(**inputs)``: a replay of ``key``'s CUDA
        graph on a card (captured at the key's first use), or the eager
        body where the engine holds no graphs (the CPU, a rank mesh)."""
        if self._graphs is None:
            return body(**inputs)
        return self._graphs.run(key, body, inputs)

    @staticmethod
    def _left_pad(prompts: Sequence[Sequence[int]], pad_token: int):
        lens = np.array([len(p) for p in prompts])
        L = int(lens.max())
        toks = np.full((len(prompts), L), pad_token, np.int64)
        for i, p in enumerate(prompts):
            toks[i, L - len(p):] = np.asarray(p, np.int64)
        pads = L - lens
        return toks, pads, L

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
    ) -> List[List[int]]:
        """Generate continuations; returns newly generated tokens per prompt."""
        if self.mesh is not None and self.mesh.data > 1:
            return self._over_data(self._generate, prompts, max_new_tokens, "prompt",
                                   temperature=temperature, top_k=top_k, seed=seed)
        return self._generate(prompts, max_new_tokens, temperature, top_k, seed)

    def _generate(self, prompts, max_new_tokens, temperature, top_k, seed):
        if any(len(p) == 0 for p in prompts):
            raise ValueError("empty prompts are not allowed")
        dev = self.device
        b = len(prompts)
        toks, pads, L = self._left_pad(prompts, self.pad_token)
        caches = self._caches(b)
        t_max = cache_max_len(_cache0(caches))
        if L + max_new_tokens > t_max:
            raise ValueError(
                f"prompt ({L}) + max_new ({max_new_tokens}) exceeds "
                f"kv.max_seq_len ({t_max})")

        pads_t = torch.as_tensor(pads, dtype=torch.int64, device=dev)
        cols = torch.arange(t_max, device=dev)

        # chunked prefill: bounded activation memory for long prompts; the
        # positions of pad columns are clipped to 0 and masked out
        chunk = max(1, self.engine_cfg.prefill_chunk)
        toks_t = torch.as_tensor(toks, device=dev)
        logits = None
        filled = caches
        for start in range(0, L, chunk):
            end = min(start + chunk, L)
            ar = torch.arange(start, end, device=dev)
            positions = (ar[None, :] - pads_t[:, None]).clamp(min=0)
            mask = ((cols[None, None, None, :] <= ar[None, None, :, None])
                    & (cols[None, None, None, :] >= pads_t[:, None, None, None]))
            logits, filled = _prefill(self.params, toks_t[:, start:end],
                                      positions, mask, filled, self.forward,
                                      self.cfg, self.engine_cfg.prefill_abits())

        generator = self._generator
        generator.manual_seed(seed)
        next_tok = sample_tokens(logits, generator, temperature, top_k)

        first = next_tok.cpu().tolist()
        out = [[t] for t in first]
        done = np.array([t == self.eos_token for t in first])
        # the shared timeline on the device (the JAX engine's cur_j); each
        # chunk stamps it on the kept views as their length
        cur = torch.full((), L, dtype=torch.int64, device=dev)
        chunk_c = max(1, self.engine_cfg.decode_chunk)
        abits = self.engine_cfg.activation_bits
        tok = next_tok[:, None]
        remaining = max_new_tokens - 1
        while remaining > 0 and not done.all():
            step_c = min(chunk_c, remaining)
            key = graph_key("_generate_chunk", forward=self.forward, cfg=self.cfg,
                            temperature=temperature, top_k=top_k, t_max=t_max, c=step_c,
                            abits=abits, batch=b)
            body = functools.partial(_tokens_of, _generate_chunk, self.params, caches=caches,
                                     generator=generator, forward=self.forward, cfg=self.cfg,
                                     temperature=temperature, top_k=top_k, t_max=t_max,
                                     c=step_c, abits=abits)
            sampled = self._chunk(key, body, {"tok0": tok, "pads": pads_t, "cur0": cur})
            cur = cur + step_c
            remaining -= step_c
            toks_np = sampled.cpu().numpy()  # the one host sync per chunk
            for i in range(b):
                for j in range(step_c):
                    if done[i]:
                        break
                    t = int(toks_np[i, j])
                    out[i].append(t)
                    if t == self.eos_token:
                        done[i] = True
            tok = sampled[:, -1:]
        return out

    # ------------------------------------------- continuous batching (Orca)

    @torch.inference_mode()
    def serve(
        self,
        requests: Sequence[Sequence[int]],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        chunk: int = 1,
        stats: Optional[Dict[str, Any]] = None,
    ) -> List[List[int]]:
        """Token-level continuous batching over a request queue.

        Idle slots admit the next queued request.  A slot's prompt goes in
        by prefill waves (``[B, S]`` forwards, ``S`` a power-of-2 bucket of
        at most ``max(8, prefill_chunk)``) in which decode-ready slots ride
        along with their pending token; then ``chunk`` decode steps run on
        the device before the host looks at the tokens.  KV timelines are
        *slot-local*: each slot writes at its own cache column, so a slot
        admitted late starts at column 0 and ``max_seq_len`` bounds each
        request, not the batch's history.

        Each combo (wave + chunk) or pure chunk costs ONE host->device copy
        (a packed meta vector) and ONE device->host copy (the sampled
        tokens).  A slot that finishes inside a chunk computes garbage for
        the rest of it; the host discards it and recycles the slot.

        Under paging (``KVCacheConfig.paged``) this loop owns the page
        allocator: a slot gets pages as its length crosses a page boundary,
        before each wave and each chunk, and returns them when its request
        completes; an idle slot waits for admission while the pool has no
        free page.  The table rides in the sync's meta vector.

        ``stats`` (if given) receives the reference's keys: ``n_combos``,
        ``n_chunks``, ``n_steps``, ``n_generated``, ``n_prompt_fed``,
        ``t_combos_s``, ``t_chunks_s``, and per-request ``ttft_s`` and
        ``tpot_s`` taken at sync granularity (a token is visible to a
        client when the host fetches it).  Under paging also
        ``n_page_allocs`` (pages handed out in all) and ``pages_peak``
        (most pages held at once).
        """
        if self.mesh is not None and self.mesh.data > 1:
            return self._over_data(self._serve, requests, max_new_tokens, "request",
                                   temperature=temperature, top_k=top_k, seed=seed,
                                   chunk=chunk, stats=stats)
        return self._serve(requests, max_new_tokens, temperature, top_k, seed, chunk, stats)

    def _serve(self, requests, max_new_tokens, temperature, top_k, seed, chunk, stats):
        if any(len(r) == 0 for r in requests):
            raise ValueError("empty prompts are not allowed")
        dev = self.device
        nslots = min(self.engine_cfg.max_batch_size, max(1, len(requests)))
        caches = self._caches(nslots)
        t_max = cache_max_len(_cache0(caches))
        for r in requests:
            if len(r) + max_new_tokens > t_max:
                raise ValueError(
                    f"request ({len(r)} tokens) + max_new ({max_new_tokens}) "
                    f"exceeds kv.max_seq_len ({t_max})")

        t_serve0 = time.perf_counter()
        sync_t = [t_serve0]  # wall time of the last device sync (fetch)
        first_tok_t: Dict[int, float] = {}  # request -> first-token time
        done_t: Dict[int, float] = {}       # request -> completion time
        queue = list(range(len(requests)))
        results: Dict[int, List[int]] = {}
        # per-slot state
        slot_req = [-1] * nslots                  # request id
        slot_len = np.zeros(nslots, np.int64)     # slot-local cache column
        slot_fed = np.zeros(nslots, np.int64)     # prompt tokens fed
        slot_gen = np.zeros(nslots, np.int64)     # tokens generated
        pending_tok = np.zeros(nslots, np.int64)  # next token to feed

        generator = self._generator
        generator.manual_seed(seed)

        kv = self.engine_cfg.kv
        paged = kv.paged
        mp = t_max // kv.page_size if paged else 0
        if paged:
            allocator = PageAllocator(pool_pages(nslots, kv))
            slot_pages: List[List[int]] = [[] for _ in range(nslots)]
            table_np = np.zeros((nslots, mp), np.int64)
            if allocator.num_pages < 2:
                # no page beside the garbage page: no request could ever be
                # admitted, and the loop below would never end
                raise ValueError(f"KVCacheConfig.num_pages={allocator.num_pages}: "
                                 "the pool needs a page beside the reserved page 0")
            page_stats = {"n_page_allocs": 0, "pages_peak": 0}

        def note_tok(rid):
            if len(results[rid]) == 1:
                first_tok_t[rid] = sync_t[0]

        def release(s):
            done_t[slot_req[s]] = sync_t[0]
            slot_req[s] = -1
            slot_len[s] = 0
            if paged:
                allocator.free(slot_pages[s])
                slot_pages[s] = []
                table_np[s, :] = 0

        def admit(s):
            rid = queue.pop(0)
            slot_req[s] = rid
            slot_len[s] = 0
            slot_fed[s] = 0
            slot_gen[s] = 0
            results[rid] = []
            pending_tok[s] = requests[rid][0]

        def ensure_pages(last_col):
            """Give every live slot the pages up to column ``last_col[s]``."""
            for s in range(nslots):
                if slot_req[s] < 0:
                    continue
                while len(slot_pages[s]) <= last_col[s] // kv.page_size:
                    pg = allocator.alloc()
                    table_np[s, len(slot_pages[s])] = pg
                    slot_pages[s].append(pg)
                    page_stats["n_page_allocs"] += 1
            page_stats["pages_peak"] = max(page_stats["pages_peak"],
                                           allocator.num_pages - 1 - allocator.free_count)

        def to_device(meta):
            """The one host->device copy of a sync (the page table last)."""
            if paged:
                meta = np.concatenate([meta, table_np.ravel()])
            return torch.from_numpy(meta).to(dev)

        def fetch(out):
            """The one device->host copy of a sync; returns (tokens, dt)."""
            out_np = out.cpu().numpy()
            t_prev, sync_t[0] = sync_t[0], time.perf_counter()
            return out_np, sync_t[0] - t_prev

        chunk = max(1, int(chunk))
        c = chunk
        prefill_cap = max(8, self.engine_cfg.prefill_chunk)
        abits, p_abits = self.engine_cfg.activation_bits, self.engine_cfg.prefill_abits()
        # every chunk gets the kept views; each stamps their lengths, valid
        # counts and page table from its meta vector
        static = dict(caches=caches, generator=generator, forward=self.forward, cfg=self.cfg,
                      temperature=temperature, top_k=top_k, t_max=t_max, c=c, abits=abits,
                      mp=mp)
        keyed = dict(forward=self.forward, cfg=self.cfg, temperature=temperature, top_k=top_k,
                     t_max=t_max, c=c, abits=abits, ns=nslots, mp=mp)
        if stats is not None:
            stats.update(n_combos=0, n_chunks=0, n_steps=0,
                         n_generated=0, n_prompt_fed=0,
                         t_combos_s=0.0, t_chunks_s=0.0)
        while queue or any(r >= 0 for r in slot_req):
            for s in range(nslots):
                if slot_req[s] < 0 and queue and (not paged or allocator.free_count > 0):
                    admit(s)

            remaining = np.array([
                len(requests[slot_req[s]]) - slot_fed[s] if slot_req[s] >= 0
                else 0
                for s in range(nslots)
            ])
            if remaining.max(initial=0) > 0:
                # ---- combo: prefill wave + chunk (one host sync).  Slots
                # with unfed prompt tokens get up to S of them; decode-ready
                # slots ride along with their pending token (valid = 1)
                cap = int(min(remaining.max(), prefill_cap))
                sbkt = 8
                while sbkt < cap:
                    sbkt *= 2
                toks_np = np.zeros((nslots, sbkt), np.int64)
                valid_np = np.zeros(nslots, np.int64)
                piggyback = np.zeros(nslots, bool)
                for s in range(nslots):
                    if slot_req[s] >= 0 and remaining[s] == 0:
                        toks_np[s, 0] = pending_tok[s]
                        valid_np[s] = 1
                        piggyback[s] = True
                        continue
                    cnt = int(min(remaining[s], sbkt))
                    if cnt <= 0:
                        continue
                    rid = slot_req[s]
                    toks_np[s, :cnt] = requests[rid][slot_fed[s] : slot_fed[s] + cnt]
                    valid_np[s] = cnt
                # chunk-phase inputs: slots whose prompt completes in the
                # wave decode from their wave sample (tok_src); slots with
                # prompt left stream it through the chunk's feed
                tok_src = np.zeros(nslots, bool)
                tok0_else = np.zeros(nslots, np.int64)
                feed_next = np.zeros((nslots, c), np.int64)
                feed_len = np.zeros(nslots, np.int64)
                for s in range(nslots):
                    if slot_req[s] < 0:
                        continue
                    if piggyback[s] or remaining[s] <= valid_np[s]:
                        tok_src[s] = True
                    else:
                        rid = slot_req[s]
                        rem = requests[rid][slot_fed[s] + valid_np[s]:]
                        tok0_else[s] = rem[0]
                        nfeed = int(min(len(rem), c))
                        feed_next[s, : max(nfeed - 1, 0)] = rem[1:nfeed]
                        feed_len[s] = nfeed
                lens_np = np.minimum(slot_len, t_max - 1)
                if paged:
                    ensure_pages(np.minimum(lens_np + np.maximum(valid_np, 1) - 1 + c,
                                            t_max - 1))
                if stats is not None:
                    stats["n_combos"] += 1
                    stats["n_steps"] += 1 + c  # wave ~= one step + c chunk
                meta = np.concatenate([
                    toks_np.ravel(), valid_np, lens_np, tok_src.astype(np.int64),
                    tok0_else, feed_next.ravel(), feed_len,
                ])
                out = self._chunk(
                    graph_key("_serve_combo", s_len=sbkt, p_abits=p_abits, **keyed),
                    functools.partial(_tokens_of, _serve_combo, self.params, s_len=sbkt,
                                      p_abits=p_abits, **static),
                    {"meta": to_device(meta)})
                out_np, dt = fetch(out)
                if stats is not None:
                    stats["t_combos_s"] = round(stats["t_combos_s"] + dt, 4)
                wave_np, sampled = out_np[:, 0], out_np[:, 1:]
                # the device advanced every slot by valid + c; releases
                # below reset their slots to 0 (admit() also resets)
                slot_len += valid_np + c
                for s in range(nslots):
                    if valid_np[s] <= 0:
                        continue
                    rid = slot_req[s]
                    if not piggyback[s]:
                        slot_fed[s] += valid_np[s]
                        if stats is not None:
                            stats["n_prompt_fed"] += int(valid_np[s])
                        if slot_fed[s] < len(requests[rid]):
                            continue  # prompt continues via the chunk feed
                    tok = int(wave_np[s])  # next generated token
                    results[rid].append(tok)
                    note_tok(rid)
                    if stats is not None:
                        stats["n_generated"] += 1
                    slot_gen[s] += 1
                    if tok == self.eos_token or slot_gen[s] >= max_new_tokens:
                        release(s)  # its chunk tokens are discarded garbage
                    else:
                        pending_tok[s] = tok
            else:
                # ---- pure decode: prompts all fed, no wave needed.  Idle
                # slots keep writing (and reading) garbage nothing consumes
                # (under paging in the reserved garbage page)
                feed_next = np.zeros((nslots, c), np.int64)
                feed_len = np.zeros(nslots, np.int64)
                lens_np = np.minimum(slot_len, t_max - 1)
                if paged:
                    ensure_pages(np.minimum(lens_np + c - 1, t_max - 1))
                if stats is not None:
                    stats["n_chunks"] += 1
                    stats["n_steps"] += c
                meta = np.concatenate([pending_tok, feed_next.ravel(),
                                       feed_len, lens_np])
                out = self._chunk(
                    graph_key("_serve_chunk", **keyed),
                    functools.partial(_tokens_of, _serve_chunk, self.params, **static),
                    {"meta": to_device(meta)})
                sampled, dt = fetch(out)
                if stats is not None:
                    stats["t_chunks_s"] = round(stats["t_chunks_s"] + dt, 4)
                slot_len += c
            for s in range(nslots):
                rid = slot_req[s]
                if rid < 0:
                    continue
                prompt = requests[rid]
                for i in range(c):
                    if slot_fed[s] < len(prompt):
                        slot_fed[s] += 1
                        if stats is not None:
                            stats["n_prompt_fed"] += 1
                    if slot_fed[s] < len(prompt):
                        continue  # this step consumed a prompt token
                    tok = int(sampled[s, i])
                    results[rid].append(tok)
                    note_tok(rid)
                    if stats is not None:
                        stats["n_generated"] += 1
                    slot_gen[s] += 1
                    if tok == self.eos_token or slot_gen[s] >= max_new_tokens:
                        release(s)  # rest of the chunk is discarded garbage
                        break
                if slot_req[s] >= 0:
                    pending_tok[s] = (prompt[slot_fed[s]] if slot_fed[s] < len(prompt)
                                      else int(sampled[s, c - 1]))
        if stats is not None:
            if paged:
                stats.update(page_stats)
            stats["ttft_s"] = [round(first_tok_t[r] - t_serve0, 4)
                               for r in sorted(first_tok_t)]
            stats["tpot_s"] = [
                round((done_t[r] - first_tok_t[r]) / max(len(results[r]) - 1, 1), 4)
                for r in sorted(done_t) if r in first_tok_t]
        return [results[i] for i in range(len(requests))]

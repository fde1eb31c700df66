"""Inference engine (port of ``engine/engine.py``): batched ``generate``.

Left-padded batched prefill, in chunks of ``EngineConfig.prefill_chunk``
tokens, then decode steps; greedy, temperature or top-k sampling.  PyTorch
runs eagerly, so the JAX package's jitted ``_prefill`` / ``_decode_step`` /
``_generate_chunk`` become plain functions; ``decode_chunk`` keeps its
meaning: that many decode steps run on the device between two host syncs,
with the same tokens as per-token stepping.

Single device only.  Meshes, tensor parallelism, the scan path, quantized
or paged KV caches, activation quantization and ``serve`` are still to be
ported (ROADMAP queue A); asking for them raises.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import EngineConfig
from ..device import resolve_device
from .kvcache import cache_max_len, make_caches


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


def _prefill(params, tokens, positions, mask, caches, forward, cfg):
    logits, caches = forward(params, tokens, cfg, caches=caches,
                             positions=positions, attn_mask=mask)
    return logits[:, -1], caches


def _generate_chunk(params, tok0, pads, cur0, caches, generator, forward, cfg,
                    temperature, top_k, cols, c):
    """``c`` decode steps on the shared left-padded timeline, with no host
    sync.  Returns ([B, c] sampled tokens on the device, caches)."""
    tok = tok0
    sampled = []
    for cur in range(cur0, cur0 + c):
        positions = (cur - pads)[:, None]
        mask = ((cols[None, None, None, :] <= cur)
                & (cols[None, None, None, :] >= pads[:, None, None, None]))
        logits, caches = forward(params, tok, cfg, caches=caches,
                                 positions=positions, attn_mask=mask)
        nxt = sample_tokens(logits[:, -1], generator, temperature, top_k)
        sampled.append(nxt)
        tok = nxt[:, None]
    return torch.stack(sampled, dim=1), caches


class InferenceEngine:
    """Batch generation over a (possibly quantized) model on one device."""

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
        if engine_cfg.mesh.ndevices > 1 or tp_block:
            raise NotImplementedError(
                "multi-device engines (mesh, tp_block) are not ported yet "
                "(ROADMAP queue A, 'Parallelism'); the port runs on one device")
        if engine_cfg.activation_bits is not None \
                or engine_cfg.prefill_activation_bits is not None:
            raise NotImplementedError(
                "activation_bits: the A8/A16 kernels are not ported yet "
                "(ROADMAP queue B)")
        if "layers" not in params:
            raise NotImplementedError(
                "layer-stacked params (the scan path) are not ported yet "
                "(ROADMAP queue A); pass per-layer params under 'layers'")
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
        if engine_cfg.fuse_projections and family is None:
            warnings.warn(
                "EngineConfig.fuse_projections is set but family is None: "
                "the fused qkv/gate_up path only applies with family='llama'",
                stacklevel=2)
        if engine_cfg.fuse_projections and family == "llama":
            from ..models.llama import fuse_llama_projections

            params = fuse_llama_projections(params)
        self.params = params

    def _n_kv_heads(self):
        return getattr(self.cfg, "num_kv_heads", getattr(self.cfg, "num_heads"))

    def _fresh_caches(self, batch: int):
        return make_caches(len(self.params["layers"]), batch, self._n_kv_heads(),
                           self.cfg.hd, self.engine_cfg.kv, self.dtype,
                           self.device)

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
        if any(len(p) == 0 for p in prompts):
            raise ValueError("empty prompts are not allowed")
        dev = self.device
        b = len(prompts)
        toks, pads, L = self._left_pad(prompts, self.pad_token)
        caches = self._fresh_caches(b)
        t_max = cache_max_len(caches[0])
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
        for start in range(0, L, chunk):
            end = min(start + chunk, L)
            ar = torch.arange(start, end, device=dev)
            positions = (ar[None, :] - pads_t[:, None]).clamp(min=0)
            mask = ((cols[None, None, None, :] <= ar[None, None, :, None])
                    & (cols[None, None, None, :] >= pads_t[:, None, None, None]))
            logits, caches = _prefill(self.params, toks_t[:, start:end],
                                      positions, mask, caches, self.forward,
                                      self.cfg)

        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        next_tok = sample_tokens(logits, generator, temperature, top_k)

        first = next_tok.cpu().tolist()
        out = [[t] for t in first]
        done = np.array([t == self.eos_token for t in first])
        cur = L
        chunk_c = max(1, self.engine_cfg.decode_chunk)
        tok = next_tok[:, None]
        remaining = max_new_tokens - 1
        while remaining > 0 and not done.all():
            step_c = min(chunk_c, remaining)
            sampled, caches = _generate_chunk(
                self.params, tok, pads_t, cur, caches, generator,
                self.forward, self.cfg, temperature, top_k, cols, step_c)
            cur += step_c
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

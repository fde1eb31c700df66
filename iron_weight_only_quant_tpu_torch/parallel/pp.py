"""Pipeline parallelism: GPipe micro-batching over stage ranks (port of
``parallel/pp.py``).

Layer params are stacked ``[n_stages, L/n_stages, ...]``
(:func:`stage_stack_llama_layers`); rank s keeps stage s's ``[L/S, ...]``
slice (:func:`pp_param_specs` with ``sharding.apply_sharding``) and runs it
through the stacked kernels.  Micro-batches pass from stage to stage by
``send``/``recv``: stage s takes micro-batch m from stage s-1 (stage 0 from
the embedding), runs its layers and sends the result on, so every stage
works on another micro-batch once the pipeline is full.  The stages are
the ranks of the mesh's model axis.

Scope, as in the JAX package: the batch-scoring forward (perplexity,
prefill, calibration) with no KV cache; decode stays on the
tensor-parallel engine.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.common import _tree_map, causal_mask, linear, rmsnorm, rope_tables, run_layers
from ..models.llama import _block
from .mesh import Mesh, all_gather, broadcast, recv, send


def stage_stack_llama_layers(params: Dict[str, Any], n_stages: int) -> Dict[str, Any]:
    """Per-layer param list -> stage-major stacked tree under ``"stages"``:
    every leaf of ``params["layers"][i]`` stacked to ``[L, ...]``, then
    reshaped to ``[n_stages, L/n_stages, ...]``; packed artifacts stack the
    same way (their metadata is the same every layer)."""
    layers = params["layers"]
    n_layers = len(layers)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    staged = _tree_map(lambda *xs: torch.stack(xs).reshape((n_stages, per) + xs[0].shape),
                       layers[0], *layers[1:])
    return {**{k: v for k, v in params.items() if k != "layers"}, "stages": staged}


def pp_param_specs(staged_params: Dict[str, Any]) -> Dict[str, Any]:
    """Spec tree for :func:`stage_stack_llama_layers` output: everything
    under ``"stages"`` split on its leading (stage) axis over the model
    ranks, everything else whole (a spec applies to the whole subtree)."""
    return {k: ("model",) if k == "stages" else () for k in staged_params}


def _vocab_parallel(cfg, params, n_stages: int) -> bool:
    """Whether the head splits its vocabulary over the stages: a dense
    ``[H, V]`` head (or the tied embedding) with ``V % n_stages == 0``."""
    if cfg.tie_word_embeddings:
        return params["embed"].shape[0] % n_stages == 0
    head_w = params.get("lm_head", {}).get("w")
    return (torch.is_tensor(head_w) and head_w.dim() == 2
            and head_w.shape[1] % n_stages == 0)


def make_pp_llama_forward(cfg, mesh: Mesh, n_microbatches: int):
    """Returns ``forward(staged_params, tokens) -> logits`` (full sequence,
    no KV cache), a GPipe schedule over the ``mesh.model`` stage ranks.

    ``staged_params`` is this rank's ``apply_sharding(stage_stack_llama_
    layers(params, S), pp_param_specs(...), mesh)``.  The head is
    vocab-parallel when it is dense with ``V % S == 0``: the last stage's
    final hidden state is broadcast, each stage computes its vocabulary
    slice and the slices are all-gathered; otherwise the last stage
    computes the full head and broadcasts the logits.  The logits end on
    every rank."""
    n_stages = mesh.model
    group, ranks = mesh.model_group, mesh.model_ranks
    stage = mesh.model_index

    def forward(staged_params, tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        if b % n_microbatches:
            raise ValueError(f"batch {b} not divisible by {n_microbatches}")
        mb = b // n_microbatches
        dev = staged_params["embed"].device
        tokens = tokens.to(dev)
        positions = torch.arange(s, device=dev)
        mask = causal_mask(s, device=dev)
        cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta, cfg.condense_ratio)
        local = {"layers_stacked": _tree_map(lambda a: a[0], staged_params["stages"])}
        x_embed = staged_params["embed"][tokens]  # [B, S, H] (embed whole)

        def run_stage(x):
            x, _ = run_layers(x, local, None,
                              lambda x, p, c: _block(x, p, cfg, cos, sin, mask, c), True)
            return x

        outputs = []
        for m in range(n_microbatches):
            if stage == 0:
                x = x_embed[m * mb:(m + 1) * mb]
            else:
                x = recv(x_embed[:mb], ranks[stage - 1], group)
            y = run_stage(x)
            if stage < n_stages - 1:
                send(y, ranks[stage + 1], group)
            else:
                outputs.append(y)
        x = torch.cat(outputs) if outputs else torch.empty_like(x_embed)

        if _vocab_parallel(cfg, staged_params, n_stages):
            # the last stage's hidden state to every stage, then each stage
            # its vocabulary slice, gathered in stage order
            x = broadcast(x, ranks[-1], group)
            x = rmsnorm(x, staged_params["final_norm"], cfg.rms_norm_eps)
            if cfg.tie_word_embeddings:
                w = staged_params["embed"].t()
                bias = None
            else:
                w, bias = staged_params["lm_head"]["w"], staged_params["lm_head"].get("b")
            vs = w.shape[1] // n_stages
            logits = x @ w[:, stage * vs:(stage + 1) * vs].to(x.dtype)
            if bias is not None:
                logits = logits + bias[stage * vs:(stage + 1) * vs].to(logits.dtype)
            return all_gather(logits, group, dim=-1)
        # packed or odd-vocabulary head: the last stage computes it whole
        if stage == n_stages - 1:
            x = rmsnorm(x, staged_params["final_norm"], cfg.rms_norm_eps)
            if cfg.tie_word_embeddings:
                logits = x @ staged_params["embed"].t().to(x.dtype)
            else:
                logits = linear(x, staged_params["lm_head"])
        else:
            vocab = (staged_params["embed"].shape[0] if cfg.tie_word_embeddings
                     else staged_params["lm_head"]["w"].shape[1])
            logits = torch.empty((b, s, vocab), dtype=x_embed.dtype, device=dev)
        return broadcast(logits, ranks[-1], group)

    return forward

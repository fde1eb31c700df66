"""CUDA graphs of the engine's decode programs: the counterpart of the JAX
engine's jitted, cache-donating ``_generate_chunk``, ``_serve_chunk`` and
``_serve_combo`` (``engine/engine.py`` of the JAX package).

JAX compiles each of those once per set of static arguments and runs it as
one device program.  Here each becomes a CUDA graph, captured once per key
and replayed for every later chunk with that key.  The key is JAX's static
arguments plus the shapes the port's body depends on (:data:`KEYS`).

* Inputs: each tensor the host hands a chunk is copied into the graph's
  static input buffer before a replay.  Everything else the body reads
  (the params, the engine's cache buffers, the generator's device state)
  stays where it is between replays: the counterpart of JAX's donation.
* Output: one static tensor, valid until the next replay of any graph of
  the engine (they share one memory pool), so the caller reads it first.
* First use of a key: the body runs eagerly on the capture stream.  That
  run is the warm-up (it builds and loads the kernels and sets their
  attributes before any capture) and its result is the chunk's result.
  Then the key is captured.  A capture does not execute, so the caches and
  the generator stay as the warm-up left them, and the tokens are the
  eager body's.
* Counters: the dispatch counters of ``ops.kernels.dequant_matmul`` count
  in Python, so a capture would count launches that do not run and a
  replay none.  The capture's counts are taken back and kept as the graph's
  deltas, which every replay adds: the counters keep counting launches
  that ran.
* Sampling: the engine's generator is registered with every graph
  (``CUDAGraph.register_generator_state``).  A replay then draws from the
  generator's current seed and offset and advances it as the eager body
  would, so a re-seeded generator gives the eager body's tokens.

A capture or a replay that fails raises; nothing runs the eager body in its
place.  Only the engine uses this module, and only on a CUDA device without
a rank mesh (``InferenceEngine._chunk``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, NamedTuple, Tuple

import torch

from ..ops.kernels import dequant_matmul as dm

# the fields of each decode program's key: the JAX function's static
# arguments (``static_argnames``), then the shapes of the port's body (the
# batch, the slots, the page table's width)
KEYS: Dict[str, Tuple[str, ...]] = {
    "_generate_chunk": ("forward", "cfg", "temperature", "top_k", "t_max", "c", "abits",
                        "batch"),
    "_serve_chunk": ("forward", "cfg", "temperature", "top_k", "t_max", "c", "abits",
                     "ns", "mp"),
    "_serve_combo": ("forward", "cfg", "temperature", "top_k", "t_max", "s_len", "c",
                     "abits", "p_abits", "ns", "mp"),
}


def graph_key(program: str, **fields) -> Tuple[Hashable, ...]:
    """The key of ``program`` (a name of :data:`KEYS`) from exactly its
    fields."""
    names = KEYS[program]
    if set(fields) != set(names):
        raise ValueError(f"{program} keys on {names}, got {sorted(fields)}")
    return (program,) + tuple(fields[n] for n in names)


def _snapshot() -> Tuple[Dict[str, int], ...]:
    return tuple(dict(c) for c in dm.COUNTERS)


def _add(deltas: Tuple[Dict[str, int], ...], sign: int = 1) -> None:
    for counter, delta in zip(dm.COUNTERS, deltas):
        for name, n in delta.items():
            counter[name] += sign * n


class _Graph(NamedTuple):
    """One captured key: the graph, its static inputs and output, the
    counter deltas of one replay, and the body (which holds the params and
    caches the graph reads)."""

    graph: Any
    inputs: Dict[str, torch.Tensor]
    output: torch.Tensor
    deltas: Tuple[Dict[str, int], ...]
    body: Callable[..., torch.Tensor]


class ChunkGraphs:
    """An engine's captured decode programs on one CUDA device: one graph
    per key, one memory pool, one capture stream, and the generator every
    graph draws from."""

    def __init__(self, device: torch.device, generator: torch.Generator):
        self.device = device
        self.generator = generator
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[Tuple[Hashable, ...], _Graph] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def keys(self):
        return list(self._graphs)

    def run(self, key: Tuple[Hashable, ...], body: Callable[..., torch.Tensor],
            inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``body(**inputs)``: a replay of ``key``'s graph, or on the key's
        first use the eager body (the warm-up) and then its capture.  The
        returned tensor is the graph's static output after a replay: read
        it before the next call."""
        g = self._graphs.get(key)
        if g is None:
            return self._capture(key, body, inputs)
        for name, t in inputs.items():
            g.inputs[name].copy_(t)
        g.graph.replay()
        _add(g.deltas)
        self.replays += 1
        return g.output

    def _capture(self, key, body, inputs) -> torch.Tensor:
        t0 = time.perf_counter()
        static = {name: t.to(self.device, copy=True) for name, t in inputs.items()}
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = body(**static)
        cur.wait_stream(self.stream)
        before = _snapshot()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            output = body(**static)
        deltas = tuple({k: v - b.get(k, 0) for k, v in c.items() if v != b.get(k, 0)}
                       for c, b in zip(dm.COUNTERS, before))
        _add(deltas, -1)  # the capture launched nothing
        self._graphs[key] = _Graph(graph, static, output, deltas, body)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return out

    def pool_bytes(self) -> int:
        """Bytes of the device memory segments of the graphs' pool."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

"""One CUDA graph per decode-chunk shape: the port's counterpart of the
``jax.jit`` cache behind quip_tpu's ``_chunk_j`` (serve/engine.py).

quip_tpu compiles one program per static chunk key and dispatches it with
one host call. Here a chunk is T eager decode steps, each thousands of
aten ops and kernel launches, so the host, not the card, sets the pace
(PERF.md section 5); a ``torch.cuda.CUDAGraph`` captured once per key
replays the whole chunk with one call.

Each key gets its graph at its first use, captured into a pool that all
graphs share. The first key of each family runs its chunk once eagerly on
a side stream before the capture (every kernel library is then loaded,
every ``cudaFuncSetAttribute`` has run and the derived state that the
chunk's operations cache, such as K3's bf16 operands, is made; that run is
the caller's real chunk and its outputs are returned); a later key of the
family is captured at once and its graph replayed for the caller's chunk
(an eager run took about as long as recording the chunk, a third of a
graph's build). A family is what the caller's ``family(key)`` returns:
keys that run the same operations on other shapes, which the first one's
eager run set up for all of them; by default each key is a family of its
own. The function must read its inputs
from buffers whose storage outlives the graph (the engine's static
buffers, the caches, the weights) and may update them in place; a replay
returns the outputs captured with the graph, which the next replay of the
same graph overwrites. A generator it draws from is registered with every
graph, so each replay draws fresh numbers.

On the CPU, :meth:`ChunkGraphs.run` calls the function: the plain path.
On the card a failed capture or replay raises; nothing falls back to
eager execution.

The kernel wrappers count launches in Python, which a replay never runs:
the counts a capture added are taken back (a capture launches nothing) and
added again at every replay, which launches those kernels. The
collectives' counters (parallel/comm.py) are kept the same way: a chunk of
a sharded engine on an NCCL group captures its collectives. On a gloo
group, whose collectives a graph cannot hold, the engine makes its
ChunkGraphs ``eager``: every chunk runs its function.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from quip_tpu_torch.kernels import dequant_matmul as DM
from quip_tpu_torch.kernels import flash_attn as FA
from quip_tpu_torch.kernels import rht as K3
from quip_tpu_torch.parallel import comm

_COUNTERS = ((DM, "launches"), (DM, "launches_decode"),
             (DM, "launches_decode_ragged"), (DM, "launches_tile"),
             (FA, "launches"), (K3, "launches"))


def _counts() -> List[float]:
    return [getattr(mod, name) for mod, name in _COUNTERS] + comm.snapshot()


def _add_counts(delta: List[float]) -> None:
    for (mod, name), d in zip(_COUNTERS, delta):
        setattr(mod, name, getattr(mod, name) + d)
    comm.add(delta[len(_COUNTERS):])


class ChunkGraphs:
    """Graphs by key on ``device``, all in one memory pool, each drawing
    from ``generator``. ``capture_s`` and ``pool_bytes`` add up the time
    spent building graphs (eager run included) and the device memory the
    pool holds; ``parts_s`` splits ``capture_s`` by part: a family's first
    eager run ("eager", host time until the card is done), the settling
    before the capture ("settle": synchronize and empty the cache),
    recording the function ("record") and ending the capture, which
    instantiates the graph ("instantiate"). ``eager`` runs every chunk's
    function (no graph). ``family`` maps a key to its family (the module
    note); by default a key is its own."""

    def __init__(self, device: torch.device, generator: torch.Generator,
                 eager: bool = False,
                 family: Optional[Callable[[Hashable], Hashable]] = None):
        self.device = device
        self.eager = eager
        self.generator = generator
        self._graphs: Dict[Hashable, Tuple[Any, Any, List[int]]] = {}
        self._pool = None
        self._side = None
        self._family = family or (lambda key: key)
        self._warm = set()                # families that ran eagerly
        self.capture_s = 0.0
        self.parts_s = dict(eager=0.0, settle=0.0, record=0.0,
                            instantiate=0.0)
        self.pool_bytes = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._graphs

    def run(self, key: Hashable, fn: Callable[[], Any]) -> Any:
        """``fn()`` on the CPU; on the card the replay of ``key``'s graph,
        built from ``fn`` at the key's first call."""
        if self.device.type != "cuda" or self.eager:
            return fn()
        entry = self._graphs.get(key)
        if entry is None:
            return self._build(key, fn)
        graph, out, delta = entry
        graph.replay()
        _add_counts(delta)
        return out

    def _build(self, key: Hashable, fn: Callable[[], Any]) -> Any:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        family = self._family(key)
        first = family not in self._warm
        if first:
            self._side.wait_stream(cur)
            with torch.cuda.stream(self._side):
                out = fn()                # the real chunk, eagerly
            cur.wait_stream(self._side)
            self._warm.add(family)
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = _counts()
        t2 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool):
            static_out = fn()
            t3 = time.perf_counter()
        t4 = time.perf_counter()
        delta = [a - b for a, b in zip(_counts(), before)]
        _add_counts([-d for d in delta])      # a capture launches nothing
        self._graphs[key] = (graph, static_out, delta)
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        if not first:
            graph.replay()                # the real chunk
            _add_counts(delta)
            out = static_out
        for part, s in (("eager", t1 - t0), ("settle", t2 - t1),
                        ("record", t3 - t2), ("instantiate", t4 - t3)):
            self.parts_s[part] += s
        self.capture_s += time.perf_counter() - t0
        return out

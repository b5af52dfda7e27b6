"""The level builder's CUDA graphs, cached across trees and fits.

On the card a tree's level loop (core/tree.py) is some seventy small
PyTorch ops a level around each histogram launch, and the card runs them
faster than the host can queue them.  So each piece of the loop — a dense
level, the leaf level, and a compacted level's prologue (up to its
live-count read), each of its passes and its epilogue — is captured once
into a CUDA graph and replayed for every later tree of the same shapes,
in this fit and in later ones.  The kernels, their order and their
operands are the eager loop's; only the host's per-op dispatch between
them goes.  The live count stays a host read between the prologue and
the passes, so a tree launches as many histograms as the eager loop.

A :class:`LevelGraphs` holds one shape's static state (a
``core.tree.TreeState`` whose inputs the caller copies in), its graphs,
the memory pool they share (pieces replay one at a time, in order, and
keep nothing of their own between replays: all they pass on lives in the
state), the side stream they are captured on and the histogram kernel's
scratch on that stream.  The first tree of an entry runs eagerly — the
warm-up: the kernel's build and shared-memory opt-in, lazy
initialisation — and each of its pieces is captured once it has run; a
piece no earlier tree ran (a further pass of a compacted level) is
captured when a tree first needs it.  The cache keeps the
:data:`MAX_ENTRIES` entries used last.

Counters: ``forest.graph_captures`` (pieces captured) and
``forest.graph_replays`` (pieces replayed).  ``histogram_cuda.launches``
counts the launches a graph holds at each replay, as the eager loop
counts them at each call.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Hashable

import torch

from repro_torch.kernels import histogram as hist
from repro_torch.observability import registry as telemetry

MAX_ENTRIES = 4     # shapes kept; each holds its static inputs and a pool

_M_CAPTURES = telemetry.REGISTRY.counter("forest.graph_captures")
_M_REPLAYS = telemetry.REGISTRY.counter("forest.graph_replays")


class LevelGraphs:
    """The CUDA graphs of one shape of tree, and the state they read and
    write.  Hold :attr:`lock` from copying the inputs into :attr:`state`
    to copying the grown tree out of it."""

    def __init__(self, state):
        self.state = state
        self.device = state.xb.device
        self.lock = threading.RLock()
        self.warm = False       # set once the first tree ran eagerly
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict[Hashable, tuple[torch.cuda.CUDAGraph, int]] = {}
        self.part, self.ticket = hist.reserve_scratch(
            self.device.index, self.stream.cuda_stream, state.hist_shapes())

    def run(self, key: Hashable, piece: Callable[[], None]) -> bool:
        """Run one piece of the level loop from its graph, captured on
        first use; until the entry is warm, eagerly, and then captured for
        the trees to come (a capture runs nothing).  Returns whether a
        graph was replayed."""
        replay = self.warm
        if not replay:
            piece()
        if key not in self.graphs:
            self.graphs[key] = self._capture(piece)
        if replay:
            graph, launches = self.graphs[key]
            graph.replay()
            hist.histogram_cuda.launches += launches
            _M_REPLAYS.inc()
        return replay

    def _capture(self, piece) -> tuple[torch.cuda.CUDAGraph, int]:
        """``piece`` captured on the side stream into the shared pool, in
        ``thread_local`` error mode under the process's capture lock (as
        ``federation/substrate.py::capture_graph``), the kernel's tickets
        zeroed first; with the histogram launches it holds, which the
        capture itself does not count."""
        from repro_torch.federation.substrate import CAPTURE_LOCK
        graph = torch.cuda.CUDAGraph()
        before = hist.histogram_cuda.launches
        with CAPTURE_LOCK, torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                self.ticket.zero_()
                piece()
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
        launches = hist.histogram_cuda.launches - before
        hist.histogram_cuda.launches = before
        _M_CAPTURES.inc()
        return graph, launches

    def close(self) -> None:
        """Drop the graphs once the card has finished their replays, and
        hand the stream's scratch back."""
        torch.cuda.synchronize(self.device)
        self.graphs.clear()
        hist.release_scratch(self.device.index, self.stream.cuda_stream)


_CACHE: collections.OrderedDict[Hashable, LevelGraphs] = \
    collections.OrderedDict()
_CACHE_LOCK = threading.Lock()


def level_graphs(key: Hashable, make_state: Callable) -> LevelGraphs:
    """The entry for ``key`` (whatever fixes the graphs: device, shapes,
    dtypes and the tree's parameters), made over ``make_state()`` on first
    use; the entries used longest ago go when a new one passes
    :data:`MAX_ENTRIES`, closed once no fit holds them."""
    with _CACHE_LOCK:
        entry = _CACHE.get(key)
        if entry is not None:
            _CACHE.move_to_end(key)
            return entry
        old = [_CACHE.popitem(last=False)[1]
               for _ in range(len(_CACHE) - MAX_ENTRIES + 1)]
        entry = _CACHE[key] = LevelGraphs(make_state())
    for e in old:
        with e.lock:
            e.close()
    return entry

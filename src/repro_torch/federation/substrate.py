"""Execution substrates: where the federated protocol runs.

The protocol bodies (core/tree.py, core/prediction.py) take the party axis
as an explicit leading tensor dimension, so a substrate decides only how the
party-stacked arguments reach them:

  * ``SimulatedSubstrate`` — all M parties in this process, on one device.
  * ``DistributedSubstrate`` — one OS process per party, message-passing
    collectives over localhost sockets, fault tolerance
    (federation/distributed.py).

Substrates register themselves by name (:func:`register_substrate`), so a
new implementation plugs into ``Federation``, ``ForestServer`` and the
launch CLIs through :func:`resolve_substrate`.  The JAX package's sharded
substrate is not ported yet.

A substrate also owns what "compiled" means for the serving engine
(``aot_compile``, the seam the JAX package fills with an AOT
``jit(...).lower(...).compile()``).  Here, on CUDA tensors, it captures
the program into one CUDA graph (:func:`capture_graph`): every later wave
replays the graph's kernels with one launch, reading fixed addresses.  On
CPU tensors it returns the program itself — the CPU has no graphs.  The
distributed substrate's ``aot_compile`` is a bind instead: a wave runs
across processes, which no graph can capture.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import torch

# One capture at a time in this process: a capture runs in
# ``thread_local`` error mode, and this lock keeps every other thread's
# graph capture and wave launch (``serving/engine.py`` takes it too) out of
# the capture window.
CAPTURE_LOCK = threading.RLock()


def _tensors(args) -> list[torch.Tensor]:
    """The tensors of an argument tuple, NamedTuples (PartyTree) flattened,
    in order."""
    out: list[torch.Tensor] = []
    for a in args:
        if torch.is_tensor(a):
            out.append(a)
        elif isinstance(a, tuple):
            out.extend(_tensors(a))
    return out


class GraphProgram:
    """A program captured into one CUDA graph, over static arguments.

    It keeps the tensors the graph reads alive (the graph holds their
    addresses); ``out`` is the tensor it writes, at the same address on
    every replay.  Calling it with arguments copies each tensor
    that is not the captured one into the captured one's place, on the
    current stream, then replays: passing the captured tensors themselves
    (what the serving engine does, after copying a wave's rows into the
    static input) is a bare replay."""

    def __init__(self, graph: torch.cuda.CUDAGraph, args: tuple, out):
        self.graph = graph
        self._static = _tensors(args)
        self.out = out

    def __call__(self, *args):
        given = _tensors(args)
        if len(given) != len(self._static):
            raise ValueError(f"captured program takes {len(self._static)} "
                             f"tensors, got {len(given)}")
        for new, old in zip(given, self._static):
            if new is not old:
                if new.shape != old.shape or new.dtype != old.dtype:
                    raise ValueError(
                        f"captured program argument is {tuple(old.shape)} "
                        f"{old.dtype}; got {tuple(new.shape)} {new.dtype}")
                old.copy_(new, non_blocking=True)
        self.graph.replay()
        return self.out


def capture_graph(program: Callable, *args) -> GraphProgram:
    """Capture ``program(*args)`` (CUDA tensors) into one CUDA graph.

    Under :data:`CAPTURE_LOCK`, on a side stream: the program runs twice
    first (lazy initialisation, cuBLAS handles and workspaces, as PyTorch's
    CUDA-graph notes ask), then once under capture in ``thread_local``
    error mode into the graph's own memory pool (graphs replay in traffic
    order, not capture order, so they share no pool).  A program that
    syncs with the host (``.item()``, ``.cpu()``, ``nonzero``, a
    data-dependent shape) fails the capture, and this raises: there is no
    eager fallback.  Host-side checks inside the program run once, here —
    the graph keeps what they chose.  ``capture_graph.captures`` counts
    the captures made."""
    dev = _tensors(args)[0].device
    with CAPTURE_LOCK:
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(2):
                program(*args)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = program(*args)
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()
                raise
            graph.capture_end()
        stream.synchronize()
        capture_graph.captures += 1
    return GraphProgram(graph, args, out)


capture_graph.captures = 0


class SimulatedSubstrate:
    """M parties on one device — semantically the distributed run."""

    name = "simulated"
    # program operands are tensors on the caller's device
    host_operands = False

    def program(self, fn: Callable, n_party: int, n_shared: int, *,
                distributed: dict | None = None, parties=None) -> Callable:
        """Callable over (party_args..., shared_args...).  Party args (a
        tensor, or a tuple of tensors such as a PartyTree) carry the leading
        party dimension M, which they must agree on.  The distributed
        protocol spec and party subset are accepted and ignored, so callers
        stay substrate-agnostic (every party runs here)."""
        def run(*args):
            party = args[:n_party]
            sizes = {int((a[0] if isinstance(a, tuple) else a).shape[0])
                     for a in party}
            if len(sizes) != 1:
                raise ValueError(f"party arguments disagree on the party "
                                 f"count: leading sizes {sorted(sizes)}")
            return fn(*party, *args[n_party:n_party + n_shared])
        return run

    def aot_compile(self, program: Callable, *args) -> Callable:
        """Program -> the runner the serving engine calls for one bucket:
        on CUDA tensors the program captured into a CUDA graph over these
        arguments (:func:`capture_graph`), on CPU tensors the program
        itself (eager: the CPU has no graphs)."""
        if any(t.is_cuda for t in _tensors(args)):
            return capture_graph(program, *args)
        return program

    def jit(self, fn: Callable, n_party: int, n_shared: int,
            **kw) -> Callable:
        """Program and compile in one step: eager here, as ``compile``."""
        return self.compile(self.program(fn, n_party, n_shared, **kw))

    def compile(self, program: Callable) -> Callable:
        """Program -> executable: the program itself (eager PyTorch; the
        serving engine's CUDA graphs are ``aot_compile``'s)."""
        return program

    def context(self):
        """The context a program is compiled in (a sharded substrate's mesh
        in the JAX package; nothing here)."""
        return contextlib.nullcontext()

    def exchange(self, op: str, payload=None, *, party=None, timeout=None):
        """Out-of-band party requests only exist over a transport."""
        return None

    def shutdown(self) -> None:
        """Nothing to tear down in process."""


# ------------------------------------------------------------------- registry
SUBSTRATES: dict[str, Callable[..., Any]] = {}


def register_substrate(name: str, factory: Callable[..., Any] | None = None):
    """Register a substrate factory under ``name`` (the string accepted by
    ``resolve_substrate`` and every session/server entry point).  Factories
    receive ``parties=`` plus any substrate-specific options (the session
    passes its ``device=``).  Usable as a decorator
    (``@register_substrate("x")``) or a call
    (``register_substrate("x", factory)``)."""
    def register(f):
        SUBSTRATES[name] = f
        return f
    return register(factory) if factory is not None else register


@register_substrate("simulated")
def _make_simulated(parties=None, device=None, **opts) -> SimulatedSubstrate:
    # every program runs where its tensors are: the device needs no binding
    if opts:
        raise TypeError(f"substrate 'simulated' takes no options, got "
                        f"{sorted(opts)}")
    return SimulatedSubstrate()


@register_substrate("distributed")
def _make_distributed(parties=None, **opts):
    from repro_torch.federation.distributed import DistributedSubstrate
    if parties is None:
        raise ValueError("substrate='distributed' needs the party count "
                         "(resolve_substrate(..., parties=M))")
    return DistributedSubstrate(parties, **opts)


def default_substrate(sub: Any = None) -> Any:
    """The substrate an estimator runs on when none was injected."""
    return sub if sub is not None else SimulatedSubstrate()


def resolve_substrate(spec: Any, parties: int | None = None, **opts) -> Any:
    """One-time substrate resolution for a session or server.

    ``spec`` is a registered substrate name (see ``SUBSTRATES``) or an
    already-built substrate (passed through).  ``parties``, when given, is
    validated against the substrate's own party count (a distributed
    coordinator's worker count).  Extra keyword options flow to the named
    factory (e.g. the distributed substrate's device and timeout/retry
    knobs)."""
    if isinstance(spec, str):
        factory = SUBSTRATES.get(spec)
        if factory is None:
            raise ValueError(f"unknown substrate {spec!r} "
                             f"(registered: {sorted(SUBSTRATES)})")
        sub = factory(parties=parties, **opts)
    elif callable(getattr(spec, "program", None)):
        sub = spec                          # any conforming implementation
    else:
        raise ValueError(f"unknown substrate {spec!r} "
                         f"(registered: {sorted(SUBSTRATES)}, or pass a "
                         f"substrate)")
    have = getattr(sub, "n_parties", None)
    if parties is not None and have is not None and int(have) != parties:
        raise ValueError(
            f"substrate {sub.name!r} executes {have} parties but the "
            f"session declares {parties}")
    return sub

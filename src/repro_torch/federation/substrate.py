"""Execution substrates: where the federated protocol runs.

The protocol bodies (core/tree.py, core/prediction.py) take the party axis
as an explicit leading tensor dimension, so a substrate decides only how the
party-stacked arguments reach them:

  * ``SimulatedSubstrate`` — all M parties in this process, on one device
    (core/protocol.run_simulated).
  * ``ShardedSubstrate`` — one ``torch.distributed`` rank per position of
    a rank mesh (launch/mesh.py) whose "parties" axis is the protocol axis;
    an optional "trees" axis carries bagging tree-parallelism.  The
    collectives go rank to rank (federation/sharded.py).
  * ``DistributedSubstrate`` — one OS process per party, message-passing
    collectives over localhost sockets, fault tolerance
    (federation/distributed.py).

Substrates register themselves by name (:func:`register_substrate`), so a
new implementation plugs into ``Federation``, ``ForestServer`` and the
launch CLIs through :func:`resolve_substrate`.

A substrate also owns what "compiled" means for the serving engine
(``aot_compile``, the seam the JAX package fills with an AOT
``jit(...).lower(...).compile()``).  Here, on CUDA tensors, it captures
the program into one CUDA graph (:func:`capture_graph`): every later wave
replays the graph's kernels with one launch, reading fixed addresses.  On
CPU tensors it returns the program itself — the CPU has no graphs.  The
sharded and distributed substrates' ``aot_compile`` is a bind instead: a
wave runs across processes, which no graph can capture.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import torch

from repro_torch.core import protocol
from repro_torch.core.types import PARTY_AXIS, TREE_AXIS
from repro_torch.device import resolve_device

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
                distributed: dict | None = None, parties=None,
                sharded: dict | None = None, party_specs=None,
                shared_specs=None, out_specs=None) -> Callable:
        """Callable over (party_args..., shared_args...).  Party args (a
        tensor, or a tuple of tensors such as a PartyTree) carry the leading
        party dimension M, which they must agree on.  The other substrates'
        protocol specs, placements and party subset are accepted and
        ignored, so callers stay substrate-agnostic (every party runs
        here)."""
        return protocol.jit_simulated(fn, n_party, n_shared)

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


class ShardedSubstrate:
    """One ``torch.distributed`` rank per position of a rank mesh (the JAX
    package's shard_map over a "parties" mesh axis, one party per shard).
    A "trees" axis, if present, carries bagging tree-parallelism — forest
    programs place their per-tree args and outputs on it.

    The ranks are the party-per-process substrate's workers, started on
    first use on the mesh's devices and joined into one process group over
    the mesh's backend; their collectives go rank to rank
    (federation/sharded.py).  Operands travel as host arrays to the ranks;
    results come back as host arrays, and the session-side reductions (the
    forest vote over tree shards) run on ``device`` — the session's, of the
    same kind as the mesh's (no rank moves to the CPU unasked).
    ``shutdown`` stops the ranks; the next program call starts new ones."""

    name = "sharded"
    # program operands stay host arrays up to the wire
    host_operands = True
    # seconds: a collective that waits longer raises in its rank (a failed
    # peer), within a run's budget, so the session hears of it
    COLLECTIVE_TIMEOUT = 60.0
    ROUND_TIMEOUT = 300.0
    CONNECT_TIMEOUT = 60.0

    def __init__(self, mesh, *, device: torch.device | str | None = None):
        if PARTY_AXIS not in getattr(mesh, "axis_names", ()):
            raise ValueError(
                f"sharded substrate needs a '{PARTY_AXIS}' mesh axis, got "
                f"{getattr(mesh, 'axis_names', mesh)!r}")
        self.mesh = mesh
        self.device = resolve_device(device)
        if self.device.type != mesh.device_type:
            raise ValueError(
                f"the mesh's ranks run on {mesh.device_type} but the session "
                f"on {self.device.type}: put both on the card or both on the "
                f"CPU")
        self._coord = None

    @property
    def n_parties(self) -> int:
        return self.mesh.n_parties

    @property
    def tree_axis(self) -> str | None:
        return TREE_AXIS if TREE_AXIS in self.mesh.axis_names else None

    @property
    def coordinator(self):
        """The ranks' coordinator: spawns the workers and has them join the
        process group on first use."""
        if self._coord is None:
            from repro_torch.federation import sharded
            from repro_torch.federation.distributed import Coordinator
            from repro_torch.federation.transport import RetryPolicy
            coord = Coordinator(
                self.mesh.size, device=self.device, devices=self.mesh.devices,
                round_timeout=self.ROUND_TIMEOUT,
                connect_timeout=self.CONNECT_TIMEOUT,
                retry=RetryPolicy(attempts=1))
            coord.start()
            try:
                sharded.start_ranks(coord, self.mesh,
                                    self.COLLECTIVE_TIMEOUT)
            except BaseException:
                coord.shutdown()
                raise
            self._coord = coord
        return self._coord

    def program(self, fn: Callable, n_party: int, n_shared: int, *,
                distributed: dict | None = None, parties=None,
                sharded: dict | None = None, party_specs=None,
                shared_specs=None, out_specs=None) -> Callable:
        """``fn`` over the ranks: the rank-only body ``sharded`` if given,
        else the protocol body ``distributed``, else ``fn`` itself (a
        module-level function).  Every party runs: ``parties`` (the
        distributed substrate's degraded subset) is ignored."""
        return protocol.sharded_program(
            fn, self, n_party, n_shared, shared_specs=shared_specs,
            out_specs=out_specs, party_specs=party_specs,
            spec=sharded or distributed)

    jit = program

    def compile(self, program: Callable) -> Callable:
        return program                         # already an executable program

    def aot_compile(self, program: Callable, *args) -> Callable:
        """Ship the program's model-side operands to the ranks once (a
        bind, not a graph: the wave runs across processes)."""
        return program.bind(*args)

    def context(self):
        return contextlib.nullcontext()

    def exchange(self, op: str, payload: dict | None = None, *,
                 party: int | None = None, timeout: float | None = None):
        """Out-of-band request to one rank (``party`` is the rank index) or
        to all."""
        coord = self.coordinator
        msg = dict(payload or {}, op=op)
        if party is not None:
            return coord.request(party, msg, timeout=timeout)
        return {r: coord.request(r, msg, timeout=timeout)
                for r in range(self.mesh.size)}

    def collect_telemetry(self) -> dict[int, dict]:
        """Each rank's buffered spans and metrics into this process, the
        metrics under ``rank<r>.`` (its histogram launches, collective
        rounds, bytes and staged bytes).  Empty before the ranks start."""
        if self._coord is None:
            return {}
        from repro_torch.federation.distributed import rollup_telemetry
        return rollup_telemetry(self._coord, "rank")

    def shutdown(self) -> None:
        if self._coord is not None:
            self._coord.shutdown()
            self._coord = None

    def __repr__(self) -> str:
        state = "up" if self._coord is not None else "cold"
        return (f"ShardedSubstrate({self.mesh.axis_names}={self.mesh.shape}, "
                f"{self.mesh.backend}, device={self.device}, {state})")


# ------------------------------------------------------------------- registry
SUBSTRATES: dict[str, Callable[..., Any]] = {}


def register_substrate(name: str, factory: Callable[..., Any] | None = None):
    """Register a substrate factory under ``name`` (the string accepted by
    ``resolve_substrate`` and every session/server entry point).  Factories
    receive ``parties=`` (and ``mesh=`` when one is given) plus any
    substrate-specific options (the session passes its ``device=``).  Usable as a decorator
    (``@register_substrate("x")``) or a call
    (``register_substrate("x", factory)``)."""
    def register(f):
        SUBSTRATES[name] = f
        return f
    return register(factory) if factory is not None else register


@register_substrate("simulated")
def _make_simulated(parties=None, device=None, mesh=None,
                    **opts) -> SimulatedSubstrate:
    # every program runs where its tensors are: the device needs no binding
    if opts:
        raise TypeError(f"substrate 'simulated' takes no options, got "
                        f"{sorted(opts)}")
    return SimulatedSubstrate()


@register_substrate("sharded")
def _make_sharded(parties=None, mesh=None, **opts) -> ShardedSubstrate:
    if mesh is None:
        raise ValueError("substrate='sharded' requires a mesh "
                         "(launch/mesh.py::make_forest_mesh)")
    return ShardedSubstrate(mesh, **opts)


@register_substrate("distributed")
def _make_distributed(parties=None, mesh=None, **opts):
    from repro_torch.federation.distributed import DistributedSubstrate
    if parties is None:
        raise ValueError("substrate='distributed' needs the party count "
                         "(resolve_substrate(..., parties=M))")
    return DistributedSubstrate(parties, **opts)


def default_substrate(sub: Any = None) -> Any:
    """The substrate an estimator runs on when none was injected."""
    return sub if sub is not None else SimulatedSubstrate()


def resolve_substrate(spec: Any, mesh=None, parties: int | None = None,
                      **opts) -> Any:
    """One-time substrate resolution for a session or server.

    ``spec`` is a registered substrate name (see ``SUBSTRATES``) or an
    already-built substrate (passed through).  ``mesh`` is a rank mesh
    (launch/mesh.py) for the sharded substrate.  ``parties``, when given,
    is validated against the substrate's own party count (a mesh's
    "parties" axis, a distributed coordinator's worker count).  Extra
    keyword options flow to the named factory (e.g. the distributed
    substrate's device and timeout/retry knobs)."""
    if isinstance(spec, str):
        factory = SUBSTRATES.get(spec)
        if factory is None:
            raise ValueError(f"unknown substrate {spec!r} "
                             f"(registered: {sorted(SUBSTRATES)})")
        if mesh is not None:
            opts["mesh"] = mesh
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

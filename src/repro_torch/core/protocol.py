"""Runners that bind the federated protocol to an execution substrate.

The protocol bodies (core/tree.py, core/prediction.py, core/fedlinear.py)
take the party axis as an explicit leading tensor dimension and an optional
``comm``; they run under:

  * ``run_simulated``: every party in this process — the party arguments
    carry all M parties and the collectives are sums / stacks over dim 0
    (``comm=None``).  The CPU test path, and what the simulated substrate
    runs.
  * ``run_sharded``: one ``torch.distributed`` rank per position of a
    rank mesh (launch/mesh.py) whose "parties" axis is the protocol axis.
    Each rank sees its own party (a leading dimension of 1) and exchanges
    the collectives rank to rank through ``comm``
    (federation/sharded.py::DistComm), so the results are
    ``run_simulated``'s, bit for bit.

The argument split is the JAX package's: party args lead (their leading
M dimension is split one party per rank), shared args follow (sent whole
to every rank).  ``party_specs`` / ``shared_specs`` / ``out_specs`` place
arguments and outputs on the mesh's "trees" axis (bagging
tree-parallelism): ``None`` replicates, ``"trees"`` splits the tree
dimension — a party argument's first dimension after the party one, a
shared argument's first, an output's second (after the party stack).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np


def _leading(a) -> int:
    return int((a[0] if isinstance(a, tuple) else a).shape[0])


def run_simulated(fn: Callable[..., Any], party_args: tuple,
                  shared_args: tuple = ()):
    """``fn`` over the stacked party args and the shared args, in this
    process.  The party args must agree on the party count M."""
    sizes = {_leading(a) for a in party_args}
    if len(sizes) > 1:
        raise ValueError(f"party arguments disagree on the party count: "
                         f"leading sizes {sorted(sizes)}")
    return fn(*party_args, *shared_args)


def jit_simulated(fn: Callable[..., Any], n_party: int, n_shared: int):
    """``run_simulated(fn)`` with the party/shared split baked in (eager:
    the port compiles nothing here)."""
    def wrapped(*args):
        return run_simulated(fn, args[:n_party],
                             args[n_party:n_party + n_shared])
    return wrapped


def sharded_program(fn: Callable[..., Any], mesh, n_party: int,
                    n_shared: int, shared_specs=None, out_specs=None, *,
                    party_specs=None, spec: dict | None = None):
    """``fn`` as a program over the ranks of ``mesh``.

    ``mesh`` is a RankMesh (the program then starts its own ranks on first
    call; ``program.substrate.shutdown()`` stops them) or a
    ``ShardedSubstrate`` whose ranks it shares.  ``spec`` names a
    registered rank body (federation/distributed.py, federation/sharded.py)
    to run instead of ``fn``; without one, ``fn`` must be a module-level
    function ``fn(*party_args, *shared_args, comm=None)`` that every rank
    imports by name.  The output is the per-party stack (see the module
    docstring for the placements)."""
    from repro_torch.federation import sharded
    from repro_torch.federation.substrate import ShardedSubstrate
    sub = mesh if isinstance(mesh, ShardedSubstrate) else \
        ShardedSubstrate(mesh, device=mesh.device_type)
    if spec is None:
        spec = sharded.call_spec(fn, n_party)
    return sharded.RankCallable(sub, spec, n_party, n_shared,
                                party_specs=party_specs,
                                shared_specs=shared_specs,
                                out_specs=out_specs)


def run_sharded(fn: Callable[..., Any], party_args: tuple,
                shared_args: tuple = (), *, mesh, shared_specs=None,
                out_specs=None, party_specs=None):
    """Run ``fn`` over the mesh's ranks (see :func:`sharded_program`).  A
    bare RankMesh gets ranks for this one call, stopped after it."""
    prog = sharded_program(fn, mesh, len(party_args), len(shared_args),
                           shared_specs=shared_specs, out_specs=out_specs,
                           party_specs=party_specs)
    try:
        return prog(*party_args, *shared_args)
    finally:
        if prog.substrate is not mesh:
            prog.substrate.shutdown()


def replicate_to_mesh(x, mesh) -> np.ndarray:
    """``x`` as the operand every rank of ``mesh`` receives whole: a host
    array, which the ranks copy to their own devices (the port keeps no
    tensor that spans processes)."""
    del mesh                                   # every rank gets the same
    return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)

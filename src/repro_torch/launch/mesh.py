"""Rank meshes: where the sharded substrate's and the sharded LM's ranks run.

The JAX package lays its federated forest over a device mesh whose
"parties" axis is the protocol axis and whose "trees" axis carries
bagging tree-parallelism, and its LMs over a ``("data", "model")`` mesh.
The port's counterpart is a small frozen description of a
``torch.distributed`` world: its axis names, its shape, the device of each
rank, and the backend the ranks talk over.  A mesh spawns nothing; the
sharded substrate (federation/sharded.py) and the sharded LM
(models/parallel.py) start one process per rank.

Ranks are laid out row-major: rank ``r`` of a ``("trees", "parties")``
mesh of shape ``(T, P)`` sits at tree shard ``r // P`` and party
``r % P``; of a ``("data", "model")`` mesh of shape ``(D, M)``, at data
shard ``r // M`` and model shard ``r % M``.  A leading "pod" axis (the
JAX package's multi-pod layouts) folds into the outer axis, as JAX's
``models/sharding.py::_data_axis`` folds it into the batch and FSDP axis:
rank ``r`` of ``(Pd, D, M)`` sits at folded data shard ``r // M`` (pod
``r // (D·M)``).  :func:`axis_groups` makes each axis's process groups.

**The backend is the caller's, stated** — nothing switches it:

  * ``"nccl"`` needs a distinct card per rank; asked for with two ranks on
    one device it raises here, before anything is spawned;
  * ``"gloo"`` runs ranks on the CPU, and also several ranks on one card
    (its collectives on card tensors are staged through host buffers, and
    counted: see ``federation/sharded.py::DistComm``).

The JAX package's production layouts, (data 16, model 16) and (pod 2,
data 16, model 16), and its forest's (trees, parties) counterparts are
:func:`make_production_mesh` and ``make_forest_mesh(multi_pod=...)``:
abstract meshes, with no device and no process group, that only the dry
run reads (``launch/cases.py``).  Their ranks are GPUs, eight a node in
rank order, so each model axis's group of 16 spans two nodes
(``roofline.link_rate``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.types import PARTY_AXIS, TREE_AXIS

BACKENDS = ("gloo", "nccl")
DATA_AXIS, MODEL_AXIS = "data", "model"
POD_AXIS = "pod"
AXES = ((TREE_AXIS, PARTY_AXIS), (PARTY_AXIS,), (DATA_AXIS, MODEL_AXIS),
        (POD_AXIS, TREE_AXIS, PARTY_AXIS), (POD_AXIS, DATA_AXIS, MODEL_AXIS))


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A ``torch.distributed`` world laid out over named axes.

    Attributes:
      axis_names: ``("trees", "parties")`` or ``("parties",)`` (the
        forest), or ``("data", "model")`` (an LM).
      shape: the size of each axis, in ``axis_names`` order.
      devices: the device of each rank, in rank order (row-major over
        ``shape``), e.g. ``("cuda:0", "cuda:1")`` or ``("cpu",) * 4``.
      backend: ``"gloo"`` or ``"nccl"``.
      abstract: a layout only (:func:`make_production_mesh`): its
        ``devices`` name the device type, and nothing is spawned on it.
    """

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: tuple[str, ...]
    backend: str = "gloo"
    abstract: bool = False

    def __post_init__(self) -> None:
        names, shape = tuple(self.axis_names), tuple(int(s) for s in
                                                     self.shape)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "devices",
                           tuple(str(torch.device(d)) for d in self.devices))
        if names not in AXES:
            raise ValueError(f"a rank mesh has axes ('trees', 'parties'), "
                             f"('parties',) or ('data', 'model'), each with "
                             f"a leading 'pod' or not, got {names}")
        if len(shape) != len(names) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} does not fit axes {names}")
        if len(self.devices) != self.size:
            raise ValueError(f"{self.size} ranks but {len(self.devices)} "
                             f"devices")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{self.backend!r}")
        kinds = {torch.device(d).type for d in self.devices}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"every rank must run on the CPU or every rank "
                             f"on a card, got {self.devices}")
        if self.backend == "nccl" and not self.abstract:
            if kinds != {"cuda"}:
                raise ValueError("the nccl backend runs on cards only; use "
                                 "gloo for CPU ranks")
            if len(set(self.devices)) != len(self.devices):
                raise ValueError(
                    f"the nccl backend needs a distinct card per rank, got "
                    f"{self.devices}; use gloo for several ranks on one "
                    f"card")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        """The size of axis ``name`` (1 for an axis the mesh lacks); the
        outer axis of a mesh with a "pod" axis is folded with it."""
        if name not in self.axis_names:
            return 1
        i = self.axis_names.index(name)
        if len(self.shape) == 3 and i == 1:
            return self.shape[0] * self.shape[1]
        return self.shape[i]

    @property
    def n_parties(self) -> int:
        return self.axis_size(PARTY_AXIS)

    @property
    def n_tree_shards(self) -> int:
        return self.axis_size(TREE_AXIS)

    @property
    def device_type(self) -> str:
        return torch.device(self.devices[0]).type

    def coords(self, rank: int) -> tuple[int, int]:
        """(outer, inner) index of ``rank``: (tree shard, party), or (data
        shard, model shard) — the outer folded with a "pod" axis."""
        return divmod(int(rank), self.shape[-1])

    def axis_index(self, rank: int, name: str) -> int:
        """``rank``'s index along axis ``name`` (0 for an axis the mesh
        lacks; the folded index along the outer axis of a pod mesh)."""
        if name not in self.axis_names:
            return 0
        if name == POD_AXIS:
            return int(rank) // (self.shape[1] * self.shape[2])
        outer, inner = self.coords(rank)
        return inner if name == self.axis_names[-1] else outer

    def axis_ranks(self, name: str) -> list[tuple[int, ...]]:
        """The groups of ranks along axis ``name``: each the ranks that
        differ only in that axis (the outer axis of a pod mesh folded with
        "pod"), in axis order; the groups in rank order of their first
        member."""
        if name not in self.axis_names:
            return [(r,) for r in range(self.size)]
        if name == POD_AXIS:
            step = self.shape[1] * self.shape[2]
            return [tuple(range(r, self.size, step)) for r in range(step)]
        outer, inner = (self.shape if len(self.shape) == 2
                        else (1, self.shape[0]) if len(self.shape) == 1
                        else (self.shape[0] * self.shape[1], self.shape[2]))
        if name == self.axis_names[-1]:
            return [tuple(o * inner + i for i in range(inner))
                    for o in range(outer)]
        return [tuple(o * inner + i for o in range(outer))
                for i in range(inner)]


def _rank_devices(n: int, backend: str, devices) -> tuple[str, ...]:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available (a mesh's ranks run on the card "
                "unless the caller passes devices='cpu')")
        count = torch.cuda.device_count()
        if backend == "nccl" and n > count:
            raise ValueError(
                f"the nccl backend needs a distinct card per rank: {n} ranks "
                f"but {count} card(s); use gloo for several ranks on one "
                f"card")
        return tuple(f"cuda:{i % count}" for i in range(n))
    if isinstance(devices, (str, torch.device)):
        dev = torch.device(devices)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        return (str(dev),) * n
    return tuple(str(torch.device(d)) for d in devices)


def make_forest_mesh(*, trees: int = 1, parties: int = 1,
                     backend: str = "gloo", devices=None,
                     multi_pod: bool | None = None) -> RankMesh:
    """The federated-forest mesh: ``(trees, parties)`` ranks.

    ``devices``: None puts the ranks on the cards, round robin (every rank
    on the one card of a one-card host); a single device (``"cpu"``,
    ``"cuda:0"``) puts every rank there; a sequence names each rank's.
    ``multi_pod`` given (False or True) returns the JAX package's
    production layout instead, abstract as :func:`make_production_mesh`'s:
    (trees 16, parties 16), or (pod 2, trees 16, parties 16) — the NN
    mesh's GPUs, the axis names binding the paper's roles."""
    if multi_pod is not None:
        if multi_pod:
            return _abstract((POD_AXIS, TREE_AXIS, PARTY_AXIS), (2, 16, 16))
        return _abstract((TREE_AXIS, PARTY_AXIS), (16, 16))
    n = int(trees) * int(parties)
    return RankMesh((TREE_AXIS, PARTY_AXIS), (int(trees), int(parties)),
                    _rank_devices(n, backend, devices), backend)


def make_lm_mesh(*, data: int = 1, model: int = 1, backend: str = "gloo",
                 devices=None) -> RankMesh:
    """The LM's ``("data", "model")`` mesh, the JAX package's
    ``make_host_mesh`` layout: the batch splits over "data", the weights
    over "model" (``models/sharding.py``).  ``devices`` as
    :func:`make_forest_mesh`'s: ``"nccl"`` needs a card a rank; ``"gloo"``
    also runs several ranks on one card, or on the CPU."""
    n = int(data) * int(model)
    return RankMesh((DATA_AXIS, MODEL_AXIS), (int(data), int(model)),
                    _rank_devices(n, backend, devices), backend)


def axis_groups(mesh: RankMesh, rank: int, names) -> dict:
    """This rank's process group along each axis of ``names``, made after
    ``init_process_group``.  Every rank makes every group of each axis, in
    one order (``torch.distributed.new_group``'s rule), and keeps its
    own."""
    import torch.distributed as dist
    out = {}
    for name in names:
        for ranks in mesh.axis_ranks(name):
            group = dist.new_group(list(ranks))
            if rank in ranks:
                out[name] = group
    return out


def make_host_mesh(n: int = 1, axes=(TREE_AXIS, PARTY_AXIS),
                   shape=None) -> RankMesh:
    """Small CPU mesh for tests: gloo ranks on the host (``shape`` defaults
    to ``(1, n)``, or ``(n,)`` for a one-axis mesh)."""
    axes = tuple(axes)
    shape = tuple(shape) if shape is not None else \
        ((1, int(n)) if len(axes) == 2 else (int(n),))
    return RankMesh(axes, shape, ("cpu",) * math.prod(shape), "gloo")


def _abstract(axes: tuple, shape: tuple) -> RankMesh:
    return RankMesh(axes, shape, ("cuda",) * math.prod(shape), "nccl",
                    abstract=True)


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """The JAX package's NN production mesh as an abstract layout of GPUs:
    (data 16, model 16), or (pod 2, data 16, model 16) with ``multi_pod``
    — eight GPUs a node, ranks model-major.  No device and no process
    group: the dry run (``launch/cases.py``) runs its ranks on fake
    tensors."""
    if multi_pod:
        return _abstract((POD_AXIS, DATA_AXIS, MODEL_AXIS), (2, 16, 16))
    return _abstract((DATA_AXIS, MODEL_AXIS), (16, 16))


"""Runtime egress guard: the wire-side twin of the static taint pass.

`taint(arr, label)` tags raw numpy arrays at the moment they are
constructed party-side (`PartyBlock.__post_init__`, streaming
`SourceScan`s), and `check_egress(msg)` — called by
`transport.Channel.send` before anything is encoded — walks the outgoing
payload pytree and raises a typed :class:`PrivacyViolationError` naming
the offending key path if any tagged array (or a view of one) is about to
cross the wire.  The JAX package's ``repro.analysis.runtime`` carried over,
with the same labels, key paths and messages, plus one thing the port's
codec needs: it also encodes torch tensors.

Design notes
------------
* The registry is keyed by ``id(array)`` with a ``weakref.ref`` holding
  the identity alive-check (``np.ndarray`` is unhashable, so a
  WeakKeyDictionary cannot be used; the ref-is-object check defeats id
  reuse after garbage collection).  Dead entries are pruned
  opportunistically so the registry stays bounded under streaming
  workloads that construct thousands of short-lived chunk blocks.
* Views are caught by walking ``arr.base``: slicing a tagged block's
  column out of it yields a view whose ``.base`` chain reaches the tagged
  buffer.  Fancy-indexed *copies* (e.g. ``block.y[positions]``) are new
  buffers and are deliberately NOT tainted — the paper's trust model
  allows aligned labels to return to the coordinator session, and the
  static pass documents that flow with an ``# egress: ok(...)``
  suppression at the send site.
* Tensors: ``torch.from_numpy(block.x)`` shares the raw buffer, but the
  ``.base`` of its ``.numpy()`` is the tensor, not the tagged ndarray, so
  the ``.base`` walk alone would let it through.  A CPU tensor — met as a
  payload leaf or at the end of an ndarray's ``.base`` chain — carries
  the label of the tagged buffer whose byte range holds its storage
  (``untyped_storage().data_ptr()`` and ``nbytes``), and only while that
  buffer's weakref is alive, so an address reused after garbage
  collection cannot match.  A CUDA tensor or a ``.clone()`` is a new
  buffer and is clean, just as a fancy-index copy is.
* The guard is off by default (zero overhead in library use) and enabled
  by ``REPRO_EGRESS_GUARD=1`` — set by ``tests/conftest.py`` and the
  distributed demo.  Because worker processes are spawned, they inherit
  the environment and enforce the same policy on their side of the wire.
* `allow_egress(reason)` is the runtime twin of the static
  ``# egress: ok(reason)`` comment: a thread-local escape hatch for the
  one legitimate raw flow (a party provisioning its *own* worker
  process).  Static suppression and runtime allowance must stay paired.
* NumPy only at import: torch is looked up in ``sys.modules`` when a
  payload is checked (no tensor can exist before torch is imported).
"""
from __future__ import annotations

import os
import sys
import threading
import weakref

import numpy as np

_PRUNE_THRESHOLD = 4096

_enabled = os.environ.get("REPRO_EGRESS_GUARD", "") not in ("", "0")
# id(arr) -> (weakref, label, first byte, one past the last byte)
_registry: dict[int, tuple] = {}
_lock = threading.Lock()
_local = threading.local()


class PrivacyViolationError(RuntimeError):
    """A raw-tagged array was about to cross a party boundary.

    Attributes:
        path: key path inside the outgoing message, e.g.
            ``msg['payload']['x']``.
        label: the taint label attached when the array was constructed,
            e.g. ``PartyBlock['credit'].x (raw features)``.
    """

    def __init__(self, path: str, label: str, context: str = ""):
        self.path = path
        self.label = label
        where = f" in {context}" if context else ""
        super().__init__(
            f"privacy egress blocked{where}: {path} carries {label} — raw "
            f"party data must pass a registered sanitizer (hash_ids / "
            f"party-local binning / label masking) before Channel.send")


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def _prune_locked() -> None:
    dead = [k for k, entry in _registry.items() if entry[0]() is None]
    for k in dead:
        del _registry[k]


def _byte_range(a: np.ndarray) -> tuple[int, int]:
    """[first, one past last) byte address that ``a``'s elements touch."""
    lo = hi = a.__array_interface__["data"][0]
    if a.size == 0:
        return lo, lo
    for n, stride in zip(a.shape, a.strides):
        if stride < 0:
            lo += stride * (n - 1)
        else:
            hi += stride * (n - 1)
    return lo, hi + a.itemsize


def taint(arr, label: str):
    """Tag ``arr`` as raw party data; returns ``arr`` for chaining.

    The whole ``.base`` chain is registered under the same label: numpy
    COLLAPSES view chains (a view of a view points straight at the
    ultimate buffer), so a later view of ``arr`` may share ``arr``'s base
    without referencing ``arr`` itself — tagging the underlying buffer is
    what makes every future view detectable.  No-ops when the guard is
    disabled or ``arr`` is not an ndarray, so call sites stay
    unconditional.
    """
    if not _enabled or not isinstance(arr, np.ndarray):
        return arr
    chain, node, hops = [], arr, 0
    while isinstance(node, np.ndarray) and hops < 16:
        chain.append(node)
        node = node.base
        hops += 1
    with _lock:
        if len(_registry) > _PRUNE_THRESHOLD:
            _prune_locked()
        for node in chain:
            try:
                _registry[id(node)] = (weakref.ref(node), label,
                                       *_byte_range(node))
            except TypeError:   # exotic subclass without weakref slots
                pass
    return arr


def taint_block(block) -> None:
    """Tag the raw fields of a PartyBlock-shaped object."""
    name = getattr(block, "name", "?")
    taint(block.x, f"PartyBlock[{name!r}].x (raw features)")
    taint(block.ids, f"PartyBlock[{name!r}].ids (raw sample IDs)")
    if block.y is not None:
        taint(block.y, f"PartyBlock[{name!r}].y (raw labels)")


def _is_tensor(obj) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(obj, torch.Tensor)


def _tensor_label(t) -> str | None:
    """The label of the live tagged buffer that holds a CPU tensor's
    storage; None for a tensor on another device (a new buffer)."""
    import torch
    if t.device.type != "cpu" or t.layout != torch.strided:
        return None
    storage = t.untyped_storage()
    lo = storage.data_ptr()
    hi = lo + storage.nbytes()
    if hi <= lo:
        return None
    with _lock:
        entries = list(_registry.values())
    for ref, label, first, end in entries:
        if first <= lo and hi <= end and ref() is not None:
            return label
    return None


def lookup(arr) -> str | None:
    """The taint label of ``arr`` or any array in its ``.base`` chain; for
    a CPU tensor (or a chain ending in one), of the buffer holding it."""
    if _is_tensor(arr):
        return _tensor_label(arr)
    if not isinstance(arr, np.ndarray):
        return None
    seen = 0
    while arr is not None and seen < 16:
        entry = _registry.get(id(arr))
        if entry is not None:
            ref, label = entry[:2]
            if ref() is arr:        # identity check defeats id() reuse
                return label
        base = arr.base
        if _is_tensor(base):
            return _tensor_label(base)
        arr = base if isinstance(base, np.ndarray) else None
        seen += 1
    return None


class allow_egress:
    """Thread-local allowance for a legitimate raw send (provisioning a
    party's own worker).  Pair every use with a static
    ``# egress: ok(reason)`` on the send line."""

    def __init__(self, reason: str):
        if not reason or not reason.strip():
            raise ValueError("allow_egress requires a non-empty reason — "
                             "unexplained allowances are unauditable")
        self.reason = reason

    def __enter__(self):
        _local.depth = getattr(_local, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _local.depth -= 1
        return False


def _allowed() -> bool:
    return getattr(_local, "depth", 0) > 0


def check_egress(msg, context: str = "") -> None:
    """Raise PrivacyViolationError if ``msg`` (a message pytree of dicts /
    lists / tuples / NamedTuples / arrays / tensors) contains a tainted
    array or a tensor over a tainted buffer."""
    if not _enabled or _allowed() or not _registry:
        return
    _walk(msg, "msg", context, 0)


def _walk(obj, path, context, depth):
    if depth > 12 or obj is None:
        return
    if isinstance(obj, np.ndarray) or _is_tensor(obj):
        label = lookup(obj)
        if label is not None:
            raise PrivacyViolationError(path, label, context)
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            _walk(v, f"{path}[{k!r}]", context, depth + 1)
        return
    if isinstance(obj, (list, tuple)):
        fields = getattr(obj, "_fields", None)
        if fields is not None:      # NamedTuple: name the field
            for name, v in zip(fields, obj):
                _walk(v, f"{path}.{name}", context, depth + 1)
        else:
            for i, v in enumerate(obj):
                _walk(v, f"{path}[{i}]", context, depth + 1)


def registry_size() -> int:
    with _lock:
        _prune_locked()
        return len(_registry)

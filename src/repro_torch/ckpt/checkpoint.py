"""Checkpointing: MessagePack + zstd snapshots with atomic step directories.

The JAX package's on-disk format, written and read without JAX:
  * a tree of arrays (a PartyTree forest, nested dicts, lists, tuples) is
    captured as a path -> array flat map, with the JAX package's path
    strings: a NamedTuple field is ``".field"``, a dict key is ``"key"``
    (dicts in sorted key order), a list or tuple index is ``"0"``, joined
    by ``"/"`` — so a checkpoint written by either package restores in the
    other;
  * ``step_%08d/`` holds ``arrays.msgpack.zst`` (or ``.zlib``) and the
    optional ``meta.msgpack``, published by an atomic rename so a killed
    run never leaves a half checkpoint (the paper's "modeling can be easily
    recovered from the break point" requirement, §4.1).

Arrays go to host NumPy here and nowhere else: a tensor leaf is copied off
its device when saved, and a restore puts each array back on the device of
its ``like`` leaf.  The MessagePack codec is the port's own
(ckpt/msgpack.py).  ``zstandard`` is optional: without it checkpoints are
written with stdlib ``zlib`` (the codec is recorded in the file extension,
so either build restores the other's zlib checkpoints; a .zst checkpoint
does require zstandard).
"""
from __future__ import annotations

import os
import pathlib
import shutil
import zlib
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.ckpt import msgpack

try:
    import zstandard
except ImportError:                       # pragma: no cover - env dependent
    zstandard = None

_ZSTD_NAME = "arrays.msgpack.zst"
_ZLIB_NAME = "arrays.msgpack.zlib"
_META_NAME = "meta.msgpack"


def _map_tree(fn: Callable[[str, Any], Any], tree: Any, path: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``, visited in the
    JAX package's flattening order (NamedTuple fields in order, dict keys
    sorted, sequences by index; None is an empty subtree)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, getattr(tree, f), path + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_tree(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _host(leaf: Any) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}

    def put(key, leaf):
        flat[key] = _host(leaf)
    _map_tree(put, tree)
    return flat


def save_checkpoint(directory: str | os.PathLike, step: int, tree: Any,
                    meta: dict | None = None) -> str:
    """Snapshot a tree of arrays or tensors; ``meta`` (a small dict, e.g.
    the model family tag ``Federation.save`` writes) rides inside the same
    atomic step directory as ``meta.msgpack`` — checkpoints without it read
    back as an empty dict (:func:`read_meta`)."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".tmp_step_{step:08d}"
    final = d / f"step_{step:08d}"
    flat = _flatten(tree)
    payload = {k: {"dtype": str(v.dtype), "shape": list(v.shape),
                   "data": v.tobytes()} for k, v in flat.items()}
    raw = msgpack.packb(payload)
    if tmp.exists():
        # a crashed save may have left a payload in the other codec; a stale
        # file surviving the rename would shadow the fresh one on restore
        shutil.rmtree(tmp)
    tmp.mkdir()
    if zstandard is not None:
        (tmp / _ZSTD_NAME).write_bytes(
            zstandard.ZstdCompressor(level=3).compress(raw))
    else:
        (tmp / _ZLIB_NAME).write_bytes(zlib.compress(raw, 3))
    if meta:
        (tmp / _META_NAME).write_bytes(msgpack.packb(dict(meta)))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic publish
    return str(final)


def read_meta(directory: str | os.PathLike, step: int) -> dict:
    """The ``meta`` dict a checkpoint was saved with ({} for checkpoints
    saved without one)."""
    p = pathlib.Path(directory) / f"step_{step:08d}" / _META_NAME
    if not p.exists():
        return {}
    return msgpack.unpackb(p.read_bytes())


def peek_checkpoint(directory: str | os.PathLike,
                    step: int) -> dict[str, np.ndarray]:
    """Read a checkpoint's flat path -> host array map without a ``like``
    tree.  The payload records dtype and shape per leaf, so readers that
    know the container layout (``serving/engine.py::load_forest_trees``
    rebuilding a PartyTree by field name) need nothing else."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    if (d / _ZLIB_NAME).exists():
        raw = zlib.decompress((d / _ZLIB_NAME).read_bytes())
    else:
        if zstandard is None:
            raise ModuleNotFoundError(
                f"{d / _ZSTD_NAME} is zstd-compressed but 'zstandard' is "
                "not installed; pip install zstandard to restore it")
        raw = zstandard.ZstdDecompressor().decompress(
            (d / _ZSTD_NAME).read_bytes())
    payload = msgpack.unpackb(raw)
    return {k: np.frombuffer(v["data"], dtype=v["dtype"]).reshape(v["shape"])
            for k, v in payload.items()}


def restore_checkpoint(directory: str | os.PathLike, step: int,
                       like: Any) -> Any:
    """Restore a checkpoint into the structure of ``like``.  Each leaf takes
    the dtype of its ``like`` leaf; a tensor leaf also gives the device the
    restored tensor lands on, anything else (a NumPy array) gives a host
    array.  Raises KeyError when ``like`` has a path the checkpoint lacks."""
    flat = peek_checkpoint(directory, step)

    def put(key, leaf):
        arr = flat[key]
        if torch.is_tensor(leaf):
            return torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                      dtype=leaf.dtype)
        return np.array(arr, dtype=leaf.dtype)
    return _map_tree(put, like)


def latest_step(directory: str | os.PathLike) -> int | None:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*"))
    return steps[-1] if steps else None

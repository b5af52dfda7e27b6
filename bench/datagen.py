"""The benchmark's tables, made on the device from ``--seed``.

Synthetic stand-ins for the paper's data sets at their sizes (nothing is
downloaded), with the semantics of the repository's tabular generators:

* ``classification``: blob + rotation.  Class centres ~ N(0, class_sep²)
  in an ``n_informative``-dimensional subspace, labels uniform, each row
  its centre plus unit noise, mixed into every column by a
  N(0, 1/n_informative) matrix, plus 0.5 · N(0, 1) noise a column.
* ``regression``: x ~ N(0, 1); y = x[:, :k] @ w + 0.3 · Σ|w| · sin(2 x0)
  + 0.5 · x1 · x2 + noise · N(0, 1), w ~ N(0, 1), k = n_informative.

One ``torch.Generator`` on the device draws everything in a few large
calls, in float64; the same seed gives the same table on the same device
type.  The training rows are drawn first and the held-out rows after
them, from the same draw of centres and mixing (or weights), so a table
made without its held-out rows has the same training rows.
"""
from __future__ import annotations

import math

import torch


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def split_sizes(cfg: dict) -> tuple[int, int]:
    """(training rows, held-out rows): the held-out share rounded."""
    n = int(cfg["n_rows"])
    n_test = int(round(n * float(cfg["test_frac"])))
    return n - n_test, n_test


def make_table(cfg: dict, seed: int, device, *, test: bool):
    """(x_train, y_train, x_test, y_test) as host NumPy arrays (float64
    features; int64 classes or float64 targets); the held-out pair is None
    unless ``test``."""
    gen = cfg["generator"]
    n_train, n_test = split_sizes(cfg)
    f = int(cfg["n_features"])
    ni = min(int(gen.get("n_informative") or max(2, f // 4)), f)
    g = _gen(seed, device)
    f64 = torch.float64

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=f64, device=device)

    if gen["kind"] == "classification":
        k = int(cfg["n_classes"])
        centers = randn(k, ni) * float(gen.get("class_sep", 1.2))
        mix = randn(ni, f) / math.sqrt(ni)

        def rows(n):
            y = torch.randint(0, k, (n,), generator=g, device=device)
            x = (centers[y] + randn(n, ni)) @ mix + 0.5 * randn(n, f)
            return x, y
    elif gen["kind"] == "regression":
        w = randn(ni)
        amp = 0.3 * float(w.abs().sum())
        noise = float(gen.get("noise", 0.5))

        def rows(n):
            x = randn(n, f)
            y = x[:, :ni] @ w + torch.sin(2.0 * x[:, 0]) * amp \
                + 0.5 * x[:, 1] * x[:, 2 % f] + noise * randn(n)
            return x, y
    else:
        raise ValueError(f"unknown generator kind {gen['kind']!r}")

    out = []
    for n, want in ((n_train, True), (n_test, test)):
        if not want:
            out += [None, None]
            continue
        x, y = rows(n)
        out += [x.cpu().numpy(), y.cpu().numpy()]
        del x, y
    return tuple(out)

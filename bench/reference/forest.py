"""Plain reference of the Federated Forest (arXiv:1905.10053).

An independent random-forest builder and predictor with the semantics of
the paper's system, written with NumPy and plain PyTorch only.  It runs on
any torch device (the card, after a run's window; the CPU in the tests).

What it works out again from the inputs a run hands both sides:

* the quantile bin edges of every feature (NumPy's ``quantile``, linear
  interpolation, ``n_bins - 1`` interior levels) and each value's bin
  (``side="left"``: bin b holds values in (edge[b-1], edge[b]]);
* the master's randomness: tree t draws from ``default_rng([seed, t])`` a
  bootstrap of N row indices (counted into weights), then
  ``ceil(max_features * F)`` features without replacement;
* the label encoding: classes are permuted by ``default_rng(seed)``;
  trees hold encoded classes, answers are decoded;
* CART grown level by level in heap order (node i -> 2i+1, 2i+2): a
  node's split is the (feature, bin) of largest gain, ties to the lowest
  feature id, then the lowest bin; it splits when that gain is finite and
  above ``max(min_impurity_decrease, 1e-9)`` and its weighted count is at
  least ``min_samples_split``; rows with bin > split bin go right;
* gains are absolute impurity decreases: n·gini (n - Σ n_k² / n, classes
  added in order) or the sum of squared errors (s2 - s1² / n), with both
  children at least ``min_samples_leaf`` in weighted count;
* one-round prediction: each tree's leaf for a row, its class by the
  leaf's largest count (ties to the lowest encoded class), the forest's by
  majority (ties to the lowest encoded class), or the mean of leaf means.

Histograms are exact sums in float64.  Gains are computed in ``dtype``:
float32 is the configuration's own precision, in which classification's
integer counts give the same bits on any device; bfloat16 is the control.

:func:`replay_tree` judges a forest that another program grew: it follows
that forest's own splits level by level over the reference's own bins and
draws, and reads at every node what the configuration's semantics say the
node should hold and should have chosen.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np
import torch

MIN_GAIN = 1e-9         # the split threshold's floor


@dataclasses.dataclass(frozen=True)
class Forest:
    """The forest's parameters, as the configuration file states them."""

    task: str
    n_classes: int
    n_estimators: int
    max_depth: int
    n_bins: int
    bootstrap: bool = True
    max_features: float = 1.0
    min_samples_split: int = 2
    min_samples_leaf: int = 1
    min_impurity_decrease: float = 0.0
    seed: int = 0

    @property
    def n_nodes(self) -> int:
        return 2 ** (self.max_depth + 1) - 1

    @property
    def threshold(self) -> float:
        return max(self.min_impurity_decrease, MIN_GAIN)


@dataclasses.dataclass
class Tree:
    """One tree, master view, as host arrays over the heap's nodes."""

    is_leaf: np.ndarray      # (nn,) bool
    node_stats: np.ndarray   # (nn, C) float64: weighted label stats
    split_gid: np.ndarray    # (nn,) int64: global feature, -1 where none
    split_bin: np.ndarray    # (nn,) int64: split bin, -1 where none


# ---------------------------------------------------------------- inputs
def quantile_edges(x: np.ndarray, n_bins: int, threads: int = 8) -> np.ndarray:
    """(F, n_bins - 1) float64 interior quantiles of each column of the raw
    (N, F) matrix, one column a task (NumPy releases the GIL to select)."""
    x = np.asarray(x, dtype=np.float64)
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]

    def column(f):
        return np.quantile(x[:, f], qs)

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        cols = list(pool.map(column, range(x.shape[1])))
    return np.stack(cols).astype(np.float64)


def bin_rows(x, edges: np.ndarray, device) -> torch.Tensor:
    """(N, F) int64 bins of raw rows ``x`` (host array or tensor) under
    ``edges``, computed on ``device``, a block of columns at a time."""
    e = torch.as_tensor(edges, dtype=torch.float64, device=device)
    x = torch.as_tensor(x, dtype=torch.float64)
    n, f = x.shape
    out = torch.empty((f, n), dtype=torch.uint8, device=device)
    step = max(1, (1 << 26) // max(n, 1))
    for lo in range(0, f, step):
        hi = min(f, lo + step)
        cols = x[:, lo:hi].to(device).t().contiguous()
        out[lo:hi] = torch.searchsorted(e[lo:hi].contiguous(), cols,
                                        right=False).to(torch.uint8)
    return out.t().long()


def master_draws(p: Forest, n: int, n_features: int, tree: int):
    """Tree ``tree``'s bootstrap counts (N,) float64 and feature mask (F,)."""
    rng = np.random.default_rng([p.seed, tree])
    if p.bootstrap:
        w = np.bincount(rng.integers(0, n, size=n), minlength=n)
    else:
        w = np.ones(n)
    k = max(1, int(np.ceil(p.max_features * n_features)))
    sel = np.zeros(n_features, dtype=bool)
    sel[rng.choice(n_features, size=k, replace=False)] = True
    return w.astype(np.float64), sel


def label_code(p: Forest):
    """(encode, decode) class maps of the label owner's permutation."""
    perm = np.random.default_rng(p.seed).permutation(p.n_classes)
    return perm, np.argsort(perm)


def label_stats(y: np.ndarray, p: Forest, device) -> torch.Tensor:
    """(N, C) float64 per-row label stats: one-hot encoded classes, or
    (1, y, y²)."""
    if p.task == "classification":
        enc, _ = label_code(p)
        yy = torch.as_tensor(enc[np.asarray(y, dtype=np.int64)], device=device)
        return torch.nn.functional.one_hot(yy, p.n_classes).to(torch.float64)
    yy = torch.as_tensor(np.asarray(y, dtype=np.float64), device=device)
    return torch.stack([torch.ones_like(yy), yy, yy * yy], dim=1)


# ------------------------------------------------------------- arithmetic
def count_of(s: torch.Tensor, task: str) -> torch.Tensor:
    return s.sum(-1) if task == "classification" else s[..., 0]


def impurity(s: torch.Tensor, task: str) -> torch.Tensor:
    """n·gini, or the sum of squared errors, from stats (..., C)."""
    if task == "classification":
        n = s.sum(-1)
        sq = s * s
        acc = sq[..., 0]
        for k in range(1, s.shape[-1]):
            acc = acc + sq[..., k]
        return n - acc / torch.clamp(n, min=1e-12)
    n, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    return s2 - s1 * s1 / torch.clamp(n, min=1e-12)


def gains(hist: torch.Tensor, p: Forest, dtype) -> torch.Tensor:
    """(L, F, B-1) gains of every candidate from an exact (L, F, B, C)
    float64 histogram, in ``dtype``; -inf where a child is too small."""
    prefix = torch.cumsum(hist, dim=2).to(dtype)
    left = prefix[:, :, :-1]
    total = prefix[:, :, -1]
    right = total[:, :, None] - left
    g = (impurity(total, p.task)[:, :, None] - impurity(left, p.task)
         - impurity(right, p.task))
    ok = ((count_of(left, p.task) >= p.min_samples_leaf)
          & (count_of(right, p.task) >= p.min_samples_leaf))
    return torch.where(ok, g, torch.tensor(float("-inf"), dtype=g.dtype,
                                           device=g.device))


def histogram(xb: torch.Tensor, seg: torch.Tensor, ws: torch.Tensor,
              width: int, n_bins: int) -> torch.Tensor:
    """Exact (width, F, B, C) float64 sums of ``ws`` by (node, feature,
    bin), a block of features at a time."""
    n, f = xb.shape
    c = ws.shape[1]
    out = torch.zeros((width, f, n_bins, c), dtype=torch.float64,
                      device=xb.device)
    step = max(1, (1 << 26) // max(n, 1))
    for lo in range(0, f, step):
        hi = min(f, lo + step)
        k = hi - lo
        key = ((seg[:, None] * k + torch.arange(k, device=xb.device))
               * n_bins + xb[:, lo:hi]).reshape(-1)
        for ch in range(c):
            vals = ws[:, ch].repeat_interleave(k)
            out[:, lo:hi, :, ch] = torch.bincount(
                key, weights=vals, minlength=width * k * n_bins
            ).reshape(width, k, n_bins)
    return out


def node_sums(seg: torch.Tensor, v: torch.Tensor, width: int) -> torch.Tensor:
    out = torch.zeros((width, v.shape[1]), dtype=torch.float64,
                      device=v.device)
    return out.index_add_(0, seg, v)


# ------------------------------------------------------------------ grow
def grow_tree(xb: torch.Tensor, stats: torch.Tensor, w: np.ndarray,
              sel: np.ndarray, p: Forest, dtype=torch.float32) -> Tree:
    """Grow one tree from (N, F) bins, (N, C) label stats, bootstrap
    counts ``w`` and feature mask ``sel``, gains in ``dtype``."""
    dev = xb.device
    wt = torch.as_tensor(w, device=dev)
    keep = wt > 0
    xb, ws = xb[keep], stats[keep] * wt[keep, None]
    fmask = torch.as_tensor(sel, device=dev)
    nn = p.n_nodes
    node = torch.zeros(xb.shape[0], dtype=torch.long, device=dev)
    is_leaf = torch.zeros(nn, dtype=torch.bool, device=dev)
    nstats = torch.zeros((nn, ws.shape[1]), dtype=torch.float64, device=dev)
    gid = torch.full((nn,), -1, dtype=torch.long, device=dev)
    sbin = torch.full((nn,), -1, dtype=torch.long, device=dev)
    nb1 = p.n_bins - 1
    for d in range(p.max_depth + 1):
        off, width = 2 ** d - 1, 2 ** d
        rows = torch.nonzero(node >= off).squeeze(1)
        seg = node[rows] - off
        nst = node_sums(seg, ws[rows], width)
        # the node's stats as the configuration's precision holds them
        nstats[off:off + width] = nst.to(dtype).to(torch.float64)
        cnt = count_of(nst.to(dtype), p.task)
        if d == p.max_depth:
            is_leaf[off:off + width] = cnt > 0
            break
        g = gains(histogram(xb[rows], seg, ws[rows], width, p.n_bins), p,
                  dtype)
        g = torch.where(fmask[None, :, None], g,
                        torch.tensor(float("-inf"), dtype=g.dtype, device=dev))
        flat = g.reshape(width, -1)
        arg = flat.argmax(1)                    # first max: lowest f, then b
        best = flat.gather(1, arg[:, None])[:, 0]
        split = (torch.isfinite(best) & (best > p.threshold)
                 & (cnt >= p.min_samples_split))
        lvl = slice(off, off + width)
        is_leaf[lvl] = (cnt > 0) & ~split
        gid[lvl] = torch.where(split, arg // nb1, -1)
        sbin[lvl] = torch.where(split, arg % nb1, -1)
        s = split[seg]
        col = gid[lvl][seg].clamp(min=0)
        right = xb[rows, col] > sbin[lvl][seg]
        node[rows] = torch.where(s, 2 * node[rows] + 1 + right.long(),
                                 node[rows])
    return Tree(is_leaf.cpu().numpy(), nstats.cpu().numpy(),
                gid.cpu().numpy(), sbin.cpu().numpy())


def grow_forest(xb: torch.Tensor, y: np.ndarray, p: Forest,
                dtype=torch.float32) -> list[Tree]:
    stats = label_stats(y, p, xb.device)
    n, f = xb.shape
    out = []
    for t in range(p.n_estimators):
        w, sel = master_draws(p, n, f, t)
        out.append(grow_tree(xb, stats, w, sel, p, dtype))
    return out


# --------------------------------------------------------------- predict
def leaves(tree: Tree, xb: torch.Tensor, max_depth: int) -> torch.Tensor:
    """(N,) heap id of each row's leaf."""
    dev = xb.device
    is_leaf = torch.as_tensor(tree.is_leaf, device=dev)
    gid = torch.as_tensor(tree.split_gid, device=dev)
    sbin = torch.as_tensor(tree.split_bin, device=dev)
    rows = torch.arange(xb.shape[0], device=dev)
    node = torch.zeros(xb.shape[0], dtype=torch.long, device=dev)
    for _ in range(max_depth):
        go = (gid[node] >= 0) & ~is_leaf[node]
        right = xb[rows, gid[node].clamp(min=0)] > sbin[node]
        node = torch.where(go, 2 * node + 1 + right.long(), node)
    return node


def predict(trees: list[Tree], xb: torch.Tensor, p: Forest) -> np.ndarray:
    """The forest's answers for (N, F) bins: decoded classes or values."""
    dev = xb.device
    per_tree = []
    for tr in trees:
        st = torch.as_tensor(tr.node_stats, device=dev)[
            leaves(tr, xb, p.max_depth)]
        if p.task == "classification":
            per_tree.append(st.argmax(-1))
        else:
            per_tree.append(st[:, 1] / torch.clamp(st[:, 0], min=1e-12))
    per_tree = torch.stack(per_tree)
    if p.task == "classification":
        votes = torch.nn.functional.one_hot(per_tree, p.n_classes).sum(0)
        _, dec = label_code(p)
        return dec[votes.argmax(-1).cpu().numpy()]
    return per_tree.mean(0).cpu().numpy()


# ---------------------------------------------------------------- replay
@dataclasses.dataclass
class Reading:
    """What a replay of one or more trees found.

    ``split_regret``: the largest gain a node gave up, over its gain
    scale (weighted count for classification, Σ w·y² for regression):
    the best candidate's gain less the gain of the split the tree took
    (or less nothing, for a node it left a leaf), exact arithmetic.
    ``stat_err``: the largest gap between a node's stats and the exact
    sums, over the node's sum of |stat| in that channel.
    ``bad_nodes``: nodes that break the semantics outright (a split with
    no valid candidate, a leaf or a split where no row is, a live node
    that is neither, a split on a feature outside the tree's draw).
    ``counts``: per depth, for the roofline: rows and nodes searched
    (weighted count >= min_samples_split), rows routed by a split, live
    nodes."""

    split_regret: float = 0.0
    stat_err: float = 0.0
    bad_nodes: int = 0
    counts: list = dataclasses.field(default_factory=list)

    def merge(self, other: "Reading") -> "Reading":
        return Reading(max(self.split_regret, other.split_regret),
                       max(self.stat_err, other.stat_err),
                       self.bad_nodes + other.bad_nodes,
                       self.counts + other.counts)


def replay_tree(tree: Tree, xb: torch.Tensor, stats: torch.Tensor,
                w: np.ndarray, sel: np.ndarray, p: Forest) -> Reading:
    """Judge ``tree`` (grown elsewhere) against the exact semantics on the
    reference's own bins ``xb``, stats and draws."""
    dev = xb.device
    wt = torch.as_tensor(w, device=dev)
    keep = wt > 0
    xb, ws = xb[keep], stats[keep] * wt[keep, None]
    wabs = ws.abs()
    fmask = torch.as_tensor(sel, device=dev)
    is_leaf = torch.as_tensor(tree.is_leaf, device=dev)
    prog = torch.as_tensor(tree.node_stats, dtype=torch.float64, device=dev)
    gid = torch.as_tensor(tree.split_gid, device=dev).long()
    sbin = torch.as_tensor(tree.split_bin, device=dev).long()
    f = xb.shape[1]
    node = torch.zeros(xb.shape[0], dtype=torch.long, device=dev)
    regret, err, bad, counts = 0.0, 0.0, 0, []
    for d in range(p.max_depth + 1):
        off, width = 2 ** d - 1, 2 ** d
        lvl = slice(off, off + width)
        rows = torch.nonzero(node >= off).squeeze(1)
        seg = node[rows] - off
        nst = node_sums(seg, ws[rows], width)
        scale = node_sums(seg, wabs[rows], width)
        gap = (prog[lvl] - nst).abs()
        rel = torch.where(scale > 0, gap / scale.clamp(min=1e-300),
                          torch.where(gap > 0, torch.inf, 0.0))
        err = max(err, float(rel.max()))
        cnt = count_of(nst, p.task)
        live = cnt > 0
        split = gid[lvl] >= 0
        leaf = is_leaf[lvl]
        bad += int((leaf & ~live).sum() + (split & ~live).sum()
                   + (live & ~leaf & ~split).sum() + (leaf & split).sum())
        if d == p.max_depth:
            bad += int(split.sum())
            counts.append({"depth": d, "live_nodes": int(live.sum()),
                           "rows": int(rows.numel()), "search_rows": 0,
                           "search_nodes": 0, "split_rows": 0})
            break
        bad += int((split & (cnt < p.min_samples_split)).sum())
        bad += int((split & ((gid[lvl] >= f) | (sbin[lvl] < 0)
                             | (sbin[lvl] >= p.n_bins - 1))).sum())
        g = gains(histogram(xb[rows], seg, ws[rows], width, p.n_bins), p,
                  torch.float64)
        g = torch.where(fmask[None, :, None], g, -torch.inf)
        best = g.reshape(width, -1).amax(1)
        gi = gid[lvl].clamp(0, f - 1)
        bi = sbin[lvl].clamp(0, p.n_bins - 2)
        took = g[torch.arange(width, device=dev), gi, bi]
        bad += int((split & ~torch.isfinite(took)).sum())
        searched = live & (cnt >= p.min_samples_split)
        missed = torch.where(split, best - took,
                             torch.where(searched & leaf, best.clamp(min=0),
                                         0.0))
        missed = torch.where(torch.isfinite(missed), missed, 0.0)
        gscale = cnt if p.task == "classification" else nst[:, 2]
        r = torch.where(missed > 0, missed / gscale.clamp(min=1e-300), 0.0)
        regret = max(regret, float(r.max()))
        s = split[seg]
        in_search = searched[seg]
        counts.append({"depth": d, "live_nodes": int(live.sum()),
                       "rows": int(rows.numel()),
                       "search_rows": int(in_search.sum()),
                       "search_nodes": int(searched.sum()),
                       "split_rows": int(s.sum())})
        right = xb[rows, gid[lvl][seg].clamp(0, f - 1)] > sbin[lvl][seg]
        node[rows] = torch.where(s, 2 * node[rows] + 1 + right.long(),
                                 node[rows])
    return Reading(regret, err, bad, [counts])


def master_view(fields: dict, groups: list[np.ndarray],
                n_features: int) -> tuple[Tree, int]:
    """One tree of every party's view (``fields``: the program's seven
    arrays, each (M, nn, ...)), checked for the federated layout and read
    as the master's tree.  ``groups[i]`` are party i's global features.
    Returns the tree and the count of nodes whose views disagree: a
    shared field that differs between parties, an owner that does not
    hold the split's feature, or a party whose own split marks, local
    feature or bin do not match."""
    m = fields["is_leaf"].shape[0]
    bad = 0
    for name in ("is_leaf", "leaf_stats", "owner", "split_gid"):
        a = np.asarray(fields[name])
        diff = (a != a[:1]).reshape(m, a.shape[1], -1).any(-1).any(0)
        bad += int(diff.sum())
    gid = np.asarray(fields["split_gid"][0]).astype(np.int64)
    owner = np.asarray(fields["owner"][0]).astype(np.int64)
    split = gid >= 0
    owner_of = np.full(n_features, -1, dtype=np.int64)
    local_of = np.full(n_features, -1, dtype=np.int64)
    for i, g in enumerate(groups):
        owner_of[g] = i
        local_of[g] = np.arange(len(g))
    g0 = np.clip(gid, 0, n_features - 1)
    bad += int((owner != np.where(split, owner_of[g0], -1)).sum())
    sbin = np.full(gid.shape, -1, dtype=np.int64)
    for i in range(m):
        mine = split & (owner == i)
        has = np.asarray(fields["has_split"][i]).astype(bool)
        floc = np.asarray(fields["split_floc"][i]).astype(np.int64)
        b = np.asarray(fields["split_bin"][i]).astype(np.int64)
        bad += int((has != mine).sum())
        bad += int((floc != np.where(mine, local_of[g0], -1)).sum())
        bad += int((~mine & (b != -1)).sum())
        sbin = np.where(mine, b, sbin)
    tree = Tree(np.asarray(fields["is_leaf"][0]).astype(bool),
                np.asarray(fields["leaf_stats"][0], dtype=np.float64),
                gid, sbin)
    return tree, bad

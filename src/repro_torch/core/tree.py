"""Level-synchronous federated CART tree building (the paper's Alg. 1/2/5/6).

The JAX package writes tree building once per party and runs it under
``vmap``/``shard_map`` over a named party axis.  Here the party axis is an
explicit leading tensor dimension M, in one program:

  * the JAX ``lax.all_gather`` of every party's local best split is the
    stacked (M, width) tensor the local search already returns;
  * the owner's routing ``lax.psum`` is a sum over that dimension;
  * the shared state (the samples' node, the node stats) exists once.

Breadth-first level building: all ``2^d`` nodes of a depth split together;
trees live in fixed-shape heap arrays (node i -> children 2i+1, 2i+2).

The histogram is the hot spot.  Within one level every party histograms the
same slots and stats over its own features, so the parties' columns are
folded into one (N, M*Fp) feature-major tensor once per fit
(:func:`fold_parties`) and one launch per level serves them all.  The CUDA
kernel sums each feature in an order that does not depend on the other
features, so every party gets exactly the bits it would get alone.

Frontier compaction: at depths where the heap level is wider than
``params.frontier_cap``, live nodes are remapped (in heap order) into
``cap`` compact slots per pass and the histogram -> gains -> per-node argbest
stage runs over those slots; results are scattered back to heap order, so
the built ``PartyTree`` is bit-identical to the dense build.

The level loop writes in place into a :class:`TreeState` made once, in
pieces that read no value to the host.  On CUDA tensors in process each
piece is replayed from a CUDA graph cached across trees and fits
(core/tree_graphs.py); everywhere else the same pieces run eagerly.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.core import impurity, tree_graphs
from repro_torch.core.types import ForestParams
from repro_torch.kernels import ops
from repro_torch.observability import registry as telemetry
from repro_torch.observability import trace as tracing

_BIG = 2**30
_NEG_INF = float("-inf")

# every read of a device value by the host in the fit path, bound once
_M_HOST_SYNCS = telemetry.REGISTRY.counter("forest.host_syncs")


class PartyTree(NamedTuple):
    """Every party's view of a tree or a forest.

    Each field has leading axes (M,) for one tree and (M, T) for a forest,
    then n_nodes = 2^(k+1)-1 heap slots.  The shared fields are the same in
    every party's row, as they are in the JAX package's party stack."""

    is_leaf: torch.Tensor      # bool    — shared structure
    leaf_stats: torch.Tensor   # f32 (.., C) — shared (labels are shared, §4.3)
    has_split: torch.Tensor    # bool    — "this node's split is mine"
    split_floc: torch.Tensor   # int32   — LOCAL feature index (mine only)
    split_bin: torch.Tensor    # int32   — split bin   (mine only)
    owner: torch.Tensor        # int32   — master view: owning party
    split_gid: torch.Tensor    # int32   — master view: encoded feature id


def fold_parties(xb: torch.Tensor, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """(M, N, Fp) party bins -> (N, M*Fp) uint8 feature-major: party i's
    local feature j is column i*Fp + j, stored as a contiguous (M*Fp, N)
    tensor so the histogram kernel reads each column contiguously.  With
    ``out`` (such a tensor) the fold is written into it."""
    m, n, fp = xb.shape
    if out is None:
        return xb.to(torch.uint8).permute(0, 2, 1).contiguous().view(
            m * fp, n).t()
    out.t().view(m, fp, n).copy_(xb.permute(0, 2, 1))
    return out


def _local_argbest(gains: torch.Tensor, feat_gid: torch.Tensor):
    """Per-party, per-node best split with the deterministic lexicographic
    tie-break (max gain, then min global feature id, then min bin).

    ``gains`` is (M, L, Fp, B-1), ``feat_gid`` (M, Fp); returns (gain, gid,
    bin, floc), each (M, L).  The two-stage max — local per party, then
    global across parties (:func:`reduce_level`) — yields exactly the winner
    of a centralized single pass, because max and the lexicographic
    tie-break are associative: FF(M) == FF(1) bit for bit."""
    bm1, fp = gains.shape[3], gains.shape[2]
    dev = gains.device
    g = gains.amax(dim=(2, 3))
    elig = (gains == g[:, :, None, None]) & torch.isfinite(gains)
    gid_m = feat_gid.to(torch.int32)[:, None, :, None]
    gid = torch.where(elig, gid_m, _BIG).amin(dim=(2, 3))
    sel = elig & (gid_m == gid[:, :, None, None])
    bin_m = torch.arange(bm1, dtype=torch.int32, device=dev)[None, None, None, :]
    bin_ = torch.where(sel, bin_m, _BIG).amin(dim=(2, 3))
    floc_m = torch.arange(fp, dtype=torch.int32, device=dev)[None, None, :, None]
    floc = torch.where(sel, floc_m, _BIG).amin(dim=(2, 3))
    return g, gid, bin_, floc


def reduce_level(g_all, gid_all, bin_all, cnt, params: ForestParams):
    """The paper's master reduce over one level's stacked party bests.

    ``g_all``/``gid_all``/``bin_all`` are the (M, width) per-party best
    (gain, global feature id, bin); ``cnt`` the (width,) shared node sample
    counts.  Returns ``(do_split, owner_lv, gid_best, bin_best)``: max gain
    with the lexicographic tie-break (min gid, then min bin via min owner),
    gated on the impurity threshold and ``min_samples_split``.  Pure
    max/min/compare arithmetic, exact in any execution order."""
    g_best = g_all.amax(0)
    elig = (g_all == g_best[None]) & torch.isfinite(g_all)
    gid_best = torch.where(elig, gid_all, _BIG).amin(0)
    sel = elig & (gid_all == gid_best[None])
    m = g_all.shape[0]
    parties = torch.arange(m, dtype=torch.int32, device=g_all.device)
    owner_lv = torch.where(sel, parties[:, None], _BIG).amin(0)
    bin_best = torch.where(sel, bin_all, _BIG).amin(0)
    thr = max(params.min_impurity_decrease, 1e-9)
    do_split = (torch.isfinite(g_best) & (g_best > thr)
                & (cnt >= params.min_samples_split))
    return do_split, owner_lv, gid_best, bin_best


def _party_argbest(gains, fmask, feat_gid):
    """Folded (L, M*Fp, B-1) gains -> per-party masked argbest, (M, L) each."""
    width, _, bm1 = gains.shape
    m, fp = feat_gid.shape
    g = gains.reshape(width, m, fp, bm1).permute(1, 0, 2, 3)
    g = torch.where(fmask[:, None, :, None], g, _NEG_INF)
    return _local_argbest(g, feat_gid)


def _frontier_cap(params: ForestParams, depth: int, n: int) -> int | None:
    """The compact slots of one pass at ``depth``, or None where the level
    runs dense (every heap slot at once)."""
    width = 2 ** depth
    cap = min(width, n, params.frontier_cap or width)
    return cap if params.frontier_cap and cap < width else None


class TreeState:
    """Everything one tree's level loop reads and writes, made once and
    written in place: the inputs, the samples' nodes, the heap fields, the
    frontier's slot maps and bests, and (``hist_subtraction``) the parent
    histograms.  A tree starts by resetting its heap (:meth:`head` at
    level 0), so one state serves tree after tree.

    The loop runs in pieces — a dense level (:meth:`dense`), the leaf level
    (:meth:`leaf`), and a frontier level as :meth:`frontier_prologue`, one
    :meth:`frontier_pass` a pass and :meth:`frontier_epilogue` — which take
    and leave everything they share in these tensors.  Eagerly they are the
    whole build; on the card each is also what one CUDA graph replays
    (core/tree_graphs.py), since a piece reads no value to the host."""

    def __init__(self, xb, feat_gid, feat_sel, weight, y_stats,
                 params: ForestParams, hist_impl: str, parties):
        n, mf = xb.shape
        m, fp = feat_gid.shape
        c = y_stats.shape[-1]
        nn = params.n_nodes
        dev = xb.device
        i32, f32 = torch.int32, torch.float32
        self.params, self.hist_impl = params, hist_impl
        self.xb, self.feat_gid, self.feat_sel = xb, feat_gid, feat_sel
        self.weight, self.y_stats = weight, y_stats
        # global party indices of the local rows; their columns in the fold
        self.parties = parties
        self.col_base = (torch.arange(m, dtype=i32, device=dev) * fp)[:, None]
        # node stats come from the same histogram over a single all-zero
        # column: a plain index_add_ would add with float atomics on the card
        self.zero_col = torch.zeros((1, n), dtype=torch.uint8, device=dev).t()
        self.fmask = torch.empty((m, fp), dtype=torch.bool, device=dev)
        self.wstats = torch.empty(
            (n, c), dtype=torch.promote_types(f32, weight.dtype), device=dev)
        self.node = torch.empty(n, dtype=i32, device=dev)
        self.seg = torch.empty(n, dtype=i32, device=dev)     # level slot
        self.cnt = torch.empty(2 ** params.max_depth, dtype=f32, device=dev)
        self.is_leaf = torch.empty(nn, dtype=torch.bool, device=dev)
        self.leaf_stats = torch.empty((nn, c), dtype=f32, device=dev)
        self.has_split = torch.empty((m, nn), dtype=torch.bool, device=dev)
        self.split_floc = torch.empty((m, nn), dtype=i32, device=dev)
        self.split_bin = torch.empty((m, nn), dtype=i32, device=dev)
        self.owner = torch.empty(nn, dtype=i32, device=dev)
        self.split_gid = torch.empty(nn, dtype=i32, device=dev)
        frontier = [d for d in range(params.max_depth)
                    if _frontier_cap(params, d, n) is not None]
        if frontier:
            w = 2 ** frontier[-1]
            self.occ = torch.empty(w + 1, dtype=torch.bool, device=dev)
            self.slot_of_node = torch.empty(w, dtype=i32, device=dev)
            self.sslot = torch.empty(n, dtype=i32, device=dev)
            self.n_live = torch.empty((), dtype=torch.int64, device=dev)
            # per-node bests in heap order; column w takes a pass's unused
            # slots
            self.g_lv = torch.empty((m, w + 1), dtype=f32, device=dev)
            self.gid_lv, self.bin_lv, self.floc_lv = (
                torch.empty((m, w + 1), dtype=i32, device=dev)
                for _ in range(3))
        # the parent histograms a dense level leaves to its children
        kept = [d for d in range(params.max_depth - 1)
                if params.hist_subtraction
                and _frontier_cap(params, d + 1, n) is None]
        self.hist = (torch.empty((2 ** kept[-1], mf, params.n_bins, c),
                                 dtype=f32, device=dev) if kept else None)

    def hist_shapes(self) -> list[tuple[int, int, int, int, int]]:
        """``(n, f, n_level, n_bins, c)`` of every histogram a tree can
        launch."""
        p = self.params
        (n, mf), c = self.xb.shape, self.wstats.shape[1]
        out = []
        for d in range(p.max_depth + 1):
            width = 2 ** d
            out.append((n, 1, width, 1, c))
            if d < p.max_depth:
                cap = _frontier_cap(p, d, n)
                out.append((n, mf, cap or width, p.n_bins, c))
                if cap is None and p.hist_subtraction and d > 0:
                    out.append((n, mf, width // 2, p.n_bins, c))
        return out

    def tree(self) -> PartyTree:
        """The tree grown last, fields with leading (M,)."""
        m = self.has_split.shape[0]

        def shared(a):      # every party holds the same row
            return a.expand(m, *a.shape)
        return PartyTree(shared(self.is_leaf), shared(self.leaf_stats),
                         self.has_split, self.split_floc, self.split_bin,
                         shared(self.owner), shared(self.split_gid))

    # ---- the pieces of a level ------------------------------------------
    def head(self, d: int) -> None:
        """The samples' slots at level ``d`` and the level's node stats —
        computed identically by every party (shared y).  Level 0 first
        starts the tree: the masked features, the weighted stats, a fresh
        heap with every sample at the root."""
        p = self.params
        if d == 0:
            gid = self.feat_gid
            self.fmask.copy_((gid >= 0)
                             & self.feat_sel[gid.clamp(min=0).long()])
            torch.mul(self.y_stats.to(torch.float32), self.weight[:, None],
                      out=self.wstats)
            self.node.zero_()
            self.is_leaf.zero_()
            self.leaf_stats.zero_()
            self.has_split.zero_()
            for a in (self.split_floc, self.split_bin, self.owner,
                      self.split_gid):
                a.fill_(-1)
        off, width = p.level_slice(d)
        nil = self.node - off
        self.seg.copy_(torch.where((nil >= 0) & (nil < width), nil, -1))
        nstats = ops.histogram(self.zero_col, self.seg, self.wstats, width, 1,
                               impl=self.hist_impl)[:, 0, 0, :]
        self.cnt[:width] = impurity.count_of(nstats, p.task)
        self.leaf_stats[off:off + width] = nstats

    def leaf(self, d: int) -> None:
        """The bottom level: every alive node is a leaf."""
        off, width = self.params.level_slice(d)
        self.head(d)
        self.is_leaf[off:off + width] = self.cnt[:width] > 0

    def dense(self, d: int, comm=None) -> None:
        """A level whose every heap slot is histogrammed at once, then
        reduced and routed (:meth:`tail`)."""
        p = self.params
        self.head(d)
        width = 2 ** d
        seg = self.seg
        if p.hist_subtraction and d > 0:
            # histogram only the LEFT children (half the node width),
            # derive the right siblings from the retained parent
            # histograms.  Children of leaf parents get garbage rows, but
            # do_split is gated on the true sample counts, so they can
            # never be selected.
            half = width // 2
            left_seg = torch.where((seg >= 0) & (seg % 2 == 0), seg // 2, -1)
            hist_left = ops.histogram(self.xb, left_seg, self.wstats, half,
                                      p.n_bins, impl=self.hist_impl)
            hist = torch.stack([hist_left, self.hist[:half] - hist_left],
                               dim=1).reshape(width, *hist_left.shape[1:])
        else:
            hist = ops.histogram(self.xb, seg, self.wstats, width, p.n_bins,
                                 impl=self.hist_impl)
        if self.hist is not None and width <= self.hist.shape[0]:
            self.hist[:width] = hist
        gains = impurity.split_gains(hist, p.task, p.min_samples_leaf)
        self.tail(d, _party_argbest(gains, self.fmask, self.feat_gid), comm)

    def frontier_prologue(self, d: int) -> None:
        """A compacted level up to its live count: live node j (heap-level
        index, any routed sample) gets compact slot ``rank(j among live)``,
        every sample its node's slot, and the bests their -inf/_BIG
        defaults, which ``do_split`` can never select."""
        self.head(d)
        width = 2 ** d
        seg = self.seg
        dump = torch.where(seg >= 0, seg, width).long()
        occ = self.occ[:width + 1]
        occ.zero_()
        occ.index_fill_(0, dump, True)
        occ = occ[:width]
        slot = self.slot_of_node[:width]
        slot.copy_(torch.cumsum(occ.to(torch.int32), 0, dtype=torch.int32)
                   - 1)
        self.n_live.copy_(occ.sum())
        self.sslot.copy_(torch.where(seg >= 0, slot[seg.clamp(min=0).long()],
                                     -1))
        self.g_lv[:, :width + 1].fill_(_NEG_INF)
        for a in (self.gid_lv, self.bin_lv, self.floc_lv):
            a[:, :width + 1].fill_(_BIG)

    def frontier_pass(self, d: int, k: int) -> None:
        """Pass ``k`` of a compacted level: histogram slots [k*cap,
        (k+1)*cap) and scatter their bests back to heap order.  Each live
        node's histogram row accumulates exactly the samples the dense row
        would, so the per-node results equal the dense search's."""
        p = self.params
        width = 2 ** d
        cap = _frontier_cap(p, d, self.xb.shape[0])
        lo = k * cap
        dev = self.xb.device
        sslot = self.sslot
        in_pass = (sslot >= lo) & (sslot < lo + cap)
        seg_k = torch.where(in_pass, sslot - lo, -1)
        hist = ops.histogram(self.xb, seg_k, self.wstats, cap, p.n_bins,
                             impl=self.hist_impl)
        gains = impurity.split_gains(hist, p.task, p.min_samples_leaf)
        bests = _party_argbest(gains, self.fmask, self.feat_gid)
        # slot -> heap-level node of THIS pass (slot cap / column width are
        # the dump targets of the unused entries, sliced off below)
        occ, slot = self.occ[:width], self.slot_of_node[:width]
        node_in_pass = occ & (slot >= lo) & (slot < lo + cap)
        tgt = torch.where(node_in_pass, slot - lo, cap).long()
        inv = torch.full((cap + 1,), width, dtype=torch.long, device=dev)
        inv[tgt] = torch.where(node_in_pass,
                               torch.arange(width, device=dev), width)
        inv = inv[:cap]
        for a, b in zip((self.g_lv, self.gid_lv, self.bin_lv, self.floc_lv),
                        bests):
            a[:, :width + 1][:, inv] = b

    def frontier_epilogue(self, d: int, comm=None) -> None:
        """A compacted level after its passes: reduce and route."""
        width = 2 ** d
        self.tail(d, tuple(a[:, :width] for a in (
            self.g_lv, self.gid_lv, self.bin_lv, self.floc_lv)), comm)

    def tail(self, d: int, bests, comm=None) -> None:
        """The paper's master reduce of the level's (M, width) bests and the
        owner's partition: the level's heap fields and every sample's next
        node."""
        p = self.params
        g_loc, gid_loc, bin_loc, floc_loc = bests
        off, width = p.level_slice(d)
        lvl = slice(off, off + width)
        i32 = torch.int32
        cnt = self.cnt[:width]
        # ---- the paper's master: the (M, width) stack is the all_gather
        if comm is not None:
            g_all, gid_all, bin_all = comm.all_gather(
                g_loc[0], gid_loc[0], bin_loc[0])
        else:
            g_all, gid_all, bin_all = g_loc, gid_loc, bin_loc
        do_split, owner_lv, gid_best, bin_best = reduce_level(
            g_all, gid_all, bin_all, cnt, p)
        self.is_leaf[lvl] = (cnt > 0) & ~do_split

        mine = do_split[None] & (owner_lv[None]
                                 == self.parties[:, None])          # (M, W)
        self.has_split[:, lvl] = mine
        self.split_floc[:, lvl] = torch.where(mine, floc_loc, -1)
        self.split_bin[:, lvl] = torch.where(mine, bin_loc, -1)
        self.owner[lvl] = torch.where(do_split, owner_lv, -1)
        self.split_gid[lvl] = torch.where(do_split, gid_best, -1)

        # ---- owner computes the partition; a sum over parties broadcasts
        # it (paper Alg.2: "Receive split indices from client j and
        # broadcast").  A sample outside the level reads slot 0's entries,
        # which in_lvl masks.
        seg = self.seg
        in_lvl = seg >= 0
        nil_c = seg.clamp(0, width - 1).long()
        floc_lv = torch.where(mine, floc_loc, 0)
        bin_lv = torch.where(mine, bin_loc, 0)
        mine_s = in_lvl[None] & mine[:, nil_c]                        # (M, N)
        cols = (self.col_base + floc_lv[:, nil_c]).long()             # (M, N)
        vals = torch.gather(self.xb, 1, cols.t()).t().to(i32)         # (M, N)
        go_r_loc = torch.where(mine_s, (vals > bin_lv[:, nil_c]).to(i32), 0)
        go_r = go_r_loc.sum(0, dtype=i32)  # exactly one party contributes
        if comm is not None:
            go_r = comm.psum(go_r)
        advance = in_lvl & do_split[nil_c]
        node = self.node
        node.copy_(torch.where(advance, 2 * node + 1 + go_r, node))


def _eager(key, piece) -> bool:
    """Run a piece of the level loop as it is (no graph)."""
    piece()
    return False


def _grow(st: TreeState, tree: int, run=_eager, comm=None) -> None:
    """One tree's level loop over ``st``.  ``run(key, piece)`` runs each
    piece — eagerly, or from the CUDA graph captured for ``key`` — and says
    whether it replayed a graph.

    A compacted level reads its live count to the host once (one sync,
    counted on ``forest.host_syncs``) and runs as many passes as it needs;
    the JAX package runs them in a ``while_loop`` on the device."""
    p = st.params
    n = st.xb.shape[0]
    for d in range(p.max_depth + 1):
        off, width = p.level_slice(d)
        cap = _frontier_cap(p, d, n)
        with tracing.TRACER.span("tree.level", tree=tree, level=d,
                                 width=width) as level_span:
            if d == p.max_depth:        # bottom level: all alive are leaves
                replayed = run(("leaf", d), functools.partial(st.leaf, d))
                level_span.set(path="leaf", passes=0)
            elif cap is None:
                replayed = run(("dense", d),
                               functools.partial(st.dense, d, comm))
                level_span.set(path="dense", passes=1)
            else:
                replayed = run(("prologue", d),
                               functools.partial(st.frontier_prologue, d))
                with tracing.TRACER.span("tree.live_count", level=d):
                    n_live = int(st.n_live)
                _M_HOST_SYNCS.inc()
                passes = -(-n_live // cap)
                for k in range(passes):
                    run(("pass", d, k),
                        functools.partial(st.frontier_pass, d, k))
                run(("epilogue", d),
                    functools.partial(st.frontier_epilogue, d, comm))
                level_span.set(path="frontier", passes=passes)
            if replayed:
                level_span.set(graph=1)


def _on_graphs(xb: torch.Tensor, comm) -> bool:
    """Whether the level loop replays CUDA graphs: for CUDA tensors in
    process, outside any dispatch mode.  A party process or a sharded rank
    (``comm``) runs collectives that no graph captures; a fake or counting
    dispatch mode (the dry run) runs no kernel."""
    return (xb.is_cuda and comm is None
            and _get_current_dispatch_mode() is None)


def _graphs_for(n: int, mf: int, feat_gid, feat_sel, weight, y_stats,
                params: ForestParams, hist_impl: str):
    """The cached level graphs of a tree of these shapes and parameters
    (core/tree_graphs.py), made with their static state on first use."""
    dev = feat_gid.device
    m, fp = feat_gid.shape
    c = y_stats.shape[-1]
    impl = ops.resolve_backend(hist_impl, dev)
    key = (dev, n, m, fp, feat_sel.shape[-1], c, weight.dtype, y_stats.dtype,
           params.task, params.max_depth, params.n_bins, params.frontier_cap,
           params.hist_subtraction, params.min_samples_leaf,
           params.min_samples_split, params.min_impurity_decrease, impl)

    def state() -> TreeState:
        return TreeState(
            torch.empty((mf, n), dtype=torch.uint8, device=dev).t(),
            torch.empty((m, fp), dtype=torch.int32, device=dev),
            torch.empty(feat_sel.shape[-1], dtype=torch.bool, device=dev),
            torch.empty(n, dtype=weight.dtype, device=dev),
            torch.empty((n, c), dtype=y_stats.dtype, device=dev),
            params, impl, torch.arange(m, dtype=torch.int32, device=dev))
    return tree_graphs.level_graphs(key, state)


def build_tree(xb: torch.Tensor, feat_gid: torch.Tensor, feat_sel: torch.Tensor,
               weight: torch.Tensor, y_stats: torch.Tensor,
               params: ForestParams, *,
               hist_impl: str | None = None, comm=None,
               tree: int = 0) -> PartyTree:
    """Build one tree for all M parties at once.

    With ``comm`` (a ``federation.distributed.Comm``) this is one party's
    process of the party-per-process substrate: ``xb``/``feat_gid`` hold
    its own columns alone (M = 1), the level's bests are gathered and the
    routing bits summed over the wire, and everything else — the same
    histogram, gains, argbest and master reduce — runs exactly as in
    process, so the tree is the simulated one bit for bit.

    On CUDA tensors in process (:func:`_on_graphs`) the level loop runs
    from CUDA graphs cached for these shapes (core/tree_graphs.py): the
    same pieces, kernels and operands, replayed.  The inputs are copied
    into the cache's static tensors (nothing is copied for the ones that
    are those tensors, as :func:`build_forest` passes them), and the
    returned fields are the cache's own, valid until the next tree of the
    same shapes: copy what is kept.

    Args:
      xb:       (N, M*Fp) uint8 folded party bins (:func:`fold_parties`).
      feat_gid: (M, Fp) int32 global feature ids, -1 for padding.
      feat_sel: (F,) bool master's per-tree feature subsample (global ids).
      weight:   (N,) float32 bootstrap weights (0 excludes a sample).
      y_stats:  (N, C) label stat channels — shared across parties (the paper
                copies encrypted labels to every client, §3.1).
      hist_impl: histogram backend override; None uses ``params.hist_impl``.
      comm:     the wire collectives of a party process; None in process.
      tree:     the tree's index in its forest, for the ``tree.level`` spans
                (one a level: ``level``, ``width``, ``path`` — dense,
                frontier or leaf — histogram ``passes``, and ``graph`` = 1
                where the level was replayed).
    Returns:
      the tree's PartyTree, fields with leading (M,).
    """
    hist_impl = params.hist_impl if hist_impl is None else hist_impl
    if _on_graphs(xb, comm):
        graphs = _graphs_for(xb.shape[0], xb.shape[1], feat_gid, feat_sel,
                             weight, y_stats, params, hist_impl)
        with graphs.lock:
            st = graphs.state
            for dst, src in ((st.xb, xb), (st.feat_gid, feat_gid),
                             (st.feat_sel, feat_sel), (st.weight, weight),
                             (st.y_stats, y_stats)):
                if src is not dst:
                    dst.copy_(src)
            _grow(st, tree, graphs.run)
            graphs.warm = True
        return st.tree()
    m = feat_gid.shape[0]
    dev = xb.device
    parties = (torch.arange(m, dtype=torch.int32, device=dev) if comm is None
               else torch.tensor([comm.party_index], dtype=torch.int32,
                                 device=dev))
    st = TreeState(xb, feat_gid.to(torch.int32), feat_sel, weight, y_stats,
                   params, hist_impl, parties)
    _grow(st, tree, comm=comm)
    return st.tree()


def build_forest(xb, feat_gid, feat_sels, weights, y_stats,
                 params: ForestParams, *,
                 hist_impl: str | None = None) -> PartyTree:
    """Bagging loop: build T trees, each copied into the (M, T, ...)
    fields of the forest.

    ``xb`` is the (M, N, Fp) party stack; it is folded once for the whole
    fit, on the card straight into the level graphs' static bins (with the
    labels and feature ids), so the trees copy no input but their own
    draws.  Trees build one after another — ``params.trees_per_batch`` only
    regroups the JAX package's bagging map and never changes a tree, so it
    has nothing to select here."""
    hist_impl = params.hist_impl if hist_impl is None else hist_impl
    m, n, fp = xb.shape
    n_trees = feat_sels.shape[0]
    if _on_graphs(xb, None):
        graphs = _graphs_for(n, m * fp, feat_gid, feat_sels[0], weights[0],
                             y_stats, params, hist_impl)
        held = graphs.lock
    else:
        graphs, held = None, contextlib.nullcontext()
    forest = None
    with held:
        if graphs is None:
            xb_f = fold_parties(xb)
        else:
            st = graphs.state
            xb_f = fold_parties(xb, out=st.xb)
            st.feat_gid.copy_(feat_gid)
            st.y_stats.copy_(y_stats)
            feat_gid, y_stats = st.feat_gid, st.y_stats
        for t in range(n_trees):
            tr = build_tree(xb_f, feat_gid, feat_sels[t], weights[t],
                            y_stats, params, hist_impl=hist_impl, tree=t)
            if forest is None:
                forest = PartyTree(*(f.new_empty((m, n_trees, *f.shape[1:]))
                                     for f in tr))
            for dst, src in zip(forest, tr):
                dst[:, t] = src
    return forest

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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import impurity
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


def fold_parties(xb: torch.Tensor) -> torch.Tensor:
    """(M, N, Fp) party bins -> (N, M*Fp) uint8 feature-major: party i's
    local feature j is column i*Fp + j, stored as a contiguous (M*Fp, N)
    tensor so the histogram kernel reads each column contiguously."""
    m, n, fp = xb.shape
    return xb.to(torch.uint8).permute(0, 2, 1).contiguous().view(m * fp, n).t()


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


def _split_search_dense(xb, seg, wstats, fmask, feat_gid, width, params,
                        hist_impl, prev_hist):
    """Histogram every heap slot of the level at once."""
    mf, c = xb.shape[1], wstats.shape[-1]
    if params.hist_subtraction and prev_hist is not None:
        # histogram only the LEFT children (half the node width), derive
        # the right siblings from the retained parent histograms.  Children
        # of leaf parents get garbage rows, but do_split is gated on the
        # true sample counts, so they can never be selected.
        left_seg = torch.where((seg >= 0) & (seg % 2 == 0), seg // 2, -1)
        hist_left = ops.histogram(xb, left_seg, wstats, width // 2,
                                  params.n_bins, impl=hist_impl)
        hist = torch.stack([hist_left, prev_hist - hist_left], dim=1
                           ).reshape(width, mf, params.n_bins, c)
    else:
        hist = ops.histogram(xb, seg, wstats, width, params.n_bins,
                             impl=hist_impl)
    gains = impurity.split_gains(hist, params.task, params.min_samples_leaf)
    return _party_argbest(gains, fmask, feat_gid), hist


def _split_search_frontier(xb, seg, wstats, fmask, feat_gid, width, cap,
                           params, hist_impl, level):
    """Compacted path: histogram ``cap`` live slots per pass, scatter back.

    Live node j (heap-level index, any routed sample) gets compact slot
    ``rank(j among live)``; pass k handles slots [k*cap, (k+1)*cap).  Each
    live node's histogram row accumulates exactly the samples the dense row
    would, so the per-node results written back to heap order equal the
    dense search's.  Dead nodes keep the -inf/_BIG defaults, which
    ``do_split`` can never select.

    The JAX package runs the passes in a ``while_loop`` on the device; here
    the live count is read to the host once per level (one sync, counted on
    ``forest.host_syncs``) and the passes are a Python loop.  Returns the
    per-node bests and the number of passes."""
    m = feat_gid.shape[0]
    dev = xb.device
    dump = torch.where(seg >= 0, seg, width).long()
    occ = torch.zeros(width + 1, dtype=torch.bool, device=dev)
    occ[dump] = True
    occ = occ[:width]
    slot_of_node = torch.cumsum(occ.to(torch.int32), 0, dtype=torch.int32) - 1
    with tracing.TRACER.span("tree.live_count", level=level):
        n_live = int(occ.sum())
    _M_HOST_SYNCS.inc()
    sslot = torch.where(seg >= 0, slot_of_node[seg.clamp(min=0).long()], -1)
    nil_idx = torch.arange(width, device=dev)

    g_lv = torch.full((m, width + 1), _NEG_INF, device=dev)
    gid_lv = torch.full((m, width + 1), _BIG, dtype=torch.int32, device=dev)
    bin_lv = gid_lv.clone()
    floc_lv = gid_lv.clone()
    for lo in range(0, n_live, cap):
        in_pass = (sslot >= lo) & (sslot < lo + cap)
        seg_k = torch.where(in_pass, sslot - lo, -1)
        hist = ops.histogram(xb, seg_k, wstats, cap, params.n_bins,
                             impl=hist_impl)
        gains = impurity.split_gains(hist, params.task,
                                     params.min_samples_leaf)
        g_c, gid_c, bin_c, floc_c = _party_argbest(gains, fmask, feat_gid)
        # slot -> heap-level node of THIS pass (slot cap / column width are
        # the dump targets of the unused entries, sliced off below)
        node_in_pass = occ & (slot_of_node >= lo) & (slot_of_node < lo + cap)
        tgt = torch.where(node_in_pass, slot_of_node - lo, cap).long()
        inv = torch.full((cap + 1,), width, dtype=torch.long, device=dev)
        inv[tgt] = torch.where(node_in_pass, nil_idx, width)
        inv = inv[:cap]
        g_lv[:, inv] = g_c
        gid_lv[:, inv] = gid_c
        bin_lv[:, inv] = bin_c
        floc_lv[:, inv] = floc_c
    return (g_lv[:, :width], gid_lv[:, :width], bin_lv[:, :width],
            floc_lv[:, :width]), -(-n_live // cap)


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
                frontier or leaf — and histogram ``passes``).
    Returns:
      the tree's PartyTree, fields with leading (M,).
    """
    n = xb.shape[0]
    m, fp = feat_gid.shape
    c = y_stats.shape[-1]
    nn = params.n_nodes
    dev = xb.device
    task = params.task
    hist_impl = params.hist_impl if hist_impl is None else hist_impl
    i32 = torch.int32

    feat_gid = feat_gid.to(i32)
    fmask = (feat_gid >= 0) & feat_sel[feat_gid.clamp(min=0).long()]
    wstats = (y_stats.to(torch.float32) * weight[:, None]).contiguous()
    # node stats come from the same histogram over a single all-zero
    # column: a plain index_add_ would add with float atomics on the card
    zero_col = torch.zeros((1, n), dtype=torch.uint8, device=dev).t()
    # global party indices of the local rows; their columns in the fold
    parties = (torch.arange(m, dtype=i32, device=dev) if comm is None
               else torch.tensor([comm.party_index], dtype=i32, device=dev))
    col_base = (torch.arange(m, dtype=i32, device=dev) * fp)[:, None]

    node = torch.zeros(n, dtype=i32, device=dev)
    is_leaf = torch.zeros(nn, dtype=torch.bool, device=dev)
    leaf_stats = torch.zeros((nn, c), dtype=torch.float32, device=dev)
    has_split = torch.zeros((m, nn), dtype=torch.bool, device=dev)
    split_floc = torch.full((m, nn), -1, dtype=i32, device=dev)
    split_bin = torch.full((m, nn), -1, dtype=i32, device=dev)
    owner = torch.full((nn,), -1, dtype=i32, device=dev)
    split_gid = torch.full((nn,), -1, dtype=i32, device=dev)
    prev_hist = None  # parent-level histograms (hist_subtraction)

    for d in range(params.max_depth + 1):
        off, width = params.level_slice(d)
        with tracing.TRACER.span("tree.level", tree=tree, level=d,
                                 width=width) as level_span:
            lvl = slice(off, off + width)
            nil = node - off
            in_lvl = (nil >= 0) & (nil < width)
            seg = torch.where(in_lvl, nil, -1)

            # node label stats — computed identically by every party
            # (shared y)
            nstats = ops.histogram(zero_col, seg, wstats, width, 1,
                                   impl=hist_impl)[:, 0, 0, :]
            cnt = impurity.count_of(nstats, task)
            leaf_stats[lvl] = nstats

            if d == params.max_depth:  # bottom level: all alive are leaves
                is_leaf[lvl] = cnt > 0
                level_span.set(path="leaf", passes=0)
                break

            # ---- local split search (the histogram hot spot) ---------------
            cap = min(width, n, params.frontier_cap or width)
            if params.frontier_cap and cap < width:
                (g_loc, gid_loc, bin_loc, floc_loc), passes = \
                    _split_search_frontier(xb, seg, wstats, fmask, feat_gid,
                                           width, cap, params, hist_impl, d)
                level_span.set(path="frontier", passes=passes)
                prev_hist = None  # compacted levels keep no dense parent hist
            else:
                (g_loc, gid_loc, bin_loc, floc_loc), prev_hist = \
                    _split_search_dense(xb, seg, wstats, fmask, feat_gid,
                                        width, params, hist_impl, prev_hist)
                level_span.set(path="dense", passes=1)

            # ---- the paper's master: the (M, width) stack is the all_gather
            if comm is not None:
                g_all, gid_all, bin_all = comm.all_gather(
                    g_loc[0], gid_loc[0], bin_loc[0])
            else:
                g_all, gid_all, bin_all = g_loc, gid_loc, bin_loc
            do_split, owner_lv, gid_best, bin_best = reduce_level(
                g_all, gid_all, bin_all, cnt, params)
            is_leaf[lvl] = (cnt > 0) & ~do_split

            mine = do_split[None] & (owner_lv[None]
                                     == parties[:, None])            # (M, W)
            has_split[:, lvl] = mine
            split_floc[:, lvl] = torch.where(mine, floc_loc, -1)
            split_bin[:, lvl] = torch.where(mine, bin_loc, -1)
            owner[lvl] = torch.where(do_split, owner_lv, -1)
            split_gid[lvl] = torch.where(do_split, gid_best, -1)

            # ---- owner computes the partition; a sum over parties
            # broadcasts it (paper Alg.2: "Receive split indices from client
            # j and broadcast")
            nil_c = nil.clamp(0, width - 1).long()
            floc_lv = torch.where(mine, floc_loc, 0)
            bin_lv = torch.where(mine, bin_loc, 0)
            mine_s = in_lvl[None] & mine[:, nil_c]                    # (M, N)
            cols = (col_base + floc_lv[:, nil_c]).long()              # (M, N)
            vals = torch.gather(xb, 1, cols.t()).t().to(i32)          # (M, N)
            go_r_loc = torch.where(mine_s, (vals > bin_lv[:, nil_c]).to(i32),
                                   0)
            go_r = go_r_loc.sum(0, dtype=i32)  # exactly one party contributes
            if comm is not None:
                go_r = comm.psum(go_r)
            advance = in_lvl & do_split[nil_c]
            node = torch.where(advance, 2 * node + 1 + go_r, node)

    def shared(a):      # every party holds the same row
        return a.expand(m, *a.shape)
    return PartyTree(shared(is_leaf), shared(leaf_stats), has_split,
                     split_floc, split_bin, shared(owner), shared(split_gid))


def build_forest(xb, feat_gid, feat_sels, weights, y_stats,
                 params: ForestParams, *,
                 hist_impl: str | None = None) -> PartyTree:
    """Bagging loop: build T trees, stacked as (M, T, ...) on every field.

    ``xb`` is the (M, N, Fp) party stack; it is folded once for the whole
    fit.  Trees build one after another — ``params.trees_per_batch`` only
    regroups the JAX package's bagging map and never changes a tree, so it
    has nothing to select here."""
    xb_f = fold_parties(xb)
    trees = [build_tree(xb_f, feat_gid, feat_sels[t], weights[t], y_stats,
                        params, hist_impl=hist_impl, tree=t)
             for t in range(feat_sels.shape[0])]
    return PartyTree(*(torch.stack(field, dim=1) for field in zip(*trees)))

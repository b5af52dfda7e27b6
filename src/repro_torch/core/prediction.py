"""Federated Forest one-round prediction (paper §4.2, Alg. 3/4/7/8).

Each party routes every test sample through its PARTIAL tree; at foreign
nodes the sample descends into BOTH subtrees.  The per-party result is a
boolean leaf-membership mask (trees, samples, nodes).  Proposition 1 says the
true leaf assignment is the per-leaf intersection across parties — one sum
over the party dimension FOR THE ENTIRE FOREST (the paper's "only one round
of communication ... even for the overall forest"; the JAX package's
``lax.psum``).

The party axis is an explicit leading dimension: trees carry (M, T, ...)
fields and the binned test rows are (M, N_t, Fp).

Prediction-side sparsity: with a per-tree ``LeafTable`` (serving/plan.py)
the membership mask is gathered over live leaves — the party sum and the
vote contraction shrink from ``n_nodes`` columns to the live-leaf capacity,
while the Prop. 1 intersection (and the bits of every output) is unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.core import impurity
from repro_torch.core.tree import PartyTree
from repro_torch.core.types import ForestParams


def tree_leaf_membership(tree: PartyTree, xb_test: torch.Tensor,
                         params: ForestParams) -> torch.Tensor:
    """Paper Alg. 3 for every party: (M, N_t, n_nodes) bool leaf-candidate
    masks of one tree (fields (M, nn)), built level by level and
    concatenated once (heap order IS level order)."""
    m, n, _ = xb_test.shape
    xb = xb_test.long()
    cur = torch.ones((m, n, 1), dtype=torch.bool, device=xb.device)
    parts = []
    for d in range(params.max_depth):
        off, width = params.level_slice(d)
        lvl = slice(off, off + width)
        leaf_lv = tree.is_leaf[:, lvl][:, None]                 # (M, 1, W)
        has = tree.has_split[:, lvl][:, None]
        floc = tree.split_floc[:, lvl].clamp(min=0).long()
        bins = tree.split_bin[:, lvl][:, None]
        vals = torch.gather(xb, 2, floc[:, None, :].expand(m, n, width))
        left_ok = ~has | (vals <= bins)                         # foreign => both
        right_ok = ~has | (vals > bins)
        parts.append(cur & leaf_lv)                             # leaves stop here
        alive = cur & ~leaf_lv
        cur = torch.stack([alive & left_ok, alive & right_ok],
                          -1).reshape(m, n, 2 * width)
    off, width = params.level_slice(params.max_depth)
    parts.append(cur & tree.is_leaf[:, off:off + width][:, None])
    return torch.cat(parts, dim=2)                              # (M, N, nn)


def masked_leaf_stats(trees: PartyTree) -> torch.Tensor:
    """(..., nn, C) leaf stats with non-leaf rows zeroed (the vote operand)."""
    return torch.where(trees.is_leaf[..., None], trees.leaf_stats, 0.0)


def _check_full_f32(device: torch.device, what: str = "forest vote") -> None:
    """The vote contraction sums leaf counts: TF32 would round those above
    2^11, so the contraction must run in full float32 (as must F-LR's
    products, whose reference is float32)."""
    if device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{what} needs full-float32 matrix products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def _combine_votes(inter: torch.Tensor, leaf: torch.Tensor,
                   params: ForestParams, aggregate: bool = True,
                   vote_impl: str = "einsum") -> torch.Tensor:
    """Forest vote from the (T, N, L) exact leaf-assignment mask.

    ``leaf`` is the matching (T, L, C) zero-masked leaf-stats tensor — the
    full heap or the leaf-compacted gather.  Either way each sample
    intersects exactly one true leaf column (Prop. 1) and every other column
    contributes an exact 0.0, so the vote is bit-identical across
    compactions.  ``aggregate=False`` returns per-tree results (T, N).

    ``vote_impl='argmax'`` (classification only): each sample hits exactly
    one leaf, so the per-tree label is a masked max over int8 leaf labels —
    no float32 copy of the (T, N, L) mask."""
    if params.task == "classification":
        if vote_impl == "argmax":
            label1 = (leaf.argmax(-1) + 1).to(torch.int8)           # (T, L)
            per_tree = (torch.where(inter, label1[:, None, :], 0).amax(-1)
                        .to(torch.int32) - 1)                       # (T, N)
        else:
            # per-tree label by leaf majority, then forest majority (Alg. 4)
            _check_full_f32(inter.device)
            stats = torch.einsum("tnl,tlc->tnc", inter.to(torch.float32), leaf)
            per_tree = stats.argmax(-1)                             # (T, N)
    else:
        _check_full_f32(inter.device)
        vals = impurity.leaf_value(leaf, params.task)               # (T, L)
        per_tree = torch.einsum("tnl,tl->tn", inter.to(torch.float32), vals)
    return forest_vote(per_tree, params) if aggregate else per_tree


def forest_vote(per_tree: torch.Tensor, params: ForestParams) -> torch.Tensor:
    """The forest's answer from its (T, N) per-tree results: the majority
    class (Alg. 4; ties to the lowest class) or the mean value (Alg. 8).
    The sharded substrate votes over its tree shards' outputs with this
    same function."""
    if params.task == "classification":
        classes = torch.arange(params.n_classes, device=per_tree.device)
        votes = (per_tree[..., None] == classes[None, None, :]).sum(0)
        return votes.argmax(-1)
    return per_tree.mean(0)


def tree_leaf_membership_compact(tree: PartyTree, xb_test: torch.Tensor,
                                 params: ForestParams,
                                 leaf_idx: torch.Tensor) -> torch.Tensor:
    """Leaf-candidate masks gathered over live leaves: (M, N_t, L) bool.

    ``leaf_idx`` is one tree's row of a ``LeafTable`` — the heap ids of its
    live leaves in ascending order, -1 padded to the capacity L.  Column j
    equals the dense mask's column ``leaf_idx[j]``; padded columns are
    identically False, so they never survive the intersection."""
    mem = tree_leaf_membership(tree, xb_test, params)           # (M, N, nn)
    valid = leaf_idx >= 0
    return mem[:, :, leaf_idx.clamp(min=0).long()] & valid[None, None]


def gather_leaf_stats(trees: PartyTree, leaf_idx: torch.Tensor) -> torch.Tensor:
    """(T, L, C) leaf stats gathered over a LeafTable; padded rows zeroed.
    ``trees`` is one party's (T, ...) view."""
    t, cap = leaf_idx.shape
    c = trees.leaf_stats.shape[-1]
    idx = leaf_idx.clamp(min=0).long()[..., None].expand(t, cap, c)
    stats = torch.gather(trees.leaf_stats, 1, idx)
    return torch.where((leaf_idx >= 0)[..., None], stats, 0.0)


def forest_predict_oneround(trees: PartyTree, xb_test: torch.Tensor,
                            params: ForestParams, aggregate: bool = True,
                            mask_dtype: torch.dtype = torch.int32,
                            vote_impl: str = "einsum",
                            leaf_idx: torch.Tensor | None = None,
                            comm=None) -> torch.Tensor:
    """The paper's one-round prediction over all M parties.

    ``trees`` has (M, T, ...) fields, ``xb_test`` is (M, N_t, Fp).  With
    ``comm`` (a rank of the sharded substrate) M is this rank's party
    alone and the party sum goes through ``comm.psum``.

    ``mask_dtype``: the membership masks are 0/1 and M <= 255 parties, so a
    uint8 party sum is exact and moves 4x fewer bytes than int32.

    ``leaf_idx``: a ``LeafTable.leaf_idx`` ((T, L) live-leaf heap ids, -1
    padded) switches every tree to the leaf-compacted mask — bit-identical
    outputs, with the party sum and the vote over live-leaf columns only."""
    mem, leaf = party_masks(trees, xb_test, params, mask_dtype, leaf_idx)
    # === Proposition 1: ONE party sum for the whole forest ===
    msum = mem.sum(0, dtype=mask_dtype)                        # (T, N, L)
    n_parties = trees.is_leaf.shape[0]
    if comm is not None:
        msum, n_parties = comm.psum(msum), comm.n_parties
    inter = msum == n_parties                                  # S^l = ∩ S_i^l
    return _combine_votes(inter, leaf, params, aggregate, vote_impl)


def party_masks(trees: PartyTree, xb_test: torch.Tensor, params: ForestParams,
                mask_dtype: torch.dtype = torch.int32,
                leaf_idx: torch.Tensor | None = None):
    """The local half of the one-round protocol: every party's leaf-membership
    masks, (M, T, N, L) in ``mask_dtype``, and the (T, L, C) vote operand
    (dense heap, or gathered over ``leaf_idx``).  A party process of the
    distributed substrate calls it with its own M = 1 row and sums the
    masks over the wire."""
    t = trees.is_leaf.shape[1]
    per_tree = [PartyTree(*(f[:, i] for f in trees)) for i in range(t)]
    shared = PartyTree(*(f[0] for f in trees))     # shared fields: any party
    if leaf_idx is None:
        mem = [tree_leaf_membership(tr, xb_test, params).to(mask_dtype)
               for tr in per_tree]
        leaf = masked_leaf_stats(shared)
    else:
        mem = [tree_leaf_membership_compact(tr, xb_test, params,
                                            leaf_idx[i]).to(mask_dtype)
               for i, tr in enumerate(per_tree)]
        leaf = gather_leaf_stats(shared, leaf_idx)
    return torch.stack(mem, dim=1), leaf


def forest_predict_classical(trees: PartyTree, xb_test: torch.Tensor,
                             params: ForestParams, aggregate: bool = True,
                             comm=None) -> torch.Tensor:
    """Multi-round baseline (the paper's Figs. 4-6 comparison): the owner
    broadcasts the branch at every level — one sum over the party dimension
    per level, where the one-round predictor needs one for the forest.

    ``trees`` has (M, T, ...) fields, ``xb_test`` is (M, N_t, Fp); all T
    trees are routed together, a level at a time.  With ``comm`` (a rank of
    the sharded substrate) M is this rank's party alone and each level's
    party sum goes through ``comm.psum``.  ``aggregate=False`` returns the
    per-tree results (T, N), as :func:`forest_predict_oneround` does."""
    m, t, nn = trees.is_leaf.shape
    n = xb_test.shape[1]
    xb = xb_test.long()[:, None].expand(m, t, n, xb_test.shape[2])
    has_split, floc = trees.has_split, trees.split_floc.clamp(min=0).long()
    split_bin, owner = trees.split_bin, trees.owner[0]
    node = torch.zeros((t, n), dtype=torch.long, device=xb_test.device)
    for _ in range(params.max_depth):
        at = node[None].expand(m, t, n)
        has = torch.gather(has_split, 2, at)                       # (M, T, N)
        vals = torch.gather(xb, 3, torch.gather(floc, 2, at)[..., None])[..., 0]
        go_r_loc = torch.where(
            has, (vals > torch.gather(split_bin, 2, at)).to(torch.int32), 0)
        go_r = go_r_loc.sum(0)                # one round per level (!)
        if comm is not None:
            go_r = comm.psum(go_r)
        split_here = torch.gather(owner, 1, node) >= 0  # structure is shared
        node = torch.where(split_here, 2 * node + 1 + go_r, node)
    cols = torch.arange(nn, device=node.device)
    inter = (cols[None, None, :] == node[..., None]) \
        & trees.is_leaf[0][:, None, :]                             # (T, N, nn)
    shared = PartyTree(*(f[0] for f in trees))
    return _combine_votes(inter, masked_leaf_stats(shared), params, aggregate)


def mask_comm_bytes(n_trees: int, n_rows: int, n_cols: int,
                    mask_dtype: torch.dtype = torch.int32) -> int:
    """Per-party payload of the one-round membership sum, in bytes.

    ``n_cols`` is ``params.n_nodes`` for the dense mask or the LeafTable
    capacity for the compacted one."""
    return n_trees * n_rows * n_cols * mask_dtype.itemsize


def comm_rounds(params: ForestParams, method: str) -> int:
    """Analytic collective-round count per forest prediction (paper §Appendix)."""
    if method == "oneround":
        return 1
    if method == "classical":
        return params.n_estimators * params.max_depth
    raise ValueError(method)

"""The port's CUDA kernels on the card.  The histogram: held against its
plain version on the sweep of tests/test_kernels.py and at a fit's shapes,
deterministic launch to launch, and a fit on the card equal to the CPU fit.
The level builder's CUDA graphs: every fit path (dense, one and several
frontier passes, ``hist_subtraction``, both tasks) equal to the eager
level loop on the card and to the CPU, with as many launches and host
syncs, no capture on a second fit, fresh inputs each fit, a new shape
captured anew, and one ``tree.level`` span a level a tree (``graph=1``
where replayed).
The flash attention: held against its plain version on the same file's
sweep in both types (float32 2e-3 through the CUDA-core route, bfloat16
3e-2 and the tensor-core route's per-element error model), deterministic,
refusing what it does not take (bfloat16 not 16-byte aligned among it),
and a dense LM's prefill consistent with its decode.  Streamed ingest and
a resumable fit on the card equal the same on the CPU.  Boosting: each
round on the card equal to the CPU's from the same margin, FB(2) == FB(1),
and the histogram on its signed C = 3 stats within the error model; F-LR
on the card allclose to the CPU; classical prediction equal to one-round.
Serving: one CUDA graph captured per bucket and none under traffic or for
a surviving bucket after a retune, sync == async with several waves of one
bucket in flight, a fleet drained on threads with lazy captures equal to
the single server, a refresh after ``fit_resumable`` recapturing, boosting
and F-LR labels equal to ``predict``, and a capture that syncs with the
host raising.  The party-per-process substrate: two workers on the card
fit the simulated forest bit for bit, each launching the kernel as often.
The egress guard: a CUDA copy of a raw block is clean.  The sharded
substrate: ``hist_subtraction`` fits and the classical predict on two gloo
ranks on the card equal the simulated substrate's.  LM training: a step on
the card equal to the CPU's (loss, every gradient leaf, the parameters
after AdamW), no flash launch in a training step and the kernel's wrapper
refusing a grad-requiring input; the MoE layer on the card equal to the
CPU's (kept slots, y, aux).  The recurrent blocks (Mamba2, mLSTM, sLSTM)
on the card equal to the CPU's, with and without caches, and the flash
kernel at head dim 112 (zamba2-7b's shared attention) on both routes.
Needs an NVIDIA GPU and nvcc; each test skips elsewhere.  Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import impurity
from repro_torch.core.forest import FederatedForest
from repro_torch.core.party import make_vertical_partition
from repro_torch.core.partyblock import PartyBlock
from repro_torch.core.types import ForestParams
from repro_torch.data import (make_classification, make_party_views,
                              make_regression)
from repro_torch.federation import Federation
from repro_torch.configs import registry
from repro_torch.data import lm
from repro_torch.kernels import histogram as hist
from repro_torch.kernels import ops, ref
from repro_torch.kernels.attention import flash_attention
from repro_torch.models import transformer
from repro_torch.streaming import ArraySource

pytestmark = pytest.mark.cuda
SPLIT_FIELDS = ("is_leaf", "has_split", "split_floc", "split_bin", "owner",
                "split_gid")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, n, f, b, lv, c, integer):
    g = torch.Generator(device="cpu").manual_seed(n + f + lv)
    xb = torch.randint(0, b, (n, f), generator=g).to(torch.uint8)
    seg = torch.randint(-1, lv, (n,), generator=g, dtype=torch.int32)
    stats = (torch.randint(0, 4, (n, c), generator=g).float() if integer
             else torch.rand((n, c), generator=g))
    return xb.to(dev), seg.to(dev), stats.to(dev)


@pytest.mark.parametrize("n,f,b,lv,c", [
    (64, 3, 8, 1, 2), (300, 11, 16, 6, 3), (512, 8, 32, 12, 2),
    (1030, 17, 64, 32, 5), (20000, 96, 32, 128, 2), (5000, 9, 64, 256, 3),
    (3000, 4, 256, 5, 60),
    # the node stats of a fit: one all-zero column, one bin
    (20000, 1, 1, 128, 2), (5000, 1, 1, 512, 3),
    # N not a multiple of the chunk; N over many chunks (the main table x 8)
    (20001, 5, 32, 7, 2), (117148 * 8, 3, 32, 16, 2),
    (117148 * 8, 1, 1, 64, 2)])
def test_kernel_matches_plain(cuda, n, f, b, lv, c):
    for integer in (True, False):
        xb, seg, stats = _inputs(cuda, n, f, b, lv, c, integer)
        xc = hist.column_major(xb)
        got = hist.histogram_cuda(xc, seg, stats, lv, b)
        again = hist.histogram_cuda(xc, seg, stats, lv, b)
        want = ref.histogram_ref(xb, seg, stats, lv, b)
        torch.cuda.synchronize()
        assert torch.equal(got, again)                 # deterministic
        if integer:
            assert torch.equal(got, want)              # exact sums
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,f,lo,hi", [
    (4000, 12, 5, 9),
    # over several chunks, the slice straddling a feature-group boundary
    (50000, 24, 5, 13), (50000, 24, 8, 16), (117148, 96, 47, 95)])
def test_feature_order_independent(cuda, n, f, lo, hi):
    """A feature's cells get the same bits whatever other features share
    the launch — what makes folding the parties into one launch exact."""
    xb, seg, stats = _inputs(cuda, n, f, 32, 16, 3, integer=False)
    whole = hist.histogram_cuda(hist.column_major(xb), seg, stats, 16, 32)
    part = hist.histogram_cuda(hist.column_major(xb[:, lo:hi]), seg, stats,
                               16, 32)
    assert torch.equal(whole[:, lo:hi], part)


@pytest.mark.parametrize("n", [4000, 50000])
def test_slot_count_independent(cuda, n):
    """The same samples histogrammed with L = 16 and with L = 64 slots, the
    slots renumbered, give the same bits in every shared slot — what makes
    the frontier passes equal the dense level."""
    xb, seg, stats = _inputs(cuda, n, 10, 64, 16, 3, integer=False)
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(n))
    perm = perm.to(torch.int32).to(cuda)
    seg64 = torch.where(seg >= 0, perm[seg.clamp(min=0).long()], -1)
    xc = hist.column_major(xb)
    small = hist.histogram_cuda(xc, seg, stats, 16, 64)
    big = hist.histogram_cuda(xc, seg64, stats, 64, 64)
    assert hist.launch_plan(n, 10, 16, 64, 3, 232448).n_tiles != \
        hist.launch_plan(n, 10, 64, 64, 3, 232448).n_tiles
    assert torch.equal(big[perm[:16].long()], small)


@pytest.mark.parametrize("n", [20000, 117148])
def test_integer_stats_beyond_the_guard(cuda, n):
    """Integer stats too large for the integer route (|stat| * chunk above
    2^24), and integer stats with one fraction at the very end (the route
    turns to float mid-chunk): deterministic, and equal to the plain
    version, because every cell's total stays an exact float32 integer."""
    xb, seg, stats = _inputs(cuda, n, 6, 32, 8, 2, integer=True)
    chunk = hist.chunk_len(n, 32, 2)
    big = stats * (2**24 // chunk + 1)
    late = stats.clone()
    late[-1, 0] += 0.5
    xc = hist.column_major(xb)
    for st in (big, late):
        got = hist.histogram_cuda(xc, seg, st, 8, 32)
        again = hist.histogram_cuda(xc, seg, st, 8, 32)
        want = ref.histogram_ref(xb, seg, st, 8, 32)
        torch.cuda.synchronize()
        assert float(want.abs().max()) < 2**24
        assert torch.equal(got, again) and torch.equal(got, want)


def test_split_gains_on_card_equal_cpu(cuda):
    """The gains of one float histogram are the same bits on the card and
    on the CPU, whatever PyTorch's scan accumulates in on each device."""
    g = torch.Generator().manual_seed(0)
    h = (torch.randn((64, 26, 64, 3), generator=g) * 1000).float()
    cases = [("regression", h)] + [
        ("classification", (torch.rand((64, 26, 64, c), generator=g)
                            * 6e4).round()) for c in (2, 3, 5, 9)]
    for task, hh in cases:
        got = impurity.split_gains(hh.to(cuda), task, 1).cpu()
        assert torch.equal(got, impurity.split_gains(hh, task, 1)), \
            (task, hh.shape[-1])


def test_launch_count_and_checks(cuda):
    xb, seg, stats = _inputs(cuda, 500, 4, 8, 3, 2, integer=True)
    before = hist.histogram_cuda.launches
    ops.histogram(xb, seg, stats, 3, 8)                # auto -> the kernel
    assert hist.histogram_cuda.launches == before + 1
    with pytest.raises(ValueError, match="plain CPU version"):
        ops.histogram(xb, seg, stats, 3, 8, impl="scatter")
    with pytest.raises(ValueError, match="column_major"):
        hist.histogram_cuda(xb.contiguous(), seg, stats, 3, 8)
    with pytest.raises(ValueError, match="int32"):
        hist.histogram_cuda(hist.column_major(xb), seg.long(), stats, 3, 8)
    with pytest.raises(ValueError, match="exceeds"):
        hist.histogram_cuda(hist.column_major(xb), seg,
                            torch.ones((500, 300), device=cuda), 3, 256)


def _fixture(task, rows=None, seed=None):
    """The card fits' data: classification 1500 x 20 at 32 bins, or
    regression 1200 x 13 at 16 bins (a seed whose trees meet no near-tie),
    as a 2-party partition with its labels and base parameters."""
    if task == "classification":
        x, y = make_classification(rows or 1500, 20, 2, n_informative=6,
                                   seed=3 if seed is None else seed)
        return (make_vertical_partition(x, 2, 32), y,
                dict(n_estimators=3, max_depth=6, n_bins=32, seed=5))
    x, y = make_regression(rows or 1200, 13, seed=2 if seed is None else seed)
    return (make_vertical_partition(x, 2, 16), y,
            dict(task="regression", n_estimators=3, max_depth=5, n_bins=16,
                 seed=7))


def _eager_fit_on_card(part, y, p):
    """The fit's trees grown on the card by the eager level loop (no
    graphs: ``core/tree.py::_grow`` over a fresh state a tree), with the
    histogram launches and host syncs it made."""
    from repro_torch.core import tree
    ff = FederatedForest(p, device="cuda")
    _, xb, gid, weights, sels, stats = ff._prepare(part, y)
    xb_f, gid = tree.fold_parties(xb), gid.to(torch.int32)
    parties = torch.arange(gid.shape[0], dtype=torch.int32, device="cuda")
    l0, s0 = hist.histogram_cuda.launches, _counter("forest.host_syncs")
    trees = []
    for t in range(sels.shape[0]):
        st = tree.TreeState(xb_f, gid, sels[t], weights[t], stats, ff.params,
                            "auto", parties)
        tree._grow(st, t)
        trees.append(st.tree())
    forest = type(trees[0])(*(torch.stack(fs, 1) for fs in zip(*trees)))
    return (convert.party_trees_to_numpy(forest),
            hist.histogram_cuda.launches - l0,
            _counter("forest.host_syncs") - s0)


def _counter(name):
    from repro_torch.observability.registry import REGISTRY
    return REGISTRY.counter(name).value


def _traced_fit(p, part, y, device):
    """A fit with the process tracer on: (trees as NumPy, spans)."""
    from repro_torch.observability.trace import TRACER
    TRACER.enable()
    try:
        TRACER.reset()
        model = FederatedForest(p, device=device).fit(part, y)
        spans = TRACER.spans()
    finally:
        TRACER.disable()
        TRACER.reset()
    return convert.party_trees_to_numpy(model.trees_), spans


def _assert_same_forest(got, want, task, what):
    """Bit for bit, or (regression against the CPU) the same splits and
    leaf stats within rtol 1e-5: float sums associate differently on the
    card."""
    for f in SPLIT_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what} {f}")
    if task == "classification" or "cpu" not in what:
        np.testing.assert_array_equal(got["leaf_stats"], want["leaf_stats"],
                                      err_msg=f"{what} leaf_stats")
    else:
        np.testing.assert_allclose(got["leaf_stats"], want["leaf_stats"],
                                   rtol=1e-5, atol=0, err_msg=what)


@pytest.mark.parametrize("task,case,kw,passes", [
    ("classification", "dense", {"frontier_cap": 0}, 0),
    ("classification", "frontier_one_pass", {"frontier_cap": 8}, 1),
    ("classification", "hist_subtraction",
     {"hist_subtraction": True, "frontier_cap": 0}, 0),
    ("regression", "dense", {"frontier_cap": 0}, 0),
    ("regression", "frontier_passes", {"frontier_cap": 4}, 4),
])
def test_fit_on_card_equals_cpu(cuda, task, case, kw, passes):
    """The level graphs (``core/tree_graphs.py``) build the forest the
    eager level loop builds on the card, bit for bit, with as many
    histogram launches and host syncs, and the CPU's forest (regression:
    the same splits, leaf stats within rtol 1e-5).  A second fit of the
    same shapes replays without capturing.  ``passes``: the most a
    compacted level of the fit runs."""
    part, y, base = _fixture(task)
    p = ForestParams(**base, **kw)
    want, _ = _traced_fit(p, part, y, "cpu")
    eager, launches, syncs = _eager_fit_on_card(part, y, p)
    _assert_same_forest(eager, want, task, f"{case} eager vs cpu")
    got, spans = _traced_fit(p, part, y, "cuda")      # warms up, captures
    _assert_same_forest(got, eager, task, f"{case} graphs vs eager")
    most = max([s["attrs"]["passes"] for s in spans
                if s["name"] == "tree.level"
                and s["attrs"]["path"] == "frontier"], default=0)
    assert most == passes, case
    counts = (hist.histogram_cuda.launches, _counter("forest.host_syncs"),
              _counter("forest.graph_captures"),
              _counter("forest.graph_replays"))
    again = convert.party_trees_to_numpy(
        FederatedForest(p, device="cuda").fit(part, y).trees_)
    _assert_same_forest(again, eager, task, f"{case} replayed vs eager")
    l1, s1, c1, r1 = (hist.histogram_cuda.launches,
                      _counter("forest.host_syncs"),
                      _counter("forest.graph_captures"),
                      _counter("forest.graph_replays"))
    assert (l1 - counts[0], s1 - counts[1]) == (launches, syncs), case
    assert c1 == counts[2] and r1 > counts[3], case


def test_level_graphs_take_new_inputs_and_new_shapes(cuda):
    """Two fits of the same shapes on other data and draws each get their
    own trees (no static input left stale, the first fit's trees not
    overwritten), and a change of shape captures anew."""
    from repro_torch.core import tree_graphs
    kw = dict(frontier_cap=8)
    fits = {}
    for seed in (3, 4):
        part, y, base = _fixture("classification", seed=seed)
        p = ForestParams(**dict(base, seed=seed + 2), **kw)
        fits[seed] = (FederatedForest(p, device="cuda").fit(part, y),
                      convert.party_trees_to_numpy(
                          FederatedForest(p, device="cpu").fit(part, y)
                          .trees_))
    for seed, (model, want) in fits.items():
        _assert_same_forest(convert.party_trees_to_numpy(model.trees_), want,
                            "classification", f"seed {seed} vs cpu")
    c0 = _counter("forest.graph_captures")
    part, y, base = _fixture("classification", rows=1400)
    p = ForestParams(**base, **kw)
    got = FederatedForest(p, device="cuda").fit(part, y)
    assert _counter("forest.graph_captures") > c0
    assert 1 <= len(tree_graphs._CACHE) <= tree_graphs.MAX_ENTRIES
    _assert_same_forest(
        convert.party_trees_to_numpy(got.trees_),
        convert.party_trees_to_numpy(
            FederatedForest(p, device="cpu").fit(part, y).trees_),
        "classification", "1400 rows vs cpu")


def test_traced_fit_on_card_replays_levels(cuda):
    """The card's variant of tests/test_torch_observability.py's traced
    fit: one ``tree.level`` a level a tree with the same attributes, one
    host sync a compacted level a tree, ``graph=1`` on every level the
    graphs replayed — all but the first tree's of the first fit of a
    shape, which warms up — and the trees of an untraced fit."""
    x, y = make_regression(239, 7, seed=5)
    p = ForestParams(task="regression", n_estimators=2, max_depth=5,
                     n_bins=8, seed=3, frontier_cap=3)
    part = make_vertical_partition(x, 2, p.n_bins, seed=p.seed)
    s0 = _counter("forest.host_syncs")
    runs = [_traced_fit(p, part, y, "cuda") for _ in range(2)]
    assert _counter("forest.host_syncs") - s0 == 2 * 2 * 3
    plain = convert.party_trees_to_numpy(
        FederatedForest(p, device="cuda").fit(part, y).trees_)
    for i, (trees, spans) in enumerate(runs):
        _assert_same_forest(trees, plain, "regression", f"run {i}")
        levels = [s for s in spans if s["name"] == "tree.level"]
        assert sorted((s["attrs"]["tree"], s["attrs"]["level"])
                      for s in levels) == [(t, d) for t in range(2)
                                           for d in range(6)]
        path = {s["attrs"]["level"]: s["attrs"]["path"] for s in levels}
        assert path == {0: "dense", 1: "dense", 2: "frontier",
                        3: "frontier", 4: "frontier", 5: "leaf"}
        warm = {(0, 0)} if i == 0 else set()
        for s in levels:
            a = s["attrs"]
            assert a.get("graph") == (None if (i, a["tree"]) in warm else 1)
        live = [s for s in spans if s["name"] == "tree.live_count"]
        assert len(live) == 2 * 3


def test_regression_fit_on_card_matches_cpu(cuda):
    """Float sums associate differently on the card, so the fixture is one
    whose trees meet no near-tie (tests/test_torch_tree.py): the same
    splits, and leaf stats within rtol 1e-5."""
    x, y = make_regression(1200, 13, seed=2)
    part = make_vertical_partition(x, 2, 16)
    for cap in (0, 3):
        p = ForestParams(task="regression", n_estimators=3, max_depth=5,
                         n_bins=16, seed=7, frontier_cap=cap)
        got, want = (convert.party_trees_to_numpy(
            FederatedForest(p, device=dev).fit(part, y).trees_)
            for dev in ("cuda", "cpu"))
        for f in ("is_leaf", "has_split", "split_floc", "split_bin", "owner",
                  "split_gid"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"{cap} {f}")
        np.testing.assert_allclose(got["leaf_stats"], want["leaf_stats"],
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_streamed_resumable_fit_on_card_equals_cpu(cuda, task, tmp_path):
    """Streamed ingest plus fit_resumable on the card equals the same on
    the CPU, and a checkpoint written on the CPU resumes on the card:
    classification bit for bit (shuffled superset party extracts);
    regression with the same splits and leaf stats within rtol 1e-5, on
    the pre-aligned fixture whose trees meet no near-tie."""
    if task == "classification":
        x, y = make_classification(1500, 20, 2, n_informative=6, seed=3)
        blocks, _, _ = make_party_views(x, y, 2, overlap=0.8, seed=3)
        kw = dict(n_estimators=4, max_depth=6, n_bins=32, seed=5)
    else:
        x, y = make_regression(1200, 13, seed=2)
        ids = np.arange(len(x))
        blocks = [PartyBlock("party000", x[:, :7], ids=ids, y=y,
                             feature_ids=np.arange(7)),
                  PartyBlock("party001", x[:, 7:], ids=ids,
                             feature_ids=np.arange(7, 13))]
        kw = dict(task="regression", n_estimators=3, max_depth=5, n_bins=16,
                  seed=7)
    small = ForestParams(**dict(kw, n_estimators=kw["n_estimators"] - 1))
    full = ForestParams(**kw)
    got = {}
    for dev in ("cpu", "cuda"):
        fed = Federation(parties=2, n_bins=kw["n_bins"], device=dev)
        fed.ingest([ArraySource(b) for b in blocks], chunk_rows=97)
        fed.fit_resumable(small, str(tmp_path / dev), trees_per_chunk=2)
        got[dev, "own"] = fed.fit_resumable(full, str(tmp_path / dev))
        got[dev, "fit"] = fed.fit(full)
    # the CPU's 2-tree checkpoint, resumed on the card
    shutil.copytree(tmp_path / "cpu", tmp_path / "mixed")
    shutil.rmtree(tmp_path / "mixed" / f"step_{full.n_estimators:08d}")
    before = hist.histogram_cuda.launches
    got["cuda", "resumed"] = fed.fit_resumable(full, str(tmp_path / "mixed"))
    assert hist.histogram_cuda.launches > before
    want = convert.party_trees_to_numpy(got["cpu", "own"].trees_)
    for key, model in got.items():
        t = convert.party_trees_to_numpy(model.trees_)
        if task == "classification":
            for f in t:
                np.testing.assert_array_equal(t[f], want[f],
                                              err_msg=f"{key} {f}")
            continue
        for f in SPLIT_FIELDS:
            np.testing.assert_array_equal(t[f], want[f],
                                          err_msg=f"{key} {f}")
        np.testing.assert_allclose(t["leaf_stats"], want["leaf_stats"],
                                   rtol=1e-5, atol=0)


def _qkv(dev, b, h, sq, sk, d, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn((b, h, s, d), generator=g).to(dtype).to(dev)
                 for s in (sq, sk, sk))


@pytest.mark.parametrize("sq,sk,d,causal,window,dtype", [
    (128, 128, 64, True, None, "float32"),
    (128, 128, 64, False, None, "float32"),
    (256, 256, 64, True, None, "float32"),
    (256, 256, 64, False, None, "float32"),
    (128, 384, 128, True, None, "float32"),
    (128, 384, 128, False, None, "float32"),
    (256, 256, 64, True, 128, "float32"),
    (256, 256, 64, True, 128, "bfloat16"),
    (96, 160, 64, False, 16, "float32"),
    (200, 72, 64, True, None, "float32"),     # rows without keys: exactly 0
    (513, 513, 128, True, None, "bfloat16"),
    # the same sweep through the bf16 tensor-core route
    (128, 128, 64, True, None, "bfloat16"),
    (128, 128, 64, False, None, "bfloat16"),
    (256, 256, 64, True, None, "bfloat16"),
    (256, 256, 64, False, None, "bfloat16"),
    (128, 384, 128, True, None, "bfloat16"),
    (128, 384, 128, False, None, "bfloat16"),
    (96, 160, 64, False, 16, "bfloat16"),
    (200, 72, 64, True, None, "bfloat16"),    # rows without keys: exactly 0
    (1000, 1000, 128, True, None, "bfloat16"),  # no multiple of any tile
    # D = 112 (zamba2-7b's shared attention) through the D = 128 bodies
    (128, 128, 112, True, None, "float32"),
    (96, 160, 112, False, 16, "float32"),
    (200, 72, 112, True, None, "float32"),
    (128, 128, 112, True, None, "bfloat16"),
    (256, 256, 112, False, None, "bfloat16"),
    (200, 72, 112, True, None, "bfloat16"),
    (1000, 1000, 112, True, None, "bfloat16"),
    # whisper's encoder (Sq = Sk = 1500) and cross-attention (Sq < Sk =
    # 1500): non-causal over a ragged last key tile
    (1500, 1500, 64, False, None, "bfloat16"),
    (1500, 1500, 64, False, None, "float32"),
    (416, 1500, 64, False, None, "bfloat16"),
    (416, 1500, 64, False, None, "float32"),
    # whisper's decoder self-attention: causal over a ragged last tile, D 64
    (416, 416, 64, True, None, "bfloat16"),
    (416, 416, 64, True, None, "float32"),
])
def test_attention_kernel_matches_plain(cuda, sq, sk, d, causal, window,
                                        dtype):
    dt = getattr(torch, dtype)
    q, k, v = _qkv(cuda, 2, 2, sq, sk, d, dt, seed=sq + sk + d)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert got.dtype == dt and torch.equal(got, again)      # deterministic
    tol = 2e-3 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        # and within the route's error model, element by element: P rounded
        # to bf16 moves an output by at most 2^-8 of the attention over |v|
        # (taken twice here), and the two bf16 outputs differ by at most one
        # ulp, 2^-7 |want|
        scale = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                        causal=causal, window=window)
        bound = 2**-7 * (scale + want.float().abs()) + 1e-5
        assert bool(((got.float() - want.float()).abs() <= bound).all())
    if causal and sq > sk:
        assert bool((got[:, :, :sq - sk] == 0).all())


def test_attention_wrapper_refuses(cuda):
    for d in (96, 80, 120):
        q, k, v = _qkv(cuda, 1, 2, 64, 64, d, torch.float32)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 2, 64, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k.to(torch.bfloat16), v)
    # TMA needs 16-byte aligned bf16 rows; float32 takes any float's address
    n = q.numel()
    for dt, ok in ((torch.bfloat16, False), (torch.float32, True)):
        qo, ko, vo = (torch.empty(n + 1, dtype=dt, device=cuda)[1:].view(
            q.shape).copy_(t) for t in (q, k, v))
        if ok:
            torch.testing.assert_close(flash_attention(qo, ko, vo),
                                       ref.flash_attention_ref(q, k, v),
                                       rtol=2e-3, atol=2e-3)
        else:
            with pytest.raises(ValueError, match="16-byte"):
                flash_attention(qo, ko, vo)


def test_prefill_consistent_with_decode_on_card(cuda):
    """internlm2-1.8b's width in float32 at 2 layers: the last logits of
    prefill(S + 1), attention through the kernel, against prefill(S) then
    decode_step(S), attention over the ring cache through _sdpa_chunked."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get("internlm2-1.8b").with_(n_layers=2, dtype="float32")
    model = transformer.init_params(cfg, seed=0, device=cuda)
    s = 512
    toks = torch.as_tensor(lm._markov_tokens(np.random.default_rng(1),
                                             cfg.vocab, (2, s + 1)),
                           dtype=torch.int64, device=cuda)
    before = flash_attention.launches
    la, _ = model.prefill(toks)
    assert flash_attention.launches == before + cfg.n_layers
    _, cache = model.prefill(toks[:, :s], cache_len=s + 1)
    lb, _ = model.decode_step(cache, toks[:, s:], s)
    torch.testing.assert_close(la, lb, rtol=0, atol=2e-3)
    assert torch.equal(la.argmax(-1), lb.argmax(-1))


# ------------------------------------------- boosting, F-LR and classical
BOOST_KW = dict(n_rounds=8, max_depth=4, n_bins=16)


def _boost_data(task):
    """tests/test_torch_boosting.py's fixtures, whose rounds meet no
    near-tie."""
    if task == "regression":
        x, y = make_regression(600, 12, seed=0)
    else:
        x, y = make_classification(600, 12, 2, seed=1)
    return x[:450], y[:450]


@pytest.mark.parametrize("task", ["regression", "binary"])
def test_boosting_rounds_on_card_equal_cpu(cuda, task):
    """Each round refitted on the CPU from the card's margin after the
    rounds before it: the same splits, leaf stats within 1e-5 of the
    node's Σ|stat| (c0 + c2 bounds it); the decision functions within
    rtol 1e-5, atol 1e-6."""
    from repro_torch.core import BoostParams, FederatedBoosting
    from repro_torch.federation import programs
    x, y = _boost_data(task)
    part = make_vertical_partition(x, 2, 16)
    bp = BoostParams(task=task, **BOOST_KW)
    card = FederatedBoosting(bp, device=cuda).fit(part, y)
    cpu = FederatedBoosting(bp, device="cpu")
    prog = cpu._round_program(part)
    f = np.full(len(y), card.base_)
    xb = torch.as_tensor(part.xb, device=cuda)
    for r, trees in enumerate(card.trees_):
        got = convert.party_trees_to_numpy(
            cpu._fit_round(prog, np.asarray(y, np.float64), f))
        want = convert.party_trees_to_numpy(trees)
        for k in SPLIT_FIELDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{r} {k}")
        ls = want["leaf_stats"]
        err = np.abs(got["leaf_stats"] - ls).max(-1)
        assert (err <= 1e-5 * (ls[..., 0] + ls[..., 2])).all(), r
        f = f + bp.learning_rate * programs.party0(card._pred_run(trees, xb))
    cpu.fit(part, y)
    np.testing.assert_allclose(card.decision_function(x),
                               cpu.decision_function(x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("task", ["regression", "binary"])
def test_boosting_fb2_equals_fb1_on_card(cuda, task):
    from repro_torch.core import BoostParams, FederatedBoosting
    x, y = _boost_data(task)
    bp = BoostParams(task=task, **BOOST_KW)
    one, two = (FederatedBoosting(bp, device=cuda).fit(
        make_vertical_partition(x, m, 16), y) for m in (1, 2))
    for a, b in zip(one.trees_, two.trees_):
        ta, tb = (convert.party_trees_to_numpy(t) for t in (a, b))
        for k in ("is_leaf", "leaf_stats", "split_gid"):
            np.testing.assert_array_equal(ta[k][0], tb[k][0], err_msg=k)
    np.testing.assert_array_equal(one.decision_function(x),
                                  two.decision_function(x))


def test_signed_c3_histogram_within_error_model(cuda):
    """Boosting's stats (hh, hh·p, hh·p²), the middle channel signed and
    summing to 0: each cell within (γ_k + γ_p)·H|s| of the plain version
    (γ_k from launch_plan's summation depth, γ_p for the plain version's
    contraction over N samples) and within γ_k·H|s| of the float64 sums;
    two launches bit-equal."""
    n, f, b, lv, c = 20000, 24, 32, 32, 3
    g = torch.Generator(device="cpu").manual_seed(5)
    xb = torch.randint(0, b, (n, f), generator=g).to(torch.uint8).to(cuda)
    seg = torch.randint(-1, lv, (n,), generator=g,
                        dtype=torch.int32).to(cuda)
    hh = torch.rand(n, generator=g, dtype=torch.float64) / 4 + 1e-6
    p = torch.randn(n, generator=g, dtype=torch.float64)
    p -= (hh * p).sum() / hh.sum()
    stats = torch.stack([hh, hh * p, hh * p * p], -1).float().to(cuda)
    xc = hist.column_major(xb)
    got = hist.histogram_cuda(xc, seg, stats, lv, b)
    assert torch.equal(got, hist.histogram_cuda(xc, seg, stats, lv, b))
    want = ref.histogram_ref(xb, seg, stats, lv, b)
    flat, vals = ops._flat_buckets(xb.cpu(), seg.cpu(), stats.cpu(), lv, b)

    def f64_hist(v):
        out = torch.zeros((lv * f * b + 1, c), dtype=torch.float64)
        return out.index_add_(0, flat, v.double())[:-1].reshape(lv, f, b, c)
    exact, habs = f64_hist(vals), f64_hist(vals.abs())
    plan = hist.launch_plan(n, f, lv, b, c, hist.smem_limit(cuda.index or 0))
    gamma_plain = n * 2.0**-24 / (1 - n * 2.0**-24)
    got, want = got.cpu().double(), want.cpu().double()
    assert ((got - want).abs() <= (plan.gamma + gamma_plain) * habs).all()
    assert ((got - exact).abs() <= plan.gamma * habs).all()


def test_flr_on_card_matches_cpu(cuda):
    from repro_torch.core import FederatedLinear
    from repro_torch.core.fedlinear import split_columns
    x, y = make_classification(2000, 30, 2, seed=4)
    blocks = split_columns(x[:1500], 3)
    card = FederatedLinear(device=cuda).fit(blocks, y[:1500])
    cpu = FederatedLinear(device="cpu").fit(blocks, y[:1500])
    np.testing.assert_allclose(card._w.cpu().numpy(), cpu._w.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(card._b.cpu().numpy(), cpu._b.numpy(),
                               rtol=1e-4, atol=1e-5)
    test = split_columns(x[1500:], 3)
    assert np.mean(card.predict(test) == cpu.predict(test)) > 0.99
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="F-LR needs full-float32"):
            FederatedLinear(device=cuda, steps=1).fit(blocks, y[:1500])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_predict_classical_equals_predict_on_card(cuda, task):
    if task == "classification":
        x, y = make_classification(1500, 20, 2, n_informative=6, seed=3)
    else:
        x, y = make_regression(1500, 20, seed=3)
    part = make_vertical_partition(x[:1200], 3, 32)
    p = ForestParams(task=task, n_estimators=4, max_depth=6, n_bins=32,
                     seed=5)
    model = FederatedForest(p, device=cuda).fit(part, y[:1200])
    np.testing.assert_array_equal(model.predict_classical(x[1200:]),
                                  model.predict(x[1200:]))


# ------------------------------------------------------------------ serving
def _served_forest(cuda, n=2600, parties=3, trees=5, depth=6):
    x, y = make_classification(n, 24, 3, seed=11)
    fed = Federation(parties=parties, n_bins=16)
    fed.ingest(x[:2000], y[:2000])
    model = fed.fit(ForestParams(n_classes=3, n_estimators=trees,
                                 max_depth=depth, n_bins=16, seed=2))
    return fed, model, x[2000:]


def test_serve_captures_one_graph_per_bucket(cuda):
    """warmup captures one CUDA graph per bucket; traffic of every bucket
    replays them and captures nothing new; served == predict."""
    from repro_torch.federation import substrate
    from repro_torch.serving import RequestQueue, ServeConfig
    fed, model, xte = _served_forest(cuda)
    server = fed.serve(model, ServeConfig(buckets=(32, 128, 512)))
    assert server.device.type == "cuda"
    c0 = substrate.capture_graph.captures
    server.warmup()
    assert server.compile_count == 3
    assert substrate.capture_graph.captures - c0 == 3
    want = fed.predict(model, xte)
    for n in (3, 32, 77, 128, 400, 512, 600):
        np.testing.assert_array_equal(server.serve(xte[:n]), want[:n])
    q = RequestQueue(server)
    rids = [q.submit(xte[lo:lo + s]) for lo, s in ((0, 5), (5, 300), (305, 1))]
    res = q.drain()
    for rid, (lo, s) in zip(rids, ((0, 5), (5, 300), (305, 1))):
        np.testing.assert_array_equal(res[rid], want[lo:lo + s])
    assert {w["bucket"] for w in server.wave_stats} == {32, 128, 512}
    assert server.compile_count == 3
    assert substrate.capture_graph.captures - c0 == 3
    # a retune keeps the graphs of the buckets that survive it
    server.set_buckets((128, 512, 1024)).warmup()
    assert substrate.capture_graph.captures - c0 == 4
    np.testing.assert_array_equal(server.serve(xte), want)
    assert substrate.capture_graph.captures - c0 == 4


def test_serve_sync_equals_async_many_waves_of_one_bucket(cuda):
    """Several waves of ONE bucket in flight at once share the bucket's
    static input and output on the server's stream, and the ring slots'
    pinned buffers: async (4) == sync (1), bit for bit."""
    from repro_torch.serving import RequestQueue, ServeConfig
    fed, model, xte = _served_forest(cuda)
    sync = fed.serve(model, ServeConfig(buckets=(64,), max_inflight=1))
    asyn = fed.serve(model, ServeConfig(buckets=(64,), max_inflight=4))
    got_s, got_a = sync.serve(xte), asyn.serve(xte)      # 600 rows: 10 waves
    np.testing.assert_array_equal(got_s, got_a)
    np.testing.assert_array_equal(got_a, fed.predict(model, xte))
    assert max(w["inflight"] for w in asyn.wave_stats) == 4
    assert {w["bucket"] for w in asyn.wave_stats} == {64}
    q = RequestQueue(asyn)
    rids = [q.submit(xte[i:i + 37]) for i in range(0, 555, 37)]
    res = q.drain()
    for k, rid in enumerate(rids):
        np.testing.assert_array_equal(res[rid], got_s[37 * k:37 * k + 37])


def test_fleet_threads_capture_lazily_and_equal_single_server(cuda):
    """Four cells drained on threads, each capturing its buckets lazily
    inside its drain while other cells replay: every request equals the
    single server's answer."""
    from repro_torch.federation import substrate
    from repro_torch.serving import ServeConfig
    fed, model, xte = _served_forest(cuda)
    cfg = ServeConfig(buckets=(32, 128))
    fleet = fed.serve_fleet(model, cfg, n_cells=4)        # no warmup
    single = fed.serve(model, cfg)
    c0 = substrate.capture_graph.captures
    rng = np.random.default_rng(0)
    rids = {}
    for i in range(40):
        chunk = xte[rng.integers(0, len(xte), size=int(rng.integers(1, 99)))]
        rids[fleet.submit(chunk, key=f"q{i}")] = chunk
    out = fleet.drain()
    assert set(out) == set(rids)
    used = sum(c.server.compile_count for c in fleet.cells.values())
    assert used >= 4 and substrate.capture_graph.captures - c0 == used
    for rid, chunk in rids.items():
        np.testing.assert_array_equal(out[rid], single.serve(chunk))


def test_refresh_after_fit_resumable_recaptures(cuda, tmp_path):
    """A fit_resumable continuation that extends the forest refreshes the
    cached server: its graphs are dropped and recaptured over the new
    stack, and the served output equals predict."""
    from repro_torch.federation import substrate
    from repro_torch.serving import ServeConfig
    x, y = make_classification(1500, 16, 2, seed=5)
    fed = Federation(parties=2, n_bins=16)
    fed.ingest(x[:1200], y[:1200])
    p = ForestParams(n_estimators=4, max_depth=5, n_bins=16, seed=3)
    model = fed.fit_resumable(p, str(tmp_path))
    cfg = ServeConfig(buckets=(64, 256))
    server = fed.serve(model, cfg).warmup()
    np.testing.assert_array_equal(server.serve(x[1200:]),
                                  fed.predict(model, x[1200:]))
    c0, k0 = substrate.capture_graph.captures, server.compile_count
    fed.fit_resumable(dataclasses.replace(p, n_estimators=6),
                      str(tmp_path), model=model)
    assert fed.serve(model, cfg) is server
    assert int(server.trees.is_leaf.shape[1]) == 6
    np.testing.assert_array_equal(server.serve(x[1200:]),
                                  fed.predict(model, x[1200:]))
    assert server.compile_count == k0 + 2
    assert substrate.capture_graph.captures - c0 == 2


def test_boosting_and_flr_servers_equal_predict_on_card(cuda):
    """BoostingServer (binary labels) and LinearServer (F-LR labels) on
    the card equal their model's predict."""
    from repro_torch.core import BoostParams, LinearParams
    from repro_torch.serving import ServeConfig
    x, y = make_classification(2400, 20, 2, n_informative=6, seed=7)
    fed = Federation(parties=2, n_bins=16)
    part = fed.ingest(x[:1800], y[:1800])
    cfg = ServeConfig(buckets=(32, 256), max_inflight=3)
    boost = fed.fit(BoostParams(task="binary", n_rounds=6, max_depth=4,
                                n_bins=16))
    np.testing.assert_array_equal(fed.serve(boost, cfg).serve(x[1800:]),
                                  boost.predict(x[1800:]))
    flr = fed.fit(LinearParams(steps=150))
    server = fed.serve(flr, cfg).warmup()
    assert server.compile_count == 2
    np.testing.assert_array_equal(server.serve(x[1800:]),
                                  flr.predict(part.split_raw(x[1800:])))


def test_capture_of_a_host_sync_raises(cuda):
    """A program that syncs with the host cannot be captured: the capture
    raises (there is no eager fallback), and the card stays usable."""
    from repro_torch.federation import substrate
    x = torch.ones(8, device=cuda)
    c0 = substrate.capture_graph.captures
    with pytest.raises(RuntimeError):
        substrate.capture_graph(lambda t: t * t.sum().item(), x)
    assert substrate.capture_graph.captures == c0
    g = substrate.capture_graph(lambda t: t * 2, x)
    assert torch.equal(g(torch.full((8,), 3.0, device=cuda)),
                       torch.full((8,), 6.0, device=cuda))


def _party_launches(fed) -> list[int]:
    """Each worker's histogram launches so far, through the telemetry
    rollup (a worker's counter is cumulative; the rollup adds it)."""
    from repro_torch.observability import registry as telemetry

    def merged(p):
        c = telemetry.REGISTRY.get(f"party{p}.kernels.histogram.launches")
        return 0 if c is None else c.value
    before = [merged(p) for p in range(fed.parties)]
    fed.collect_telemetry()
    return [merged(p) - b for p, b in enumerate(before)]


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_distributed_fit_on_card_equals_simulated(cuda, task):
    """Two party processes on the card, each running the histogram kernel
    over its own columns, build the simulated fit's forest on the card bit
    for bit (the kernel's launch plan depends on N, B and C alone); each
    worker launches the kernel as often as the simulated fit does."""
    if task == "classification":
        x, y = make_classification(1200, 13, 2, n_informative=5, seed=0)
    else:
        x, y = make_regression(1200, 13, seed=2)
    for cap in (0, 3):
        p = ForestParams(task=task, n_estimators=3, max_depth=5, n_bins=16,
                         seed=7, frontier_cap=cap)
        sim = Federation(parties=2, n_bins=16)
        sim.ingest(x, y)
        hist.histogram_cuda.launches = 0
        ref = sim.fit(p)
        want_launches = hist.histogram_cuda.launches
        with Federation(parties=2, n_bins=16, substrate="distributed") as fed:
            fed.ingest(x, y)
            model = fed.fit(p)
            assert model.trees_.is_leaf.is_cuda
            got, want = (convert.party_trees_to_numpy(m.trees_)
                         for m in (model, ref))
            for f in want:
                np.testing.assert_array_equal(got[f], want[f],
                                              err_msg=f"{cap} {f}")
            assert _party_launches(fed) == [want_launches] * 2
            np.testing.assert_array_equal(fed.predict(model, x[:300]),
                                          sim.predict(ref, x[:300]))


def test_cuda_copy_of_a_raw_block_is_clean(cuda):
    """The egress contract on the card: a CUDA copy of a raw block is a
    new buffer and clean, as a ``.clone()`` is (and as JAX device arrays
    were never tagged), while the CPU tensor it was copied from is
    refused."""
    from repro_torch.analysis import runtime as egress_rt

    assert egress_rt.enabled(), "tests/conftest.py arms the guard"
    block = PartyBlock(name="card", x=np.arange(12.0).reshape(4, 3),
                       ids=np.arange(4))
    host = torch.from_numpy(block.x)
    assert egress_rt.lookup(host) is not None
    for on_card in (host.to(cuda), torch.as_tensor(block.ids, device=cuda)):
        assert egress_rt.lookup(on_card) is None
        egress_rt.check_egress({"x": on_card})
    with pytest.raises(egress_rt.PrivacyViolationError):
        egress_rt.check_egress({"x": host})


def _rank_counts(fed, name: str) -> list[int]:
    """Each sharded rank's own (cumulative) counter, through the rollup."""
    from repro_torch.observability import registry as telemetry

    def merged(r):
        c = telemetry.REGISTRY.get(f"rank{r}.{name}")
        return 0 if c is None else c.value
    before = [merged(r) for r in range(fed.substrate.mesh.size)]
    fed.collect_telemetry()
    return [merged(r) - b for r, b in enumerate(before)]


@pytest.mark.parametrize("backend,parties", [("gloo", 2), ("nccl", 1)])
def test_sharded_fit_on_card_equals_simulated(cuda, backend, parties):
    """Sharded ranks on the card (two gloo ranks on one card, its
    collectives staged through host buffers and counted; or one NCCL
    rank) build the simulated fit's forest bit for bit, each rank
    launching the kernel as often as the simulated fit does."""
    from repro_torch.launch.mesh import make_forest_mesh
    x, y = make_classification(1200, 13, 2, n_informative=5, seed=0)
    p = ForestParams(n_estimators=3, max_depth=5, n_bins=16, seed=7)
    sim = Federation(parties=parties, n_bins=16)
    sim.ingest(x, y)
    hist.histogram_cuda.launches = 0
    ref = sim.fit(p)
    want_launches = hist.histogram_cuda.launches
    mesh = make_forest_mesh(trees=1, parties=parties, backend=backend)
    with Federation(parties=parties, n_bins=16, substrate="sharded",
                    mesh=mesh) as fed:
        fed.ingest(x, y)
        model = fed.fit(p)
        assert model.trees_.is_leaf.is_cuda
        got, want = (convert.party_trees_to_numpy(m.trees_)
                     for m in (model, ref))
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert _rank_counts(fed, "kernels.histogram.launches") \
            == [want_launches] * parties
        staged = _rank_counts(fed, "sharded.staged_bytes")
        assert all(s > 0 for s in staged) if backend == "gloo" \
            else staged == [0]
        np.testing.assert_array_equal(fed.predict(model, x[:300]),
                                      sim.predict(ref, x[:300]))


def test_sharded_hist_subtraction_and_classical_on_card(cuda):
    """Two gloo ranks on the card: ``hist_subtraction`` fits (alone and
    with a multi-pass frontier) equal the simulated fit in all seven
    fields, and the classical predict on the ranks equals ``predict``."""
    from repro_torch.launch.mesh import make_forest_mesh
    x, y = make_classification(1200, 13, 2, n_informative=5, seed=0)
    sim = Federation(parties=2, n_bins=16)
    sim.ingest(x[:900], y[:900])
    mesh = make_forest_mesh(trees=1, parties=2, backend="gloo")
    with Federation(parties=2, n_bins=16, substrate="sharded",
                    mesh=mesh) as fed:
        fed.ingest(x[:900], y[:900])
        for cap in (0, 3):
            p = ForestParams(n_estimators=3, max_depth=5, n_bins=16, seed=7,
                             hist_subtraction=True, frontier_cap=cap)
            got, want = (convert.party_trees_to_numpy(m.trees_)
                         for m in (fed.fit(p), sim.fit(p)))
            for f in want:
                np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        model = fed.fit(ForestParams(n_estimators=3, max_depth=5, n_bins=16,
                                     seed=7))
        np.testing.assert_array_equal(model.predict_classical(x[900:]),
                                      model.predict(x[900:]))


@pytest.mark.parametrize("arch,launches", [("whisper-large-v3", 6),
                                           ("qwen2-vl-2b", 2)])
def test_encdec_and_vlm_prefill_on_card_equal_cpu(cuda, arch, launches):
    """whisper-large-v3 (encoder, decoder self- and cross-attention, each
    a flash launch) and qwen2-vl-2b (patches) at the reduced size in
    float32, with their frames or patches: prefill logits and caches on the
    card within 1e-4 of the CPU's largest, the launches counted, and
    prefill(S + 1) against prefill(S) + decode_step(S) within 2e-3."""
    import copy
    from repro_torch.configs.base import reduced
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(registry.get(arch))
    batch = next(lm.synthetic_lm_batches(cfg, 2, 33, seed=1, device="cpu"))
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    cpu_model = transformer.init_params(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    toks = batch["tokens"]
    want, wcache = cpu_model.prefill(toks[:, :32], extras=extras)
    before = flash_attention.launches
    got, gcache = gpu_model.prefill(
        toks[:, :32].to(cuda), extras={k: v.to(cuda) for k, v in
                                       extras.items()})
    assert flash_attention.launches == before + launches
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    leaves = (lambda c: {f"{i}.{k}": v for i, layer in enumerate(c)
                         for k, v in layer.items()})
    if cfg.cross_attention:
        leaves = (lambda c: {f"{i}.{p}.{k}": v for i, layer in enumerate(c)
                             for p, d in layer.items()
                             for k, v in d.items()})
    for k, w in leaves(wcache).items():
        g = leaves(gcache)[k].cpu()
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()) + 1e-12)
    gx = {k: v.to(cuda) for k, v in extras.items()}
    la, _ = gpu_model.prefill(toks.to(cuda), extras=gx)
    _, cache = gpu_model.prefill(toks[:, :32].to(cuda), cache_len=33,
                                 extras=gx)
    lb, _ = gpu_model.decode_step(cache, toks[:, 32:].to(cuda), 32)
    torch.testing.assert_close(la, lb, rtol=0, atol=2e-3)


def _lm_step(model, tokens, lr):
    from repro_torch.train import adamw_init, adamw_update
    model.requires_grad_()
    names, params = zip(*model.named_parameters())
    loss, _ = transformer.lm_loss(model, {"tokens": tokens})
    grads = torch.autograd.grad(loss, params)
    adamw_update(model, dict(zip(names, grads)), adamw_init(model), lr=lr)
    return (float(loss.detach()),
            {n: g.detach().cpu() for n, g in zip(names, grads)},
            {n: p.detach().cpu() for n, p in zip(names, params)})


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b"])
def test_train_step_on_card_equals_cpu(cuda, arch):
    """One training step at the reduced size in float32 (TF32 off), the
    same weights on both devices: loss within rtol 1e-5, every gradient
    leaf within 1e-3 of its largest magnitude, the parameters after AdamW
    within 1e-3·lr where the gradient is at least 1e-2 of its leaf's
    largest (2·lr elsewhere, Adam's first step amplifying rounding in
    near-zero gradients); no flash launch."""
    import copy
    from repro_torch.configs.base import reduced
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(registry.get(arch))
    cpu_model = transformer.init_params(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    toks = torch.as_tensor(lm._markov_tokens(np.random.default_rng(0),
                                             cfg.vocab, (2, 64)),
                           dtype=torch.int64)
    lr = 3e-3
    want = _lm_step(cpu_model, toks, lr)
    before = flash_attention.launches
    got = _lm_step(gpu_model, toks.to(cuda), lr)
    assert flash_attention.launches == before
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    for k, g in want[1].items():
        assert float((got[1][k] - g).abs().max()) \
            <= 1e-3 * float(g.abs().max()) + 1e-12, k
        diff = (got[2][k] - want[2][k]).abs()
        cond = g.abs() >= 1e-2 * g.abs().max()
        assert float(diff[cond].max()) <= 1e-3 * lr, k
        assert float(diff.max()) <= 2 * lr, k


def test_flash_wrapper_refuses_grad_on_card(cuda):
    q = torch.randn((1, 2, 64, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        flash_attention(q, q.detach(), q.detach())
    with torch.no_grad():
        assert flash_attention(q, q, q).shape == q.shape


def test_moe_layer_on_card_equals_cpu(cuda):
    """qwen2-moe's reduced MoE layer in float32, the same weights and
    tokens on both devices: the same kept slots, y within 1e-4 of its
    largest magnitude, aux within 1e-6."""
    import copy
    import math
    from repro_torch.configs.base import reduced
    from repro_torch.models import layers
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(registry.get("qwen2-moe-a2.7b")).with_(moe_capacity=1.25)
    p_cpu = layers.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    p_gpu = copy.deepcopy(p_cpu).to(cuda)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32))
    t, k = 128, cfg.top_k
    cap = int(math.ceil(t * k / cfg.n_experts * cfg.moe_capacity))
    out = []
    with torch.no_grad():
        for p, xx in ((p_cpu, x), (p_gpu, x.to(cuda))):
            probs = torch.softmax((xx.reshape(t, -1) @ p.router).float(), -1)
            slots = layers.moe_slots(layers._top_k(probs, k)[1],
                                     cfg.n_experts, p.we_gate.shape[0], cap)
            y, aux = layers.moe(p, xx, cfg)
            out.append((slots.cpu(), y.cpu(), float(aux)))
    assert torch.equal(out[0][0], out[1][0])
    assert float((out[0][1] - out[1][1]).abs().max()) \
        <= 1e-4 * float(out[0][1].abs().max())
    assert abs(out[0][2] - out[1][2]) <= 1e-6


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_ssm_blocks_on_card_equal_cpu(cuda, kind):
    """Each recurrent block at its config's reduced width in float32, the
    same weights and inputs on both devices: y and every cache leaf within
    1e-4 of the leaf's largest magnitude, over 80 tokens (chunk 32, a
    ragged third chunk) and then one decode step from that cache."""
    import copy
    from repro_torch.configs.base import reduced
    from repro_torch.models import ssm
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = "zamba2-7b" if kind == "mamba2" else "xlstm-350m"
    cfg = reduced(registry.get(arch))
    core = ssm.INITS[kind](torch.Generator().manual_seed(1), cfg, "cpu")
    core_gpu = copy.deepcopy(core).to(cuda)
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(2, 81, cfg.d_model)).astype(np.float32))
    fn = ssm.BLOCKS[kind]
    with torch.no_grad():
        outs = []
        for c, xx in ((core, x), (core_gpu, x.to(cuda))):
            y, cache = fn(c, xx[:, :80], cfg)
            y1, cache1 = fn(c, xx[:, 80:], cfg, cache=cache)
            outs.append({"y": y, "y1": y1,
                         **{f"prefill {k}": v for k, v in cache.items()},
                         **{f"decode {k}": v for k, v in cache1.items()}})
    for k, want in outs[0].items():
        got = outs[1][k].cpu()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (k, err)

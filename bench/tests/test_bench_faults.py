"""The comparison that decides ``correct`` fails where it must.

A whole run of each cell, on the CPU at a small size (the harness's look
for a card skipped), first as it is and then with the timed path broken
underneath, once for each fault the cell can have; and the control — the
reference in bfloat16 in the program's place — read against the cell's
limits.  The same control runs on the card at the cells' own sizes
(``bench/control.py``)."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench import control, harness
from bench.tests.conftest import small_config, small_mix
from repro_torch.core import tree as tree_mod
from repro_torch.kernels import ops
from repro_torch.serving import engine, queue

FIT_CELLS = {"ff-kdd99.fit": dict(), "ff-year.fit": dict(depth=6, cap=8)}


def _run(spec, cell, device="cpu", **cfg_kw):
    """A whole run of ``cell`` at a small size (the fit cells' tests pass
    ``conftest.spec_plus``, which holds ``ff-kdd99.fit`` too)."""
    name = harness.find_cell(spec, cell)["config"]
    cfg = small_config(spec, name, **cfg_kw)
    mix = small_mix(harness.find_cell(spec, cell)["traffic"])
    if mix["driver"] == "open_loop":
        mix["check_requests"] = 10 ** 6       # judge every request here
    return harness.run_cell(spec, cell, 987654321123, 0.5, False,
                            t_start=time.perf_counter(), device=device,
                            config=cfg, mix=mix)


# ----------------------------------------------------------- the faults
def _altered_split(monkeypatch):
    """An answer altered where it is produced: the root's split bin of
    every tree moves one bin."""
    real = tree_mod.build_tree

    def build(*a, **kw):
        t = real(*a, **kw)
        owner = int(t.owner[0, 0])
        if owner >= 0:
            t.split_bin[owner, 0] = (t.split_bin[owner, 0] + 1) % 4
        return t
    monkeypatch.setattr(tree_mod, "build_tree", build)


def _half_batch(monkeypatch):
    """Half of the rows left out of every histogram, the rest doubled."""
    real = ops.histogram

    def hist(xb, seg, stats, n_level, n_bins, impl="auto"):
        keep = torch.arange(seg.shape[0], device=seg.device) % 2 == 0
        return 2 * real(xb, torch.where(keep, seg, -1), stats, n_level,
                        n_bins, impl)
    monkeypatch.setattr(ops, "histogram", hist)


def _unchanged(monkeypatch):
    """The fit returns its trees as they start: every root a leaf."""
    real = tree_mod.build_tree

    def build(*a, **kw):
        t = real(*a, **kw)
        is_leaf = torch.zeros_like(t.is_leaf)
        is_leaf[:, 0] = True
        none = torch.full_like(t.owner, -1)
        return tree_mod.PartyTree(is_leaf, t.leaf_stats,
                                  torch.zeros_like(t.has_split),
                                  torch.full_like(t.split_floc, -1),
                                  torch.full_like(t.split_bin, -1), none,
                                  torch.full_like(t.split_gid, -1))
    monkeypatch.setattr(tree_mod, "build_tree", build)


def _no_exchange(monkeypatch):
    """The exchange between parties left out: the master reduces party
    0's bests alone."""
    real = tree_mod.reduce_level

    def reduce(g_all, gid_all, bin_all, cnt, params):
        g = g_all.clone()
        g[1:] = float("-inf")
        return real(g, gid_all, bin_all, cnt, params)
    monkeypatch.setattr(tree_mod, "reduce_level", reduce)


def _altered_answer(monkeypatch):
    """An answer altered where it is produced: the first row of every
    wave answers the other class."""
    real = engine.ModelServer._strip

    def strip(self, out, n):
        got = real(self, out, n).copy()
        got[0] = 1 - got[0]
        return got
    monkeypatch.setattr(engine.ModelServer, "_strip", strip)


def _half_wave(monkeypatch):
    """Half of each wave left out: its second half answers as the first
    row does."""
    real = engine.ModelServer._strip

    def strip(self, out, n):
        got = real(self, out, n).copy()
        got[n // 2:] = got[0]
        return got
    monkeypatch.setattr(engine.ModelServer, "_strip", strip)


FIT_FAULTS = [_altered_split, _half_batch, _unchanged, _no_exchange]
SERVE_FAULTS = [_altered_answer, _half_wave]


# ------------------------------------------------------------ the tests
@pytest.mark.parametrize("cell", sorted(FIT_CELLS) + ["ff-kdd99.serve"])
def test_sound_run_is_correct(spec_plus, cell):
    r = _run(spec_plus, cell, **FIT_CELLS.get(cell, {}))
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("fault", FIT_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(FIT_CELLS))
def test_fit_fault_is_caught(spec_plus, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(spec_plus, cell, **FIT_CELLS[cell])
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", SERVE_FAULTS, ids=lambda f: f.__name__)
def test_serve_fault_is_caught(spec, monkeypatch, fault):
    fault(monkeypatch)
    r = _run(spec, "ff-kdd99.serve")
    assert r["correct"] is False, r["checks"]


def test_failed_requests_make_a_run_incorrect(spec, monkeypatch):
    """A request that fails in the pump is evicted, never answered, and
    counts in ``failed``."""
    real = queue._Pending.party_rows

    def party_rows(self, server, start, take):
        if self.rid == 10:
            raise ValueError("planted")
        return real(self, server, start, take)
    monkeypatch.setattr(queue._Pending, "party_rows", party_rows)
    r = _run(spec, "ff-kdd99.serve")
    assert r["failed"] >= 1 and r["correct"] is False


@pytest.mark.parametrize("cell", sorted(FIT_CELLS) + ["ff-kdd99.serve"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(spec_plus, cell, seed):
    """The reference grown in bfloat16, judged by the harness's own
    comparison, comes out as not correct."""
    c = harness.find_cell(spec_plus, cell)
    cfg = small_config(spec_plus, c["config"], n=20000, depth=6,
                       **({"cap": 8} if "year" in cell else {}))
    mix = small_mix(c["traffic"], rate_per_s=300)
    got = control.judged(spec_plus, cell, seed, 1.0, "cpu", config=cfg,
                         mix=mix)
    assert got["correct"] is False, got["checks"]


def test_sound_run_on_the_card(spec_plus, cuda_device):
    for cell in sorted(FIT_CELLS) + ["ff-kdd99.serve"]:
        r = _run(spec_plus, cell, device=cuda_device, **FIT_CELLS.get(cell, {}))
        assert r["correct"] is True, (cell, r["checks"])
        assert np.isfinite(list(r["metrics"].values())[0]["value"])


pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")
test_sound_run_on_the_card = pytest.mark.cuda(test_sound_run_on_the_card)

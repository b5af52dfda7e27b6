"""The port's CUDA histogram kernel on the card: held against its plain
version on the sweep of tests/test_kernels.py and at a fit's shapes,
deterministic launch to launch, and a fit on the card equal to the CPU fit.
Needs an NVIDIA GPU and nvcc; each test skips elsewhere.  Run on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import impurity
from repro_torch.core.forest import FederatedForest
from repro_torch.core.party import make_vertical_partition
from repro_torch.core.types import ForestParams
from repro_torch.data import make_classification, make_regression
from repro_torch.kernels import histogram as hist
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


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
    (20000, 1, 1, 128, 2), (5000, 1, 1, 512, 3)])
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


def test_feature_order_independent(cuda):
    """A feature's cells get the same bits whatever other features share
    the launch — what makes folding the parties into one launch exact."""
    xb, seg, stats = _inputs(cuda, 4000, 12, 32, 16, 3, integer=False)
    whole = hist.histogram_cuda(hist.column_major(xb), seg, stats, 16, 32)
    part = hist.histogram_cuda(hist.column_major(xb[:, 5:9]), seg, stats, 16, 32)
    assert torch.equal(whole[:, 5:9], part)


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


def test_fit_on_card_equals_cpu(cuda):
    x, y = make_classification(1500, 20, 2, n_informative=6, seed=3)
    part = make_vertical_partition(x, 2, 32)
    trees = {}
    for dev in ("cuda", "cpu"):
        for cap in (0, 4):
            p = ForestParams(n_estimators=3, max_depth=6, n_bins=32, seed=5,
                             frontier_cap=cap)
            model = FederatedForest(p, device=dev).fit(part, y)
            trees[dev, cap] = convert.party_trees_to_numpy(model.trees_)
    for f, a in trees["cpu", 0].items():
        for key in (("cuda", 0), ("cuda", 4), ("cpu", 4)):
            np.testing.assert_array_equal(trees[key][f], a, err_msg=f"{key} {f}")


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

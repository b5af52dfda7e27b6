"""The histogram of the PyTorch port on the CPU — its ``scatter`` backend,
its einsum oracle and the CUDA kernel's wrapper, which computes the plain
version for a CPU tensor — held against the JAX package's oracle and its
Pallas kernel in interpret mode, on the sweep of tests/test_kernels.py.

rtol = atol = 1e-5 for float stats (the JAX sweep's tolerance: sums taken
in another order); integer-valued stats sum exactly, so they compare with
array_equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.histogram import histogram_pallas
from repro.kernels.ref import histogram_ref as j_histogram_ref
from repro_torch.kernels import histogram as hist
from repro_torch.kernels import ops, ref

SWEEP = [
    (64, 3, 8, 1, 2),        # tiny
    (300, 11, 16, 6, 3),     # ragged
    (512, 8, 32, 12, 2),     # exact tile boundaries
    (1030, 17, 64, 32, 5),   # multi-chunk, multi-tile
]


def _inputs(n, f, b, lv, c, integer):
    rng = np.random.default_rng(n + f)
    xb = rng.integers(0, b, (n, f)).astype(np.uint8)
    seg = rng.integers(-1, lv, (n,)).astype(np.int32)
    if integer:   # bootstrap weight x one-hot, as classification fits see
        stats = (rng.integers(0, 4, (n, 1))
                 * (rng.integers(0, c, (n, 1)) == np.arange(c))
                 ).astype(np.float32)
    else:
        stats = rng.normal(size=(n, c)).astype(np.float32)
    return xb, seg, stats


def _port(impl, xb, seg, stats, lv, b):
    args = (torch.as_tensor(xb), torch.as_tensor(seg), torch.as_tensor(stats))
    if impl == "wrapper":
        out = hist.histogram_cuda(*args, lv, b)
    else:
        out = ops.histogram(*args, lv, b, impl=impl)
    assert out.dtype == torch.float32 and out.shape == (lv, xb.shape[1], b,
                                                        stats.shape[1])
    return out.numpy()


@pytest.mark.parametrize("impl", ["scatter", "ref", "auto", "cuda", "wrapper"])
@pytest.mark.parametrize("n,f,b,lv,c", SWEEP)
def test_histogram_matches_jax(impl, n, f, b, lv, c):
    xb, seg, stats = _inputs(n, f, b, lv, c, integer=False)
    jargs = (jnp.asarray(xb, jnp.int32), jnp.asarray(seg), jnp.asarray(stats))
    want_ref = np.asarray(j_histogram_ref(*jargs, lv, b))
    want_pallas = np.asarray(histogram_pallas(*jargs, lv, b, interpret=True))
    got = _port(impl, xb, seg, stats, lv, b)
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["scatter", "ref", "wrapper"])
@pytest.mark.parametrize("n,f,b,lv,c", SWEEP)
def test_histogram_integer_stats_exact(impl, n, f, b, lv, c):
    xb, seg, stats = _inputs(n, f, b, lv, c, integer=True)
    want = np.asarray(j_histogram_ref(jnp.asarray(xb, jnp.int32),
                                      jnp.asarray(seg), jnp.asarray(stats),
                                      lv, b))
    np.testing.assert_array_equal(_port(impl, xb, seg, stats, lv, b), want)


@pytest.mark.parametrize("impl", ["scatter", "ref", "wrapper"])
def test_negative_seg_drops_samples(impl):
    xb, seg, stats = _inputs(200, 4, 8, 3, 2, integer=True)
    kept = seg >= 0
    got = _port(impl, xb, seg, stats, 3, 8)
    want = _port(impl, xb[kept], seg[kept], stats[kept], 3, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum((0, 2))[0], stats[kept].sum(0))


def test_auto_resolves_by_device():
    assert ops.resolve_backend("auto", "cpu") == "scatter"
    assert ops.resolve_backend("auto", "cuda") == "cuda"
    assert ops.resolve_backend("ref", torch.device("cpu")) == "ref"
    assert ops.resolve_backend("cuda", "cuda:0") == "cuda"
    for plain in ("scatter", "ref"):      # never stands in for the kernel
        with pytest.raises(ValueError, match="plain CPU version"):
            ops.resolve_backend(plain, "cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.resolve_backend("pallas", "cpu")
    assert {"cuda", "ref", "scatter"} <= set(ops.available_backends())


def test_registry_extension_point():
    calls = []

    @ops.register_backend("test_double_scatter")
    def _double(xb, seg, stats, n_level, n_bins):
        calls.append(n_level)
        return 2 * ops.BACKENDS["scatter"](xb, seg, stats, n_level, n_bins)

    try:
        xb, seg, stats = _inputs(64, 3, 8, 2, 2, integer=True)
        got = _port("test_double_scatter", xb, seg, stats, 2, 8)
        np.testing.assert_array_equal(got, 2 * _port("scatter", xb, seg,
                                                     stats, 2, 8))
        assert calls == [2]
        with pytest.raises(ValueError, match="plain CPU version"):
            ops.resolve_backend("test_double_scatter", "cuda")
    finally:
        ops.BACKENDS.pop("test_double_scatter")


def test_wrapper_on_cpu_counts_no_launch():
    before = hist.histogram_cuda.launches
    xb, seg, stats = _inputs(64, 3, 8, 2, 2, integer=True)
    _port("wrapper", xb, seg, stats, 2, 8)
    assert hist.histogram_cuda.launches == before


def test_column_major_layout():
    xb = torch.as_tensor(np.random.default_rng(0).integers(0, 9, (7, 5)))
    cm = hist.column_major(xb)
    assert cm.dtype == torch.uint8 and cm.shape == (7, 5)
    assert cm.t().is_contiguous() and torch.equal(cm.long(), xb)
    assert hist.column_major(cm) is cm


@pytest.mark.parametrize("n_bins,c", [(32, 2), (64, 3), (256, 3), (256, 60)])
def test_launch_plan(n_bins, c):
    """The warp count depends on B*C alone (so the kernel's summation order
    does not depend on F or L); tiles cover every slot within the limit."""
    limit = 232448                         # an H100 block's opt-in maximum
    plans = {lv: hist.launch_plan(lv, n_bins, c, limit)
             for lv in (1, 7, 128, 256, 1024)}
    assert len({w for w, _ in plans.values()}) == 1
    for lv, (w, tile) in plans.items():
        assert 1 <= tile <= lv and w * tile * n_bins * c * 4 <= limit
        assert -(-lv // tile) * tile >= lv


def test_launch_plan_refuses_oversized_slot():
    with pytest.raises(ValueError, match="exceeds"):
        hist.launch_plan(4, 256, 300, 232448)

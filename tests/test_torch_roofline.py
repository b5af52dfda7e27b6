"""The port's roofline and op counter (``repro_torch/roofline.py``,
``repro_torch/op_analysis.py``) against the JAX package's
(``repro/roofline.py``, ``repro/hlo_analysis.py``), on the CPU.

``model_flops`` equals JAX's exactly for every config and kind; the
counter's FLOPs of a product are 2·M·N·K, a Python loop counts each trip
(JAX's ``test_scan_multiplies_trip_count``: XLA's own ``cost_analysis``
counts a loop body once); the two kernels are ``torch.library`` custom
ops with fake shape functions, counted by their own formulas, their CPU
route the plain version; the collective term divides each collective's
bus bytes by the slowest link its group crosses."""
import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import roofline as jroofline
from repro.configs import registry as jregistry
from repro_torch import op_analysis, roofline
from repro_torch.configs import registry
from repro_torch.kernels import attention, histogram, ref

import chip_smoke


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_model_flops_equal_jax(arch, kind):
    want = jroofline.model_flops(jregistry.get(arch), kind, 256, 4096)
    assert roofline.model_flops(registry.get(arch), kind, 256, 4096) == want


def test_single_matmul_flops():
    n = 128
    a = torch.randn(n, n)
    _, c = op_analysis.count(lambda: a @ a)
    assert c.flops == 2 * n ** 3
    assert c.flops_by_dtype == {"float32": 2 * n ** 3}
    assert c.bytes == 3 * n * n * 4


def test_python_loop_counts_every_trip():
    a = torch.randn(64, 64)

    def fn(x):
        for _ in range(12):
            x = torch.tanh(x @ a)
        return x
    _, c = op_analysis.count(fn, a)
    assert c.flops == 12 * 2 * 64 ** 3
    assert c.calls["aten::mm"] == 12


def test_composite_ops_count_as_their_parts_without_grad():
    """With autograd off, ``matmul`` and ``einsum`` reach the counter whole;
    it counts the products they are made of, as it does with grad on."""
    x, w = torch.randn(4, 3, 32), torch.randn(32, 16)
    counts = []
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            _, c = op_analysis.count(
                lambda: torch.einsum("bsd,de->bse", x, w) + x @ w)
        counts.append((c.flops, c.bytes))
    assert counts[0] == counts[1]
    assert counts[0][0] == 2 * 2 * 4 * 3 * 32 * 16


def test_fake_tensors_count_as_real_ones_and_the_peak_holds_the_args():
    """The same ops on fake tensors count the same FLOPs, bytes and peak
    live bytes as on real ones; the peak counts what is alive at once, the
    tracked arguments included."""
    def step(x, w):
        y = x @ w
        z = torch.relu(y)
        del y
        return (z * 2).sum()

    out = []
    for fake in (False, True):
        ctx = FakeTensorMode() if fake else torch.no_grad()
        with ctx:
            x, w = torch.zeros(256, 128), torch.zeros(128, 512)
            c = op_analysis.OpCounter()
            c.track(x, w)
            with c:
                step(x, w)
            out.append((c.flops, c.bytes, c.peak_bytes))
    assert out[0] == out[1]
    args = (256 * 128 + 128 * 512) * 4
    assert out[0][2] == args + 2 * 256 * 512 * 4 + 4     # y freed; z, 2z, sum


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48), (False, 40)])
@pytest.mark.parametrize("sq,sk", [(64, 64), (16, 80), (80, 80)])
def test_attention_work_counts_the_visible_pairs(causal, window, sq, sk):
    """``attention_work`` (closed form over query rows) equals the count of
    the masks' visible pairs; ``chip_smoke._attention_work`` is the same
    formula."""
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    kpos = torch.arange(sk)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        vis &= kpos <= qpos
    if window is not None:
        vis &= kpos > qpos - window
    b, h, d = 2, 3, 64
    want = (4 * b * h * d * int(vis.sum()), 2 * b * h * d * (2 * sq + 2 * sk))
    assert attention.attention_work(b, h, sq, sk, d, 2, causal,
                                    window) == want
    assert chip_smoke._attention_work(torch, b, h, sq, sk, d, torch.bfloat16,
                                      causal, window) == want


def test_kernels_are_custom_ops_with_fake_shapes_and_counted_work():
    """Both kernels dispatch as ``repro_torch::`` custom ops: a fake tensor
    gets its output's shape without a launch (no launch counted), a CPU
    tensor the plain version; the counter counts each by its formula."""
    assert hasattr(torch.ops.repro_torch, "flash_attention")
    assert hasattr(torch.ops.repro_torch, "histogram")
    q = torch.randn(2, 4, 32, 64)
    launches = attention.flash_attention.launches
    torch.testing.assert_close(attention.flash_attention(q, q, q),
                               ref.flash_attention_ref(q, q, q), rtol=0,
                               atol=0)
    xb = torch.randint(0, 16, (300, 5), dtype=torch.uint8)
    seg = torch.randint(-1, 4, (300,), dtype=torch.int32)
    st = torch.randn(300, 2)
    assert torch.equal(histogram.histogram_cuda(xb, seg, st, 4, 16),
                       ref.histogram_ref(xb, seg, st, 4, 16))
    with FakeTensorMode():
        fq = torch.empty(2, 4, 32, 64, dtype=torch.bfloat16)
        c = op_analysis.OpCounter()
        with c:
            o = attention.flash_attention(fq, fq, fq, causal=True)
            h = histogram.histogram_cuda(torch.empty(300, 5,
                                                     dtype=torch.uint8),
                                         torch.empty(300, dtype=torch.int32),
                                         torch.empty(300, 2), 4, 16)
    assert o.shape == fq.shape and o.dtype == torch.bfloat16
    assert h.shape == (4, 5, 16, 2) and h.dtype == torch.float32
    assert attention.flash_attention.launches == launches
    assert c.kernel_calls == {"repro_torch::flash_attention": 1,
                              "repro_torch::histogram": 1}
    f_attn = attention.attention_work(2, 4, 32, 32, 64, 2, True, None)[0]
    f_hist = histogram.histogram_work(300, 5, 2, 4, 16)[0]
    assert c.flops_by_dtype == {"bfloat16": f_attn, "float32": f_hist}


def test_link_rates_and_collective_term():
    """A group inside one node of eight talks over NVLink, one across
    nodes over the network; the term is each collective's ring bytes over
    its group's link."""
    assert roofline.link_rate(range(8)) == roofline.NVLINK_BYTES_PER_S
    assert roofline.link_rate(range(4, 12)) == roofline.NETWORK_BYTES_PER_S
    assert roofline.link_rate([3]) == 0.0
    tally = op_analysis.CollectiveTally()
    with FakeTensorMode():
        t = torch.empty(1024, dtype=torch.float32)
        op_analysis.FakeComm(range(8), 0, tally).all_reduce(t)
        op_analysis.FakeComm(range(0, 256, 16), 0, tally).all_gather(t)
    ar = 2 * 7 / 8 * 4096
    ag = 15 * 4096
    assert tally.kinds["all_reduce"]["bytes"] == ar
    assert tally.kinds["all_gather"]["bytes"] == ag
    assert math.isclose(tally.seconds, ar / roofline.NVLINK_BYTES_PER_S
                        + ag / roofline.NETWORK_BYTES_PER_S)


def test_roofline_terms_bottleneck_and_summary_keys():
    """Compute splits by dtype over each dtype's peak; the summary carries
    the JAX package's keys and the least time."""
    r = roofline.Roofline(flops=3e12, hbm_bytes=3.35e12, coll_bytes=0.0,
                          coll_detail={}, per_device_memory=81 * 2**30,
                          flops_by_dtype={"bfloat16": 2e12,
                                          "float32": 1e12})
    assert math.isclose(r.t_compute, 2e12 / 989e12 + 1e12 / 67e12)
    assert math.isclose(r.t_memory, 1.0)
    assert r.bottleneck == "memory" and r.least_s == r.t_memory
    assert not r.fits
    jr = jroofline.Roofline(flops=1.0, hbm_bytes=1.0, coll_bytes=1.0,
                            coll_detail={}, per_device_memory=1.0)
    want = set(jr.summary(model_flops_global=1.0, n_chips=1))
    got = r.summary(model_flops_global=1.0, n_chips=1)
    assert want <= set(got)
    assert np.isclose(got["useful_flop_frac"], 1.0 / 3e12)
    assert chip_smoke._rl() is roofline

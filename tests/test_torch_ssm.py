"""The port's recurrent blocks against the JAX package's, on the CPU.

``repro_torch.models.ssm`` — the chunked SSD scan, its one-token step, and
the Mamba2, mLSTM and sLSTM blocks — held against ``repro.models.ssm`` on
the same NumPy-seeded inputs and the same weights (the JAX package's
``init_params`` at ``reduced()`` width, carried over by
``convert.lm_params_from_numpy``), in float32.

Tolerances:
  * ``chunked_ssd`` against the float64 naive recurrence and against the
    JAX scan: rtol = atol = 2e-4 (tests/test_models_math.py's); the decode
    step against the scan's tail: 1e-4;
  * a block's y and every cache leaf: within 1e-4 of the leaf's largest
    magnitude (PyTorch's and XLA's CPU matrix products sum in different
    orders; ``F.softplus`` and ``jax.nn.softplus`` differ by under 1e-8
    relative above 20);
  * in bfloat16 the dtypes of y and of each cache leaf equal the JAX
    package's (the values round at other places: within 5e-2 of the leaf's
    largest magnitude).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import registry as jregistry
from repro.configs.base import reduced as jreduced
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import reduced
from repro_torch.models import ssm

LEAF_TOL = 1e-4
# block kind -> (config, pattern position of such a block in its unit)
KINDS = {"mamba2": ("zamba2-7b", 0), "mlstm": ("xlstm-350m", 0),
         "slstm": ("xlstm-350m", 1)}


def _naive_recurrence(a, xin, bk, cq, h0):
    """h_t = a_t h_{t-1} + xin_t ⊗ bk_t ; y_t = h_t · cq_t  (per head),
    in float64."""
    b, s, h, p = xin.shape
    hcur = np.array(h0, np.float64)
    ys = np.zeros((b, s, h, p))
    for t in range(s):
        hcur = (hcur * a[:, t, :, None, None]
                + np.einsum("bhp,bhn->bhpn", xin[:, t], bk[:, t]))
        ys[:, t] = np.einsum("bhpn,bhn->bhp", hcur, cq[:, t])
    return ys, hcur


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _ssd_inputs(rng, b, s, h, p, n, lo=0.6):
    return (rng.uniform(lo, 1.0, (b, s, h)), rng.normal(size=(b, s, h, p)),
            rng.normal(size=(b, s, h, n)), rng.normal(size=(b, s, h, n)),
            rng.normal(size=(b, h, p, n)))


# ---------------------------------------------------------------- SSD math
@pytest.mark.parametrize("s,chunk", [(16, 4), (17, 4), (32, 32), (7, 16)])
def test_chunked_ssd_matches_naive_and_jax(s, chunk):
    rng = np.random.default_rng(s)
    arrays = _ssd_inputs(rng, 2, s, 3, 4, 5)
    want_y, want_h = _naive_recurrence(*arrays)
    got_y, got_h = ssm.chunked_ssd(*map(_t, arrays), chunk)
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    assert got_y.shape == (2, s, 3, 4) and got_h.shape == (2, 3, 4, 5)
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_h.numpy(), want_h, rtol=2e-4, atol=2e-4)
    jy, jh = jssm.chunked_ssd(*(jnp.asarray(a, jnp.float32) for a in arrays),
                              chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(jh), rtol=2e-4,
                               atol=2e-4)


def test_ssd_decode_step_matches_scan_tail():
    """S - 1 chunked steps then one decode step equal the scan over S, in
    the port and against the JAX package's decode step."""
    rng = np.random.default_rng(0)
    a, xin, bk, cq, _ = map(_t, _ssd_inputs(rng, 1, 9, 2, 3, 4, lo=0.5))
    h0 = torch.zeros((1, 2, 3, 4))
    y_all, h_all = ssm.chunked_ssd(a, xin, bk, cq, h0, chunk=4)
    _, h_pre = ssm.chunked_ssd(a[:, :-1], xin[:, :-1], bk[:, :-1],
                               cq[:, :-1], h0, chunk=4)
    last = (a[:, -1:], xin[:, -1:], bk[:, -1:], cq[:, -1:])
    y_last, h_last = ssm.ssd_decode_step(*last, h_pre)
    np.testing.assert_allclose(y_last[:, 0].numpy(), y_all[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_last.numpy(), h_all.numpy(), rtol=1e-4,
                               atol=1e-4)
    jy, jh = jssm.ssd_decode_step(*(jnp.asarray(t.numpy()) for t in last),
                                  jnp.asarray(h_pre.numpy()))
    np.testing.assert_allclose(y_last.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


def test_chunked_ssd_keeps_dtypes_and_broadcast_keys():
    """bf16 inputs: y comes back bf16, the state float32 (the JAX
    package's casts); B and C given as an ``expand`` view over the heads
    (Mamba2's n_groups 1) equal the same values materialized."""
    rng = np.random.default_rng(3)
    a, xin, bk, cq, h0 = map(_t, _ssd_inputs(rng, 2, 12, 3, 4, 5))
    y, h = ssm.chunked_ssd(a, xin.bfloat16(), bk, cq, h0, 8)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    shared = bk[:, :, :1].expand(2, 12, 3, 5)
    got = ssm.chunked_ssd(a, xin, shared, shared, h0, 8)
    want = ssm.chunked_ssd(a, xin, shared.contiguous(), shared.contiguous(),
                           h0, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_chunked_ssd_gradient_finite_where_jax_overflows():
    """A chunk whose summed log-decay passes -88 (here 128 steps of decays
    in [0.3, 0.6]; mLSTM's forget gates at xlstm-350m's chunk of 256): the
    JAX package's gradient is NaN (its mask multiplies exp(cs_l - cs_m) =
    inf above the diagonal by a zero cotangent), the port's is finite and
    equals the float64 naive recurrence's, and the outputs agree."""
    rng = np.random.default_rng(8)
    b, s, h, p, n = 1, 128, 2, 3, 4
    arrays = list(_ssd_inputs(rng, b, s, h, p, n))
    arrays[0] = rng.uniform(0.3, 0.6, (b, s, h))
    wy, wh = rng.normal(size=(b, s, h, p)), rng.normal(size=(b, h, p, n))

    def objective(y, hf, lib):
        return (y * lib.asarray(wy, y.dtype)).sum() + \
            (hf * lib.asarray(wh, hf.dtype)).sum()
    jgrad = jax.grad(lambda *xs: objective(*jssm.chunked_ssd(*xs, s), jnp),
                     argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a, jnp.float32) for a in arrays))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jgrad)

    def naive(a, xin, bk, cq, h0):            # float64, differentiable
        hcur, ys = h0, []
        for t in range(s):
            hcur = (hcur * a[:, t, :, None, None]
                    + xin[:, t, :, :, None] * bk[:, t, :, None, :])
            ys.append((hcur @ cq[:, t, :, :, None])[..., 0])
        return torch.stack(ys, 1), hcur
    grads = {}
    for dt in (torch.float32, torch.float64):
        xs = [torch.tensor(a, dtype=dt, requires_grad=True) for a in arrays]
        y, hf = (ssm.chunked_ssd(*xs, s) if dt == torch.float32
                 else naive(*xs))
        loss = (y * torch.tensor(wy, dtype=dt)).sum() + \
            (hf * torch.tensor(wh, dtype=dt)).sum()
        grads[dt] = torch.autograd.grad(loss, xs)
        if dt == torch.float32:
            jy, jh = jssm.chunked_ssd(*(jnp.asarray(a, jnp.float32)
                                        for a in arrays), s)
            np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                       rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(hf.detach().numpy(), np.asarray(jh),
                                       rtol=2e-4, atol=2e-4)
    for got, want in zip(grads[torch.float32], grads[torch.float64]):
        assert torch.isfinite(got).all()
        err = float((got.double() - want).abs().max())
        assert err <= 2e-4 * float(want.abs().max()), err


@given(st.integers(1, 40), st.integers(1, 6))
@settings(max_examples=10, deadline=None)
def test_ssd_state_decay_bound(s, chunk):
    """With decays in [0, 1] and bounded inputs the output is finite and
    the state stays within s·sqrt(P·N) (tests/test_models_math.py's
    property, on the port)."""
    rng = np.random.default_rng(s * 7 + chunk)
    b, h, p, n = 1, 2, 3, 3
    a = _t(rng.uniform(0.0, 1.0, (b, s, h)))
    xin, bk, cq = (_t(rng.uniform(-1, 1, (b, s, h, m))) for m in (p, n, n))
    y, hf = ssm.chunked_ssd(a, xin, bk, cq, torch.zeros((b, h, p, n)), chunk)
    assert torch.isfinite(y).all()
    assert float(hf.abs().max()) <= s * np.sqrt(p * n) + 1e-3


# ------------------------------------------------------------------ blocks
def _block_pair(kind, dtype="float32"):
    """(JAX config, port config, the JAX block's weights, the port's block
    core holding the same weights)."""
    arch, j = KINDS[kind]
    cfg_j = jreduced(jregistry.get(arch)).with_(dtype=dtype)
    cfg = reduced(registry.get(arch)).with_(dtype=dtype)
    params = jtransformer.init_params(jax.random.key(5), cfg_j)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, "cpu")
    jp = jax.tree.map(lambda a: a[0], params["units"][f"blk{j}"]["core"])
    return cfg_j, cfg, jp, model.blocks[j].core


def _jax_block(kind):
    return {"mamba2": jssm.mamba2_block, "mlstm": jssm.mlstm_block,
            "slstm": jssm.slstm_block}[kind]


def _assert_close(got: dict, want: dict, tol: float, what: str):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        g = got[k]
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        assert tuple(g.shape) == w.shape, f"{what} {k}"
        err = float(np.abs(g.float().numpy() - w).max())
        bound = tol * float(np.abs(w).max()) + 1e-12
        assert err <= bound, f"{what} {k}: {err:.3g} > {bound:.3g}"


def _torch_cache(c: dict) -> dict:
    """A JAX block's cache as the port's (dtypes kept, bf16 bit for bit)."""
    return {k: convert._tensor(np.asarray(v), "cpu") for k, v in c.items()}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("case", ["no cache, S=40", "cache, S=1",
                                  "cache, S=24"])
def test_block_matches_jax(kind, case):
    """y and every cache leaf of the port's block against the JAX block's:
    without a cache over 40 tokens (chunk 32: a ragged second chunk), and
    from the JAX block's cache after 20 tokens, one token (the decode
    step) or 24 more (the chunked scan from that state)."""
    cfg_j, cfg, jp, core = _block_pair(kind)
    rng = np.random.default_rng(len(case) + len(kind))
    fn_j, fn = _jax_block(kind), ssm.BLOCKS[kind]
    if case.startswith("no cache"):
        x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
        yj, cj = fn_j(jp, jnp.asarray(x), cfg_j)
        y, c = fn(core, torch.from_numpy(x), cfg)
    else:
        x0 = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
        _, cache_j = fn_j(jp, jnp.asarray(x0), cfg_j)
        _, cache = fn(core, torch.from_numpy(x0), cfg)
        _assert_close(cache, cache_j, LEAF_TOL, f"{kind} prefill cache")
        s = int(case.split("=")[1])
        x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
        yj, cj = fn_j(jp, jnp.asarray(x), cfg_j, cache=cache_j)
        y, c = fn(core, torch.from_numpy(x), cfg, cache=_torch_cache(cache_j))
    assert y.shape == x.shape and y.dtype == torch.float32
    _assert_close({"y": y}, {"y": yj}, LEAF_TOL, f"{kind} {case}")
    _assert_close(c, cj, LEAF_TOL, f"{kind} {case} cache")


@pytest.mark.parametrize("kind", list(KINDS))
def test_block_bf16_dtypes_match_jax(kind):
    """In bfloat16 the port keeps the JAX package's dtypes: y in bf16, the
    recurrent states float32, Mamba2's conv state bf16; from the prefill
    cache, one decode step too."""
    cfg_j, cfg, jp, core = _block_pair(kind, "bfloat16")
    x = np.random.default_rng(9).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    fn_j, fn = _jax_block(kind), ssm.BLOCKS[kind]
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    yj, cj = fn_j(jp, xj, cfg_j)
    y, c = fn(core, xt, cfg)
    yj1, cj1 = fn_j(jp, xj[:, :1], cfg_j, cache=cj)
    y1, c1 = fn(core, xt[:, :1], cfg, cache=_torch_cache(cj))
    for got, want in ((y, yj), (y1, yj1)):
        assert str(got.dtype)[6:] == str(want.dtype)
    for got, want in ((c, cj), (c1, cj1)):
        assert {k: str(v.dtype)[6:] for k, v in got.items()} == \
            {k: str(v.dtype) for k, v in want.items()}
    _assert_close({"y": y, **c}, {"y": yj, **cj}, 5e-2, f"{kind} bf16")


def test_make_cache_layouts_match_jax():
    """An empty decode cache of each SSM kind: the JAX package's shapes
    and dtypes, zeros."""
    for kind in KINDS:
        arch, _ = KINDS[kind]
        cfg_j = jreduced(jregistry.get(arch)).with_(dtype="bfloat16")
        cfg = reduced(registry.get(arch)).with_(dtype="bfloat16")
        want = {"mamba2": jssm.init_mamba2_cache, "mlstm":
                jssm.init_mlstm_cache, "slstm": jssm.init_slstm_cache}[kind](
            cfg_j, 3)
        got = ssm.CACHES[kind](cfg, 3, "cpu")
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in
                got.items()} == {k: (v.shape, str(v.dtype)) for k, v in
                                 want.items()}
        assert all(not v.any() for v in got.values())

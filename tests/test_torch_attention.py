"""The port's flash attention against the JAX package's, on the CPU.

On a CPU tensor :func:`repro_torch.kernels.attention.flash_attention` is its
kernel's plain version, so this holds the port's semantics (bottom-right
alignment, causal and window masks, zero rows) against the JAX Pallas kernel
in interpret mode and against ``flash_attention_ref``, on the same
NumPy-seeded inputs and the sweep of tests/test_kernels.py.  Tolerances are
that sweep's: float32 2e-3, bfloat16 3e-2.  The CUDA kernel itself is held
against this plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import ref
from repro_torch.kernels.attention import (LIBRARY, attention_plan,
                                         flash_attention)

TOL = {"float32": 2e-3, "bfloat16": 3e-2}


def _inputs(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32))


def _compare(arrays, dtype, **kw):
    """The port's output (float32 NumPy) and the JAX kernel's and oracle's,
    all from the same arrays rounded to ``dtype`` the same way."""
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tdt and got.shape == tq.shape
    got = got.float().numpy()
    want_kernel = np.asarray(jax_flash(jq, jk, jv, interpret=True, **kw)
                             .astype(jnp.float32))
    want_ref = np.asarray(jax_ref(jq, jk, jv, **kw).astype(jnp.float32))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want_kernel, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("sq,sk,d", [(128, 128, 64), (256, 256, 64),
                                     (128, 384, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(sq, sk, d, causal):
    _compare(_inputs(sq + d, 1, 2, sq, sk, d), "float32", causal=causal)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_window_and_dtype(dtype):
    _compare(_inputs(3, 2, 2, 256, 256, 64), dtype, causal=True, window=128)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_window_16(causal):
    _compare(_inputs(16, 1, 2, 96, 160, 64), "float32", causal=causal,
             window=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal", [(128, 128, True), (200, 72, True),
                                          (96, 160, False)])
def test_flash_attention_head_dim_112_matches_jax(sq, sk, causal, dtype):
    """D = 112, zamba2-7b's shared-attention head (3584 / 32): the port
    against the JAX kernel in interpret mode, which takes any D."""
    _compare(_inputs(sq + sk + 112, 2, 2, sq, sk, 112), dtype, causal=causal)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(300, 300), (52, 300)])
def test_ragged_noncausal_matches_jax(sq, sk, dtype):
    """Non-causal attention over a key count that is no multiple of the
    128-row tile, as whisper's encoder (Sq = Sk) and its cross-attention
    (Sq < Sk) run it: the port against the JAX kernel in interpret mode,
    every row seeing every key."""
    _compare(_inputs(sq + sk, 2, 2, sq, sk, 64), dtype, causal=False)


def test_ragged_causal_rows_without_keys_are_zero():
    """Sq = 200 > Sk = 72: query rows with qpos = i - 128 < 0 see no key
    and are exactly 0 in every implementation, not NaN."""
    got = _compare(_inputs(200, 1, 2, 200, 72, 64), "float32", causal=True)
    assert np.all(got[:, :, :128] == 0)
    assert np.all(np.abs(got[:, :, 128:]).sum(-1) > 0)


def test_scale_argument():
    arrays = _inputs(7, 1, 2, 64, 64, 64)
    _compare(arrays, "float32", causal=True, scale=0.3)


def test_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor gets ref.flash_attention_ref bit for bit and never
    counts as a kernel launch."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 64, 80, 64))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=32)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=True,
                                                    window=32))
    assert flash_attention.launches == before


SMEM_PER_BLOCK = 232448   # the H100's opt-in shared memory per block


@pytest.mark.parametrize("sq,sk", [(1, 1), (200, 72), (513, 513),
                                   (1000, 1000), (96, 160), (2048, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 112, 128])
def test_attention_plan(d, dtype, sq, sk):
    """The launch plan that the wrapper hands the kernel: shared memory a
    block may have, query tiles that cover every row once, wgmma's shapes
    on the bf16 route, and the float32 route's tiles as they were."""
    plan = attention_plan(d, getattr(torch, dtype), sq, sk, 3)
    assert plan.smem <= SMEM_PER_BLOCK
    tiles = plan.q_tiles
    assert (tiles - 1) * plan.block_q < sq <= tiles * plan.block_q
    # each block's (batch-head, query tile) as the route's kernel reads it
    if dtype == "bfloat16":     # one dimension, query tile fastest
        assert plan.grid == (3 * tiles, 1)
        blocks = [(x // tiles, x % tiles) for x in range(plan.grid[0])]
    else:                       # (batch-head, query tile)
        assert plan.grid == (3, tiles)
        blocks = [(x, y) for x in range(3) for y in range(tiles)]
    rows = sorted((bh, r) for bh, t in blocks for r in
                  range(t * plan.block_q, min((t + 1) * plan.block_q, sq)))
    assert rows == [(bh, r) for bh in range(3) for r in range(sq)]  # once
    # the kernel is compiled with the plan's tiles
    route = "TC" if dtype == "bfloat16" else "F32"
    for key, val in (("BQ", plan.block_q), ("BK", plan.block_k),
                     ("THREADS", plan.threads)):
        assert f"-DFF_{route}_{key}={val}" in LIBRARY.defines
    if dtype == "bfloat16":
        assert plan.route == "bf16 tensor cores"
        assert plan.block_q % 64 == 0 and plan.block_k % 16 == 0
        assert plan.threads == 128 * (plan.block_q // 64) + 32  # + producer
        assert plan.stages >= 2
        # Q and the K/V ring in bf16 fit with the 1024-byte alignment slack
        assert plan.smem >= 1024 + 2 * d * (plan.block_q
                                            + 2 * plan.stages * plan.block_k)
    else:
        assert plan.route == "f32 cuda cores"
        assert (plan.block_q, plan.block_k, plan.threads) == (64, 64, 256)
        assert plan.smem == {64: 52224, 112: 87040, 128: 87040}[d]
    # D = 112 is staged and multiplied as 128: the same launch
    if d == 112:
        assert plan == attention_plan(128, getattr(torch, dtype), sq, sk, 3)


@pytest.mark.parametrize("bad", [dict(d=96), dict(d=80), dict(d=120),
                                 dict(dtype=torch.float16),
                                 dict(sq=0), dict(sk=0)])
def test_attention_plan_refuses(bad):
    args = dict(d=64, dtype=torch.bfloat16, sq=8, sk=8) | bad
    with pytest.raises(ValueError, match="attention_plan"):
        attention_plan(**args)

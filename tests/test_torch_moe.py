"""The port's MoE family against the JAX package, on the CPU.

``layers.moe`` (capacity-based top-k routing with sort-based grouping) on
the same weights and inputs as the JAX package's, with ``pad_experts`` on
and off and with a capacity that drops assignments; its slot table against
a plain loop; ``_top_k``'s tie order against ``jax.lax.top_k``; the JAX
package's ``test_moe_routing_conservation``; and the two MoE configs'
prefill, decode and serving against the JAX package, with decode equal to
``forward_train`` (the reduced capacity drops nothing).

Tolerances: y within 1e-5 of its largest magnitude (the combine is an
``index_add_``, JAX's a scatter-add: each token's gated outputs are summed
in an order of each framework's own; measured up to 3e-7), aux rtol 1e-6,
logits and caches 1e-4 (as tests/test_torch_lm.py), the conservation check
JAX's own 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import reduced
from repro_torch.data import lm
from repro_torch.launch import serve
from repro_torch.models import layers, transformer

MOE_ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"]
Y_TOL = 1e-5
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Small ops: two threads each keep this module's share of a busy
    host's cores (the suite runs in several workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _configs(arch, **kw):
    return (jreduced(jregistry.get(arch)).with_(**kw),
            reduced(registry.get(arch)).with_(**kw))


def _port_moe(params: dict, cfg) -> layers.MoE:
    """A port MoE module holding the JAX package's ``init_moe`` weights."""
    mod = layers.MoE(cfg, "cpu")
    flat = {k: v for k, v in params.items() if k != "shared"}
    flat.update({f"shared.{k}": v for k, v in params.get("shared", {}).items()})
    assert set(flat) == {n for n, _ in mod.named_parameters()}
    with torch.no_grad():
        for name, p in mod.named_parameters():
            p.copy_(torch.from_numpy(np.array(flat[name])))
    return mod


@pytest.mark.parametrize("capacity", [8.0, 0.5])
@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_jax(arch, pad, capacity):
    """y and aux on the same weights and tokens, dead padded experts or
    none, with the reduced configs' no-drop capacity and one that drops
    assignments."""
    cfg_j, cfg = _configs(arch, pad_experts=pad, moe_capacity=capacity)
    params = jax.tree.map(np.asarray,
                          jlayers.init_moe(jax.random.key(7), cfg_j))
    assert params["we_gate"].shape[0] == (16 if pad else cfg.n_experts)
    mod = _port_moe(params, cfg)
    x = np.random.default_rng(3).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    want_y, want_aux = jlayers.moe(params, jnp.asarray(x), cfg_j)
    with torch.no_grad():
        y, aux = layers.moe(mod, torch.from_numpy(x), cfg)
    want_y = np.asarray(want_y)
    err = float(np.abs(y.numpy() - want_y).max())
    assert err <= Y_TOL * float(np.abs(want_y).max())
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


def _slots_by_loop(idx: np.ndarray, e_pad: int, cap: int) -> np.ndarray:
    """The slot table the routing means: expert e's r-th assignment in
    (token, k) order fills slot (e, r) while r < cap; empty slots hold
    t·k."""
    tk = idx.size
    slots = np.full((e_pad, cap), tk, np.int64)
    fill = np.zeros(e_pad, np.int64)
    for j, e in enumerate(idx.reshape(-1)):
        if fill[e] < cap:
            slots[e, fill[e]] = j
        fill[e] += 1
    return slots


@pytest.mark.parametrize("cap", [1, 3, 40])
def test_moe_slot_table_equals_a_loop(cap):
    rng = np.random.default_rng(cap)
    idx = np.stack([rng.permutation(6)[:2] for _ in range(20)])   # (t, k)
    got = layers.moe_slots(torch.from_numpy(idx), 6, 16, cap)
    assert np.array_equal(got.numpy(), _slots_by_loop(idx, 16, cap))


def test_top_k_ties_go_to_the_lower_index_as_in_jax():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    vals, idx = layers._top_k(torch.from_numpy(probs), 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 2)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))
    assert idx.tolist() == [[0, 1], [1, 3], [0, 2]]


def test_moe_routing_conservation():
    """tests/test_models_math.py's check in the port: with no-drop capacity
    each token's output is the gate-weighted sum of its top-k experts'
    outputs (plus the shared MLP); aux near 1 for a near-uniform router."""
    _, cfg = _configs("phi3.5-moe-42b-a6.6b")
    p = layers.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y, aux = layers.moe(p, x, cfg)
        assert y.shape == x.shape and torch.isfinite(y).all()
        assert float(aux) > 0.5
        t = 2 * 8
        xf = x.reshape(t, -1)
        probs = torch.softmax((xf @ p.router).float(), -1)
        gv, idx = torch.topk(probs, cfg.top_k)
        gv = gv / gv.sum(-1, keepdim=True)
        want = torch.zeros((t, cfg.d_model))
        for e in range(cfg.n_experts):
            g = torch.nn.functional.silu((xf @ p.we_gate[e]).float())
            ye = (g * (xf @ p.we_up[e]).float()) @ p.we_down[e]
            for kk in range(cfg.top_k):
                sel = idx[:, kk] == e
                want[sel] += gv[sel, kk, None] * ye[sel]
        if cfg.n_shared_experts:
            want += layers.mlp(p.shared, xf[None])[0]
    np.testing.assert_allclose(y.reshape(t, -1).numpy(), want.numpy(),
                               rtol=2e-3, atol=2e-3)


def _models(arch, seed=0, **kw):
    cfg_j, cfg = _configs(arch, **kw)
    params = jtransformer.init_params(jax.random.key(seed), cfg_j)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, "cpu")
    return cfg_j, params, cfg, model


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_jax(arch):
    cfg_j, params, cfg, model = _models(arch)
    rng = np.random.default_rng(11)
    s, cache_len = 20, 24
    toks = rng.integers(0, cfg.vocab, (2, s))
    lj, cj = jtransformer.prefill(params, jnp.asarray(toks), cfg_j, {},
                                  cache_len=cache_len)
    lt, ct = model.prefill(torch.from_numpy(toks), cache_len=cache_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for i in range(cfg.n_layers):
        want = cj["units"]["blk0"]["self"]
        np.testing.assert_allclose(ct[i]["k"].numpy(),
                                   np.asarray(want["k"][i]), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        np.testing.assert_allclose(ct[i]["v"].numpy(),
                                   np.asarray(want["v"][i]), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
    for t in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1))
        lj, cj = jtransformer.decode_step(params, cj, jnp.asarray(tok),
                                          jnp.int32(s + t), cfg_j)
        lt, ct = model.decode_step(ct, torch.from_numpy(tok), s + t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_equals_forward_train(arch):
    """tests/test_archs_smoke.py::test_decode_consistency_with_forward in
    the port, at the port's own tolerance: prefill(S) + decode(S) gives
    forward_train's logits at position S (no assignment is dropped at the
    reduced capacity, in either)."""
    _, _, cfg, model = _models(arch, seed=3)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 13)))
    _, cache = model.prefill(toks[:, :12], cache_len=20)
    dec, _ = model.decode_step(cache, toks[:, 12:], 12)
    with torch.no_grad():
        full, _ = model.forward_train(toks)
    np.testing.assert_allclose(dec[0].numpy(), full[0, -1].numpy(),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _smallest_top2_gap(model, prompts, max_new, cache_len) -> float:
    """The smallest top-2 logit gap over the greedy decode of ``prompts``:
    token equality is only well posed where no step is a near-tie."""
    logits, cache = model.prefill(torch.from_numpy(prompts),
                                  cache_len=cache_len)
    gaps = []
    for i in range(max_new):
        top = logits.topk(2, dim=-1).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))
        tok = logits.argmax(-1)[:, None]
        logits, cache = model.decode_step(cache, tok, prompts.shape[1] + i)
    return min(gaps)


def test_moe_serve_batch_tokens_equal_jax():
    cfg_j, params, cfg, model = _models("qwen2-moe-a2.7b")
    prompts = lm._markov_tokens(np.random.default_rng(7), cfg.vocab, (2, 16))
    assert _smallest_top2_gap(model, prompts, 6, 22) > 100 * LOGIT_TOL
    got, stats = serve.serve_batch(cfg, model, prompts, 6, 22)
    want, _ = jserve.serve_batch(cfg_j, params, prompts, 6, 22)
    assert np.array_equal(got, want) and stats["logits_finite"]

"""The port's dense-LM serving path against the JAX package, on the CPU.

Configurations, data, layers, prefill (logits and ring cache), decode and
the serving driver of ``repro_torch`` are held against their counterparts
in ``repro`` on the same weights (carried over by
``convert.lm_params_from_numpy``) and the same NumPy-seeded inputs, at the
reduced sizes in float32.  Prefill attention runs through the flash
kernel's wrapper, which on a CPU tensor is its plain version.

Tolerances: layer functions 1e-5; logits and caches 1e-4, because PyTorch's
and XLA's CPU matrix products sum in different orders (the differences seen
are a few 1e-6 on logits of size ~4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import reduced as jreduced
from repro.data import lm as jlm
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import reduced
from repro_torch.data import lm
from repro_torch.launch import serve
from repro_torch.models import layers, transformer
from repro_torch.serve import step

LOGIT_TOL = 1e-4
LAYER_TOL = 1e-5
DERIVED = ("head_dim", "d_inner", "n_ssm_heads", "ssm_head_dim", "n_units",
           "tail_blocks", "has_attention", "is_subquadratic")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(name, **kw):
    """The (JAX, port) pair of ``reduced(name)`` with ``kw`` replaced."""
    return (jreduced(jregistry.get(name)).with_(**kw),
            reduced(registry.get(name)).with_(**kw))


def _models(name, **kw):
    cfg_j, cfg = _configs(name, **kw)
    params = jtransformer.init_params(jax.random.key(0), cfg_j)
    return cfg_j, params, cfg, convert.lm_params_from_numpy(_np(params), cfg,
                                                            "cpu")


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_arch_config_equals_jax(arch):
    want, got = jregistry.get(arch), registry.get(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    for name in DERIVED:
        assert getattr(got, name) == getattr(want, name), name
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert (dataclasses.asdict(reduced(got))
            == dataclasses.asdict(jreduced(want)))
    assert reduced(got).param_count() == jreduced(want).param_count()


# -------------------------------------------------------------------- data
def test_markov_tokens_bit_equal():
    a = lm._markov_tokens(np.random.default_rng(4), 92544, (3, 257))
    b = jlm._markov_tokens(np.random.default_rng(4), 92544, (3, 257))
    assert a.dtype == b.dtype and np.array_equal(a, b)
    cfg_j, cfg = _configs("internlm2-1.8b")
    mine = lm.synthetic_lm_batches(cfg, 2, 33, seed=5, device="cpu")
    theirs = jlm.synthetic_lm_batches(cfg_j, 2, 33, seed=5)
    for _ in range(2):
        assert np.array_equal(next(mine)["tokens"].numpy(),
                              np.asarray(next(theirs)["tokens"]))


# ------------------------------------------------------------------ layers
def test_rmsnorm_mlp_and_positions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 256)).astype(np.float32)
    scale = rng.normal(size=(256,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=LAYER_TOL, atol=LAYER_TOL)

    cfg_j, cfg = _configs("internlm2-1.8b")
    p = _np(jlayers.init_mlp(jax.random.key(1), cfg_j))
    mod = layers.MLP(cfg, "cpu")
    for k, v in p.items():
        getattr(mod, k).data.copy_(torch.from_numpy(np.array(v)))
    np.testing.assert_allclose(
        layers.mlp(mod, torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.mlp(p, jnp.asarray(x))),
        rtol=LAYER_TOL, atol=LAYER_TOL)

    pos = np.arange(7) * 3
    np.testing.assert_allclose(
        layers.sinusoidal_positions(torch.from_numpy(pos), 64).numpy(),
        np.asarray(jlayers.sinusoidal_positions(jnp.asarray(pos), 64)),
        rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("sections", [None, (8, 12, 12)])
def test_apply_rope_matches_jax(sections):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 64)).astype(np.float32)
    shape = (2, 9) if sections is None else (3, 2, 9)
    pos = rng.integers(0, 5000, size=shape).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            sections)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LAYER_TOL, atol=LAYER_TOL)


def test_sdpa_chunked_matches_jax():
    """More query rows than one chunk, GQA, a window, empty slots and an
    offset query, as decode and the ring cache give them."""
    rng = np.random.default_rng(2)
    sq, sk = layers.ATTN_Q_CHUNK + 37, layers.ATTN_Q_CHUNK + 37
    q = rng.normal(size=(1, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, sk, 2, 16)).astype(np.float32)
    kpos = np.arange(sk, dtype=np.int32) + 5
    kpos[::7] = -1
    for mode_t, mode_j in ((layers.AttnMode("causal", 300),
                            jlayers.AttnMode("causal", 300)),
                           (layers.AttnMode("bidir"),
                            jlayers.AttnMode("bidir"))):
        got = layers._sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                                   mode_t, 5, torch.from_numpy(kpos))
        want = jlayers._sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                     mode_j, 5, jnp.asarray(kpos),
                                     pretranspose=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LAYER_TOL, atol=LAYER_TOL)


LEVERS = ["attn_probs_bf16", "attn_scores_bf16"]
# the levers round scores or probabilities to bf16 (8 bits of mantissa):
# the two frameworks round the same values, but their float32 sums feed
# the roundings in different orders, so one bf16 ulp (2^-8) can differ
LEVER_TOL = 2e-2
LEVER_LOSS_RTOL = 2e-3


@pytest.mark.parametrize("pretranspose", [True, False])
@pytest.mark.parametrize("lever", LEVERS)
def test_sdpa_chunked_bf16_levers_match_jax(lever, pretranspose):
    """Each lever against the JAX package's, its training
    (``pretranspose``) and decode formulations, with GQA, a window, empty
    slots and more query rows than one chunk; the lever moves the output
    off the float32 route's."""
    rng = np.random.default_rng(3)
    sq = sk = layers.ATTN_Q_CHUNK + 21
    q = rng.normal(size=(1, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, sk, 2, 16)).astype(np.float32)
    kpos = np.arange(sk, dtype=np.int32) + 3
    kpos[::5] = -1
    flags = dict(probs_bf16=lever == "attn_probs_bf16",
                 scores_bf16=lever == "attn_scores_bf16")
    args = (layers.AttnMode("causal", 300), 3, torch.from_numpy(kpos))
    got = layers._sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                               *args, **flags)
    plain = layers._sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                                 *args)
    want = jlayers._sdpa_chunked(*(jnp.asarray(a) for a in (q, k, v)),
                                 jlayers.AttnMode("causal", 300), 3,
                                 jnp.asarray(kpos), pretranspose=pretranspose,
                                 **flags)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LEVER_TOL, atol=LEVER_TOL)
    assert not torch.equal(got, plain)


@pytest.mark.parametrize("lever", LEVERS)
def test_bf16_lever_training_matches_jax(lever):
    """Loss within 2e-3 relative and every gradient leaf within 2e-2 of
    its largest magnitude, against the JAX package's ``lm_loss`` under the
    same lever (reduced qwen3-32b, qk_norm, float32 weights)."""
    cfg_j, params, cfg, model = _models("qwen3-32b", **{lever: True})
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 32))
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.lm_loss(p, {"tokens": jnp.asarray(toks)},
                                       cfg_j), has_aux=True))(params)
    model.requires_grad_()
    loss, _ = transformer.lm_loss(model, {"tokens": torch.from_numpy(toks)})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j),
                                                 rel=LEVER_LOSS_RTOL)
    got = convert.lm_params_to_numpy(
        model, {n: p.grad for n, p in model.named_parameters()})
    for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(grads_j),
                                 jax.tree_util.tree_leaves_with_path(got)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= LEVER_TOL * np.abs(w).max(), path
    plain = convert.lm_params_from_numpy(_np(params), cfg.with_(
        **{lever: False}), "cpu")
    with torch.no_grad():
        loss_plain, _ = transformer.lm_loss(
            plain, {"tokens": torch.from_numpy(toks)})
    assert float(loss_plain) != float(loss.detach())


@pytest.mark.parametrize("lever", LEVERS)
def test_bf16_lever_decode_matches_jax_and_prefill_ignores_it(lever):
    """Prefill through the flash kernel keeps no S x S tensor to cast: its
    logits and cache with the lever equal the port's without it, bit for
    bit.  Decode runs ``_sdpa_chunked`` under the lever: three teacher-
    forced steps' logits within 2e-2 of the JAX package's (whose prefill
    ran its plain attention under the lever too)."""
    cfg_j, params, cfg, model = _models("qwen3-32b", **{lever: True})
    plain = convert.lm_params_from_numpy(_np(params), cfg.with_(
        **{lever: False}), "cpu")
    rng = np.random.default_rng(12)
    s, cache_len = 20, 24
    toks = rng.integers(0, cfg.vocab, (2, s))
    lt, ct = model.prefill(torch.from_numpy(toks), cache_len=cache_len)
    lp, cp = plain.prefill(torch.from_numpy(toks), cache_len=cache_len)
    assert torch.equal(lt, lp)
    for a, b in zip(ct, cp):
        assert all(torch.equal(a[key], b[key]) for key in ("k", "v", "kpos"))
    _, cj = jtransformer.prefill(params, jnp.asarray(toks), cfg_j, {},
                                 cache_len=cache_len)
    moved = False
    for t in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1))
        lj, cj = jtransformer.decode_step(params, cj, jnp.asarray(tok),
                                          jnp.int32(s + t), cfg_j)
        lt, ct = model.decode_step(ct, torch.from_numpy(tok), s + t)
        lp, cp = plain.decode_step(cp, torch.from_numpy(tok), s + t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=LEVER_TOL, atol=LEVER_TOL)
        moved |= not torch.equal(lt, lp)
    assert moved


# ------------------------------------------------------ prefill and decode
def _jax_layer_cache(cache, i):
    c = cache["units"]["blk0"]["self"]
    return {k: np.asarray(c[k][i]) for k in ("k", "v", "kpos")}


@pytest.mark.parametrize("name,kw", [
    ("internlm2-1.8b", {}),
    ("internlm2-1.8b", {"d_head": 128}),
    ("qwen3-32b", {}),                       # qk_norm
    ("internlm2-1.8b", {"mrope_sections": (8, 12, 12)}),
])
def test_prefill_and_decode_match_jax(name, kw):
    cfg_j, params, cfg, model = _models(name, **kw)
    rng = np.random.default_rng(11)
    s, cache_len = 20, 24
    toks = rng.integers(0, cfg.vocab, (2, s))
    lj, cj = jtransformer.prefill(params, jnp.asarray(toks), cfg_j, {},
                                  cache_len=cache_len)
    lt, ct = model.prefill(torch.from_numpy(toks), cache_len=cache_len)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert len(ct) == cfg.n_layers
    for i in range(cfg.n_layers):
        want = _jax_layer_cache(cj, i)
        assert ct[i]["k"].shape == want["k"].shape
        np.testing.assert_allclose(ct[i]["k"].numpy(), want["k"],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(ct[i]["v"].numpy(), want["v"],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert np.array_equal(ct[i]["kpos"].numpy(), want["kpos"])
    # three teacher-forced decode steps
    for t in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1))
        lj, cj = jtransformer.decode_step(params, cj, jnp.asarray(tok),
                                          jnp.int32(s + t), cfg_j)
        lt, ct = model.decode_step(ct, torch.from_numpy(tok), s + t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        for i in range(cfg.n_layers):
            assert np.array_equal(ct[i]["kpos"].numpy(),
                                  _jax_layer_cache(cj, i)["kpos"])


def test_sliding_window_ring_eviction():
    """tests/test_models_math.py's case: with a window of 8, prefill 12 then
    decode 9 equals prefill 20 then decode 1, in the port and against the
    JAX package."""
    cfg_j, params, cfg, model = _models("glm4-9b", sliding_window=8)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (1, 21))
    _, cache = model.prefill(torch.from_numpy(toks[:, :12]))
    assert cache[0]["k"].shape[1] == 8
    _, jcache = jtransformer.prefill(params, jnp.asarray(toks[:, :12]), cfg_j,
                                     {})
    for i in range(12, 21):
        la, cache = model.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]),
                                      i)
        ja, jcache = jtransformer.decode_step(
            params, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i), cfg_j)
    _, cache_b = model.prefill(torch.from_numpy(toks[:, :20]))
    lb, _ = model.decode_step(cache_b, torch.from_numpy(toks[:, 20:21]), 20)
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(la.numpy(), np.asarray(ja), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert sorted(cache[0]["kpos"].tolist()) == list(range(13, 21))


def _greedy_gaps(model, prompts, max_new, cache_len):
    """The smallest top-2 logit gap over the greedy decode of ``prompts``."""
    logits, cache = model.prefill(torch.from_numpy(prompts),
                                  cache_len=cache_len)
    gaps = []
    for i in range(max_new):
        top = logits.topk(2, dim=-1).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))
        if i == max_new - 1:
            break
        tok = logits.argmax(-1)[:, None]
        logits, cache = model.decode_step(cache, tok, prompts.shape[1] + i)
    return min(gaps)


def test_serve_batch_tokens_equal_jax():
    cfg_j, params, cfg, model = _models("internlm2-1.8b")
    prompts = lm._markov_tokens(np.random.default_rng(7), cfg.vocab, (2, 16))
    max_new, cache_len = 6, 22
    # token equality is only well posed where no step is a near-tie
    assert _greedy_gaps(model, prompts, max_new, cache_len) > 100 * LOGIT_TOL
    got, stats = serve.serve_batch(cfg, model, prompts, max_new, cache_len)
    want, _ = jserve.serve_batch(cfg_j, params, prompts, max_new, cache_len)
    assert got.shape == (2, max_new) and np.array_equal(got, want)
    assert stats["logits_finite"] and stats["decode_tok_s"] > 0


def test_serve_steps_and_make_cache():
    cfg_j, _, cfg, model = _models("internlm2-1.8b")
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab,
                                                              (2, 8)))
    l1, c1 = step.make_prefill_step(cfg)(model, {"tokens": toks})
    l2, _ = model.prefill(toks)
    assert torch.equal(l1, l2)
    l3, _ = step.make_serve_step(cfg)(model, c1, toks[:, :1], 8)
    assert l3.shape == (2, cfg.vocab)
    empty = step.make_cache(cfg, 2, 12, device="cpu")
    want = jtransformer.make_cache(cfg_j, 2, 12)["units"]["blk0"]["self"]
    assert len(empty) == cfg.n_layers
    for c in empty:
        assert tuple(c["k"].shape) == want["k"].shape[1:]
        assert np.array_equal(c["kpos"].numpy(), np.asarray(want["kpos"][0]))
    # a decode from an empty cache sees only its own key, as in JAX
    params = jtransformer.init_params(jax.random.key(0), cfg_j)
    lj, _ = jtransformer.decode_step(params,
                                     jtransformer.make_cache(cfg_j, 2, 12),
                                     jnp.asarray(toks[:, :1].numpy()),
                                     jnp.int32(4), cfg_j)
    lt, _ = model.decode_step(empty, toks[:, :1], 4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_bf16_weights_carry_over_bit_for_bit():
    cfg_j, cfg = _configs("internlm2-1.8b", dtype="bfloat16")
    params = _np(jtransformer.init_params(jax.random.key(2), cfg_j))
    model = convert.lm_params_from_numpy(params, cfg, "cpu")
    assert model.lm_head.dtype == torch.bfloat16
    assert model.blocks[0].ln1.dtype == torch.float32
    want = params["units"]["blk0"]["attn"]["wq"][1].astype(np.float32)
    assert np.array_equal(model.blocks[1].attn.wq.float().numpy(), want)
    with pytest.raises(ValueError, match="does not match"):
        convert.lm_params_from_numpy(params, cfg.with_(dtype="float32"), "cpu")


def test_prefill_step_and_lm_loss_pass_extras_like_jax():
    """A decoder-only config with an extra key in its batch: the prefill
    step and ``lm_loss`` hand it on as the JAX package's do (which ignore
    it there), so both equal the JAX results instead of raising."""
    from repro.serve import step as jstep
    cfg_j, params, cfg, model = _models("internlm2-1.8b")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 16))
    frames = rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}
    lj, cj = jstep.make_prefill_step(cfg_j)(params, jb)
    lt, ct = step.make_prefill_step(cfg)(model, tb)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    want = convert.lm_cache_from_numpy(_np(cj), cfg, "cpu")
    for g, w in zip(ct, want):
        assert torch.equal(g["kpos"], w["kpos"])
        for k in ("k", "v"):
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
    loss_j, (ce_j, _) = jtransformer.lm_loss(params, jb, cfg_j)
    with torch.no_grad():
        loss_t, (ce_t, _) = transformer.lm_loss(model, tb)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    assert float(ce_t) == pytest.approx(float(ce_j), rel=1e-5)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen2-vl-2b"])
def test_unsupported_families_raise(arch):
    """The two families the port refused until it ported them (the
    encoder-decoder and the VLM) now build — ``check_supported`` accepts
    every config of the registry — and serve a wave on their stubs.  The
    remat policies that save chosen tensors are ported: ``"dots"`` trains
    them (encoder blocks and decoder units checkpointed under it) to
    ``"none"``'s loss, and an unknown remat raises ValueError, as for any
    config.  The bf16 attention levers are ported: at prefill (the flash
    kernel) they change nothing, the encoder's and cross-attention's
    included."""
    for name in registry.ARCH_IDS:
        transformer.check_supported(registry.get(name))
    cfg = reduced(registry.get(arch))
    model = transformer.init_params(cfg, seed=0, device="cpu")
    batch = next(lm.synthetic_lm_batches(cfg, 2, 12, seed=1, device="cpu"))
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    assert set(extras) == {"frames" if cfg.enc_layers else "patches"}
    toks, stats = serve.serve_batch(cfg, model, batch["tokens"].numpy(), 3,
                                    15, extras=extras)
    assert toks.shape == (2, 3) and stats["logits_finite"]
    with torch.no_grad():
        losses = [transformer.lm_loss(transformer.init_params(
            cfg.with_(remat=remat), seed=0, device="cpu"), batch)[0]
            for remat in ("none", "dots")]
    assert torch.equal(losses[0], losses[1])
    with pytest.raises(ValueError, match="unknown remat"):
        transformer.init_params(cfg.with_(remat="everything"), seed=0,
                                device="cpu").forward_train(
            batch["tokens"], extras)
    want, _ = model.prefill(batch["tokens"], extras=extras)
    got, _ = transformer.init_params(
        cfg.with_(attn_scores_bf16=True), seed=0, device="cpu").prefill(
            batch["tokens"], extras=extras)
    assert torch.equal(got, want)


def test_cross_attention_and_bf16_levers_raise():
    """Cross mode without the encoder states (``kv_src``) or a cache to
    read them from raises; the bf16 attention levers, ported, no longer
    raise: each runs at train (its output off the float32 route's) and
    leaves prefill as it was."""
    _, cfg = _configs("internlm2-1.8b")
    model = transformer.init_params(cfg, seed=0, device="cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    pos = torch.zeros((1, 4), dtype=torch.int32)
    attn = model.blocks[0].attn
    with pytest.raises(ValueError, match="kv_src"):
        layers.attention(attn, x, cfg, mode=layers.AttnMode("cross"),
                         positions=pos)
    y, cache = layers.attention(attn, x, cfg, mode=layers.AttnMode("cross"),
                                positions=pos, kv_src=torch.ones((1, 6,
                                                                  cfg.d_model)),
                                phase="prefill")
    assert y.shape == x.shape and cache["k"].shape[1] == 6
    x = torch.randn((1, 4, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    for phase in ("train", "prefill"):
        plain, _ = layers.attention(attn, x, cfg,
                                    mode=layers.AttnMode("causal"),
                                    positions=pos, phase=phase)
        for lever in LEVERS:
            y, _ = layers.attention(attn, x, cfg.with_(**{lever: True}),
                                    mode=layers.AttnMode("causal"),
                                    positions=pos, phase=phase)
            assert torch.equal(y, plain) == (phase == "prefill"), lever

"""The port's encoder-decoder (whisper-large-v3) against the JAX package's,
on the CPU.

whisper-large-v3 at ``reduced()`` size in float32: 2 encoder and 2 decoder
layers, 16 frames, 4 heads on 2 kv heads (so cross-attention groups its
heads too), sinusoidal positions.  The same weights (carried over by
``convert.lm_params_from_numpy``) and the same NumPy-seeded tokens and
frames (``synthetic_lm_batches``, bit-equal to the JAX package's) go
through the JAX package's ``forward_train``, ``lm_loss``,
``jax.value_and_grad``, jitted ``make_train_step``, ``prefill`` and
``decode_step``, and through the port's.  The JAX results are computed once
per module (the ``run`` fixture).  The JAX package's ``serve_batch`` cannot
serve whisper (its prefill gets ``{}``, no frames), so the port's greedy tokens
are held against the JAX ``prefill`` + ``decode_step`` loop.

The port's prefill runs the encoder's and the cross-attention's attention
through the flash wrapper (on a CPU tensor its plain version), the JAX
package its plain ``_sdpa_chunked``: the same function, held together here.

Tolerances are tests/test_torch_hybrid.py's: logits, caches and every
gradient leaf within 1e-4 of the leaf's largest magnitude; loss and CE
rtol 1e-5; parameters after a step within 1e-3·lr where the gradient is at
least 1e-2 of its leaf's largest, elsewhere by more than 0.1·lr only where
the reference gradient is itself within 1e-4 of its leaf's largest of
zero, and by at most 2·lr (Adam's first step g / (|g| + eps) turns
rounding in a near-zero gradient into up to a whole step).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import reduced as jreduced
from repro.data import lm as jlm
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import reduced
from repro_torch.data import lm
from repro_torch.launch import serve
from repro_torch.models import layers, transformer
from repro_torch.serve import step as serve_step
from repro_torch.train import adamw_init
from repro_torch.train.step import make_train_step

ARCH = "whisper-large-v3"
LR = 3e-3
LEAF_TOL = 1e-4
LOSS_RTOL = 1e-5


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _configs(**kw):
    return (jreduced(jregistry.get(ARCH)).with_(**kw),
            reduced(registry.get(ARCH)).with_(**kw))


def _batch(cfg, b=2, s=32, seed=0) -> dict:
    """The first ``synthetic_lm_batches`` batch: tokens, then frames."""
    return next(lm.synthetic_lm_batches(cfg, b, s, seed=seed, device="cpu"))


def _jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _extras(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k != "tokens"}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two threads each keep this module's share of a busy host's cores
    (the suite runs in several workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def run() -> dict:
    """The JAX package's results on one set of weights, once per module."""
    cfg_j, cfg = _configs()
    params = jtransformer.init_params(jax.random.key(0), cfg_j)
    batch = _jbatch(_batch(cfg))

    def loss_and_logits(p, b):
        loss, (ce, aux) = jtransformer.lm_loss(p, b, cfg_j)
        logits, _ = jtransformer.forward_train(p, b["tokens"], cfg_j,
                                               _extras(b))
        return loss, (ce, aux, logits)
    (loss, (ce, _, logits)), grads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(params, batch)
    p1, o1, m1 = jax.jit(jstep.make_train_step(cfg_j, lr=LR))(
        params, joptim.adamw_init(params), batch)

    # serving: prefill 20 tokens (cache 24), three teacher-forced decodes
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg_j.vocab, (2, 20))
    frames = (rng.normal(size=(2, cfg_j.enc_frames, cfg_j.d_model)) * 0.1
              ).astype(np.float32)
    forced = rng.integers(0, cfg_j.vocab, (3, 2, 1))
    lp, cache = jax.jit(lambda p, t, f: jtransformer.prefill(
        p, t, cfg_j, {"frames": f}, cache_len=24))(params, prompt, frames)
    step = jax.jit(lambda p, c, t, pos: jtransformer.decode_step(
        p, c, t, pos, cfg_j))
    caches, decoded = [jax.tree.map(np.asarray, cache)], []
    for t in range(3):
        ld, cache = step(params, cache, jnp.asarray(forced[t]),
                         jnp.int32(20 + t))
        decoded.append(np.asarray(ld))
        caches.append(jax.tree.map(np.asarray, cache))
    # greedy: the JAX prefill + decode loop on a Markov prompt and frames
    served = next(lm.synthetic_lm_batches(cfg, 2, 16, seed=7, device="cpu"))
    lg, cache = jax.jit(lambda p, t, f: jtransformer.prefill(
        p, t, cfg_j, {"frames": f}, cache_len=22))(
        params, served["tokens"].numpy(), served["frames"].numpy())
    tok = jnp.argmax(lg, -1)[:, None]
    greedy = [tok]
    for i in range(5):
        lg, cache = step(params, cache, tok, jnp.int32(16 + i))
        tok = jnp.argmax(lg, -1)[:, None]
        greedy.append(tok)
    return {"params": jax.tree.map(np.asarray, params),
            "logits": np.asarray(logits), "loss": float(loss),
            "ce": float(ce), "grads": _flat(grads),
            "step": {"params": _flat(p1), "mu": _flat(o1["mu"]),
                     "nu": _flat(o1["nu"]), "loss": float(m1["loss"]),
                     "ce": float(m1["ce"])},
            "prompt": prompt, "frames": frames, "forced": forced,
            "prefill": np.asarray(lp), "caches": caches, "decoded": decoded,
            "served": served,
            "greedy": np.asarray(jnp.concatenate(greedy, 1))}


def _port(run):
    _, cfg = _configs()
    return cfg, convert.lm_params_from_numpy(run["params"], cfg, "cpu")


def _grads(model, batch):
    model.requires_grad_()
    loss, (ce, aux) = transformer.lm_loss(model, batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), ce.detach(), dict(zip(names, grads))


def _assert_leaves_close(got: dict, want: dict, tol: float, what: str):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[k].float().numpy() if isinstance(got[k], torch.Tensor) \
            else got[k]
        assert g.shape == w.shape, f"{what} {k}"
        err = float(np.abs(g - w).max())
        bound = tol * float(np.abs(w).max()) + 1e-12
        assert err <= bound, f"{what} {k}: {err:.3g} > {bound:.3g}"


def _cache_leaves(cache: list) -> dict:
    """A cache list as flat leaves, keyed by layer and path."""
    out = {}
    for i, c in enumerate(cache):
        for part, d in c.items():
            for k, v in d.items():
                out[f"{i}.{part}.{k}"] = v
    return out


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_frames_bit_equal(dtype):
    """Tokens and frames of two batches equal the JAX package's bit for
    bit, in float32 and in bfloat16 (the JAX route rounds the float64 draw
    to float32, then to bfloat16)."""
    cfg_j, cfg = _configs(dtype=dtype)
    mine = lm.synthetic_lm_batches(cfg, 2, 9, seed=5, device="cpu")
    theirs = jlm.synthetic_lm_batches(cfg_j, 2, 9, seed=5)
    for _ in range(2):
        a, b = next(mine), next(theirs)
        assert a.keys() == b.keys() == {"tokens", "frames"}
        assert a["frames"].shape == (2, cfg.enc_frames, cfg.d_model)
        assert a["frames"].dtype == getattr(torch, dtype)
        for k in a:
            w = np.asarray(b[k])
            g = a[k].numpy() if dtype == "float32" or k == "tokens" \
                else a[k].view(torch.int16).numpy()
            if k != "tokens" and dtype == "bfloat16":
                w = w.view(np.int16)
            assert np.array_equal(g, w), k


def test_stub_rounds_as_jax_does():
    """Values a direct float64 -> bfloat16 rounding would round up but
    float64 -> float32 -> bfloat16 rounds to even: the port's stub takes
    JAX's route."""
    draws = np.array([1 + 2**-8 + 2**-40, -(1 + 2**-8 + 2**-40),
                      1 + 3 * 2**-8 + 2**-40, 1.0]) / 0.1

    class Fixed:
        def normal(self, size):
            return np.broadcast_to(draws, size)
    got = lm._stub(Fixed(), (4,), torch.bfloat16, "cpu")
    x = draws * 0.1
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)
    assert np.array_equal(got.view(torch.int16).numpy(), want)
    # above the halfway point 1 + 2^-8, yet rounded to even (1), not up
    assert x[0] > 1 + 2**-8 and float(got[0]) == 1.0


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("phase", ["train", "prefill", "decode"])
def test_cross_attention_matches_jax(phase):
    """Cross mode of ``layers.attention`` (q from x, k and v from the
    encoder states, 4 query heads on 2 kv heads, no mask): train and
    prefill project the states (prefill through the flash wrapper), decode
    reads them from the cache {k, v}; all equal the JAX package's."""
    cfg_j, cfg = _configs()
    p = jax.tree.map(np.asarray, jlayers.init_attention(jax.random.key(4),
                                                        cfg_j))
    mod = layers.Attention(cfg, "cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
    rng = np.random.default_rng(9)
    s = 1 if phase == "decode" else 7
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    src = rng.normal(size=(2, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    pos = np.zeros((2, s), np.int32)
    kw = dict(mode=jlayers.AttnMode("cross"), positions=jnp.asarray(pos))
    if phase == "decode":
        _, cache = jlayers.attention(p, jnp.asarray(x), cfg_j,
                                     kv_src=jnp.asarray(src),
                                     phase="prefill", **kw)
        want, wcache = jlayers.attention(p, jnp.asarray(x), cfg_j,
                                         cache=cache, pos=jnp.int32(3),
                                         phase="decode", **kw)
        tcache = {k: torch.from_numpy(np.asarray(v)) for k, v in cache.items()}
        got, gcache = layers.attention(mod, torch.from_numpy(x), cfg,
                                       mode=layers.AttnMode("cross"),
                                       positions=torch.from_numpy(pos),
                                       cache=tcache, pos=3, phase="decode")
        assert gcache["k"] is tcache["k"] and gcache["v"] is tcache["v"]
    else:
        want, wcache = jlayers.attention(p, jnp.asarray(x), cfg_j,
                                         kv_src=jnp.asarray(src),
                                         phase=phase, **kw)
        with torch.no_grad():
            got, gcache = layers.attention(
                mod, torch.from_numpy(x), cfg, mode=layers.AttnMode("cross"),
                positions=torch.from_numpy(pos),
                kv_src=torch.from_numpy(src), phase=phase)
    _assert_leaves_close({"y": got}, {"y": np.asarray(want)}, 1e-5, phase)
    if phase == "train":
        assert gcache is None
    else:
        assert set(gcache) == {"k", "v"}
        _assert_leaves_close(gcache, jax.tree.map(np.asarray, wcache), 1e-5,
                             f"{phase} cache")


def test_cross_attention_needs_the_encoder_states():
    _, cfg = _configs()
    mod = layers.init_attention(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.zeros((1, 3, cfg.d_model))
    with pytest.raises(ValueError, match="kv_src"):
        layers.attention(mod, x, cfg, mode=layers.AttnMode("cross"),
                         positions=torch.zeros((1, 3), dtype=torch.int32),
                         phase="prefill")


# ------------------------------------------------------- forward and loss
def test_forward_train_matches_jax(run):
    cfg, model = _port(run)
    batch = _batch(cfg)
    logits, aux = model.forward_train(batch["tokens"], _extras(batch))
    assert logits.shape == (2, 32, cfg.vocab) and float(aux) == 0.0
    _assert_leaves_close({"logits": logits}, {"logits": run["logits"]},
                         LEAF_TOL, "logits")


def test_loss_and_every_gradient_leaf_match_jax(run):
    """Every gradient leaf in the JAX pytree's layout: the encoder's
    (``enc.units.blk0``), the decoder's cross-attention and ``final_norm``,
    whose gradient sums its encoder and decoder uses in both packages."""
    cfg, model = _port(run)
    loss, ce, grads = _grads(model, _batch(cfg))
    assert float(loss) == pytest.approx(run["loss"], rel=LOSS_RTOL)
    assert float(ce) == pytest.approx(run["ce"], rel=LOSS_RTOL)
    got = _flat(convert.lm_params_to_numpy(model, grads))
    _assert_leaves_close(got, run["grads"], LEAF_TOL, "grad")
    for leaf in ("['enc']['units']['blk0']['attn']['wq']",
                 "['units']['blk0']['cross']['wk']",
                 "['units']['blk0']['ln_cross']"):
        assert float(np.abs(got[leaf]).max()) > 0, leaf


def test_final_norm_is_held_once_and_its_gradient_sums_both_uses(
        monkeypatch):
    """``final_norm`` closes the encoder and the decoder: the model lists it
    once (so AdamW keeps one state for it), and its gradient is the sum of
    the gradients each use alone gives (the other use reading a detached
    copy)."""
    _, cfg = _configs()
    model = transformer.init_params(cfg, seed=2, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert names.count("final_norm") == 1
    assert not any(n.startswith("enc_blocks.") and "norm" in n
                   for n in names)
    with torch.no_grad():     # away from ones, so both uses matter
        model.final_norm.mul_(torch.linspace(0.5, 1.5, cfg.d_model))
    batch = _batch(cfg, seed=4)
    _, _, whole = _grads(model, batch)
    rms = transformer.rmsnorm
    per_use = []
    for keep in (0, 1):        # 0: the encoder's use, 1: the decoder's
        calls = []

        def norm(x, scale, eps=1e-5, keep=keep, calls=calls):
            if scale is model.final_norm:
                calls.append(1)
                if len(calls) - 1 != keep:
                    scale = scale.detach()
            return rms(x, scale, eps)
        monkeypatch.setattr(transformer, "rmsnorm", norm)
        _, _, g = _grads(model, batch)
        assert len(calls) == 2
        per_use.append(g["final_norm"])
    monkeypatch.setattr(transformer, "rmsnorm", rms)
    want = per_use[0] + per_use[1]
    assert float(per_use[0].abs().max()) > 0 and float(
        per_use[1].abs().max()) > 0
    assert torch.allclose(whole["final_norm"], want, rtol=1e-5,
                          atol=1e-6 * float(want.abs().max()))


def test_train_step_matches_jax(run):
    """One ``make_train_step`` step from the same weights: loss, CE,
    moments and parameters (the rule in the module's docstring)."""
    want = run["step"]
    cfg, model = _port(run)
    model, opt, metrics = make_train_step(cfg, lr=LR)(
        model, adamw_init(model), _batch(cfg))
    assert int(opt["step"]) == 1
    assert float(metrics["loss"]) == pytest.approx(want["loss"],
                                                   rel=LOSS_RTOL)
    assert float(metrics["ce"]) == pytest.approx(want["ce"], rel=LOSS_RTOL)
    for key in ("mu", "nu"):
        _assert_leaves_close(
            _flat(convert.lm_params_to_numpy(model, opt[key])), want[key],
            LEAF_TOL, key)
    got = _flat(convert.lm_params_to_numpy(model))
    for k, w in want["params"].items():
        diff = np.abs(got[k] - w)
        g = np.abs(run["grads"][k])
        assert diff[g >= 1e-2 * g.max()].max(initial=0) <= 1e-3 * LR, k
        assert diff.max() <= 2 * LR, k
        assert (g[diff > 0.1 * LR] <= LEAF_TOL * g.max()).all(), k


def test_micro_batches_split_the_frames():
    """micro_batch 1 splits the frames with the tokens: its loss and
    gradients are the mean of each sample's alone."""
    _, cfg = _configs()
    batch = _batch(cfg, seed=6)
    out = {}
    for mb in (0, 1):
        model = transformer.init_params(cfg, seed=5, device="cpu")
        model, opt, m = make_train_step(cfg, micro_batch=mb, lr=LR)(
            model, adamw_init(model), batch)
        out[mb] = (float(m["loss"]), opt["mu"])
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    for k, mu in out[0][1].items():
        assert torch.allclose(out[1][1][k], mu, rtol=1e-4,
                              atol=1e-4 * float(mu.abs().max())), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip(dtype):
    """``lm_params_to_numpy(lm_params_from_numpy(tree))`` is the JAX tree
    leaf for leaf (bfloat16 bit for bit), the encoder stacked over
    ``enc_layers``; a missing leaf or another encoder depth raises."""
    cfg_j, cfg = _configs(dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(1), cfg_j))
    model = convert.lm_params_from_numpy(tree, cfg, "cpu")
    assert len(model.enc_blocks) == cfg.enc_layers == 2
    back = convert.lm_params_to_numpy(model)
    want, got = _flat(tree), _flat(back)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.array_equal(got[k], w), k
    with pytest.raises(ValueError, match="encoder layers"):
        convert.lm_params_from_numpy(tree, cfg.with_(enc_layers=3), "cpu")
    with pytest.raises(ValueError, match="not the port's"):
        del tree["units"]["blk0"]["cross"]["wo"]
        convert.lm_params_from_numpy(tree, cfg, "cpu")


# --------------------------------------------------------------- serving
def test_prefill_and_decode_match_jax(run):
    """Prefill logits and every cache leaf (each decoder layer's self ring
    and its cross k, v), then three teacher-forced decode steps: logits
    and caches (the cross k, v unchanged)."""
    cfg, model = _port(run)
    lt, ct = model.prefill(torch.from_numpy(run["prompt"]), cache_len=24,
                           extras={"frames": torch.from_numpy(run["frames"])})
    _assert_leaves_close({"l": lt}, {"l": run["prefill"]}, LEAF_TOL,
                         "prefill")
    cross0 = [c["cross"]["k"].clone() for c in ct]
    for t in range(4):
        want = _cache_leaves(convert.lm_cache_from_numpy(run["caches"][t],
                                                         cfg, "cpu"))
        got = _cache_leaves(ct)
        assert got.keys() == want.keys() and len(ct) == cfg.n_layers
        assert {k.split(".", 1)[1] for k in got} == {
            "self.k", "self.v", "self.kpos", "cross.k", "cross.v"}
        for k in [k for k in want if k.endswith("kpos")]:
            assert torch.equal(got.pop(k), want.pop(k)), (t, k)
        _assert_leaves_close(got, {k: v.numpy() for k, v in want.items()},
                             LEAF_TOL, f"cache {t}")
        if t == 3:
            break
        lt, ct = model.decode_step(ct, torch.from_numpy(run["forced"][t]),
                                   20 + t)
        _assert_leaves_close({"l": lt}, {"l": run["decoded"][t]}, LEAF_TOL,
                             f"decode {t}")
    assert all(torch.equal(c["cross"]["k"], k0) for c, k0 in zip(ct, cross0))


def test_serve_batch_tokens_equal_jax_loop(run):
    """The port's ``serve_batch`` with the frames as extras gives the
    greedy tokens of the JAX package's prefill + decode loop."""
    cfg, model = _port(run)
    served = run["served"]
    got, stats = serve.serve_batch(cfg, model, served["tokens"].numpy(), 6,
                                   22, extras=_extras(served))
    assert got.shape == (2, 6) and np.array_equal(got, run["greedy"])
    assert stats["logits_finite"]


def test_missing_frames_raise_a_clear_error(run):
    """Without frames the encoder cannot run: the port names them (the JAX
    package fails with a KeyError), at prefill, forward_train and through
    ``serve_batch`` with no extras, as the serve CLI calls it."""
    cfg, model = _port(run)
    toks = torch.from_numpy(run["prompt"])
    for call in (lambda: model.prefill(toks),
                 lambda: model.forward_train(toks),
                 lambda: transformer.lm_loss(model, {"tokens": toks}),
                 lambda: serve.serve_batch(cfg, model, run["prompt"], 2,
                                           22)):
        with pytest.raises(ValueError, match="frames"):
            call()


def test_decode_consistency_with_forward(run):
    """tests/test_archs_smoke.py::test_decode_consistency_with_forward on
    the port: prefill 12 tokens then decode the 13th (self ring and cross
    cache) equals the full forward's last position, within 1e-4 of the
    logits' largest."""
    cfg, model = _port(run)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 13)))
    frames = torch.from_numpy(rng.normal(
        size=(1, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    _, cache = model.prefill(toks[:, :12], cache_len=20,
                             extras={"frames": frames})
    dec, _ = model.decode_step(cache, toks[:, 12:], 12)
    with torch.no_grad():
        full, _ = model.forward_train(toks, {"frames": frames})
    _assert_leaves_close({"l": dec[0]}, {"l": full[0, -1].numpy()},
                         LEAF_TOL, "decode vs forward")


def test_encoder_flash_route_equals_plain_route(run):
    """The encoder at prefill (bidirectional attention through the flash
    wrapper) and at train (the plain ``_sdpa_chunked``, JAX's one route)
    give the same states, and both equal the JAX package's ``_encode``."""
    cfg, model = _port(run)
    frames = torch.from_numpy(run["frames"])
    with torch.inference_mode():
        flash = model._encode({"frames": frames}, "prefill")
    with torch.no_grad():
        plain = model._encode({"frames": frames}, "train")
    p = run["params"]
    want = jtransformer._encode({"enc_units": p["enc"]["units"],
                                 "enc_norm": p["final_norm"]},
                                jnp.asarray(run["frames"]), jreduced(
                                    jregistry.get(ARCH)))
    want = np.asarray(want)
    _assert_leaves_close({"flash": flash, "plain": plain},
                         {"flash": want, "plain": want}, LEAF_TOL, "encoder")


def test_make_cache_and_serve_steps():
    """``make_cache`` lays each layer out as the JAX package's ({"self":
    ring, "cross": zeros of (B, enc_frames, Kh, dh)}), the prefill step
    passes the frames on, and the serve step runs from the empty cache."""
    cfg_j, cfg = _configs()
    got = serve_step.make_cache(cfg, 2, 12, device="cpu")
    want = convert.lm_cache_from_numpy(
        jax.tree.map(np.asarray, jtransformer.make_cache(cfg_j, 2, 12)), cfg,
        "cpu")
    g, w = _cache_leaves(got), _cache_leaves(want)
    assert {k: (v.shape, v.dtype) for k, v in g.items()} == \
        {k: (v.shape, v.dtype) for k, v in w.items()}
    assert all(torch.equal(g[k], w[k]) for k in w)
    assert g["0.cross.k"].shape == (2, cfg.enc_frames, cfg.n_kv_heads,
                                    cfg.head_dim)
    model = transformer.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, s=8)
    l1, _ = serve_step.make_prefill_step(cfg)(model, batch)
    assert torch.equal(l1, model.prefill(batch["tokens"],
                                         extras=_extras(batch))[0])
    l2, _ = serve_step.make_serve_step(cfg)(model, got,
                                            batch["tokens"][:, :1], 4)
    assert l2.shape == (2, cfg.vocab) and torch.isfinite(l2).all()


# ------------------------------------------------------- the port alone
@pytest.mark.parametrize("remat", ["unit", "dots", "attn_out"])
def test_remat_unit_equals_none_bit_for_bit(remat):
    """``remat="unit"`` checkpoints each decoder unit and each encoder
    block, and ``"dots"`` and ``"attn_out"`` the same spans keeping what
    their policy saves (the encoder's and the decoder's self-attention
    outputs marked, not the cross-attention's, as in the JAX package): the
    loss and every gradient are the same bits as without remat."""
    _, cfg = _configs()
    batch = _batch(cfg, seed=3)
    out = {}
    for policy in (remat, "none"):
        model = transformer.init_params(cfg.with_(remat=policy), seed=4,
                                        device="cpu")
        out[policy] = _grads(model, batch)
    assert torch.equal(out[remat][0], out["none"][0])
    for k, g in out["none"][2].items():
        assert torch.equal(out[remat][2][k], g), k


def test_forward_and_loss_invariants():
    """The port's own initialisation: the encoder's blocks are dense and
    bidirectional, the decoder's carry cross-attention; finite (B, S, V)
    logits and an untrained CE within 2 of ln V."""
    _, cfg = _configs()
    model = transformer.init_params(cfg, seed=0, device="cpu")
    assert all(b.bidir and not hasattr(b, "cross") for b in model.enc_blocks)
    assert all(hasattr(b, "cross") and not b.bidir for b in model.blocks)
    batch = _batch(cfg)
    with torch.no_grad():
        logits, _ = model.forward_train(batch["tokens"], _extras(batch))
        loss, (ce, _) = transformer.lm_loss(model, batch)
    assert logits.shape == (2, 32, cfg.vocab)
    assert torch.isfinite(logits).all() and math.isfinite(float(loss))
    assert abs(float(ce) - math.log(cfg.vocab)) < 2.0

"""The port's VLM (qwen2-vl-2b) against the JAX package's, on the CPU.

qwen2-vl-2b at ``reduced()`` size in float32: 2 layers, 4 heads on 2 kv
heads of 64, M-RoPE sections (8, 12, 12), 8 patches.  The ``patches`` stub
(B, n_patches, d) is projected by ``vision_proj`` into the first n_patches
positions, which M-RoPE places on an (h, w) grid.  The same weights
(carried over by ``convert.lm_params_from_numpy``) and the same
NumPy-seeded tokens and patches (``synthetic_lm_batches``, bit-equal to the
JAX package's) go through the JAX package's ``forward_train``,
``lm_loss``, ``jax.value_and_grad``, jitted ``make_train_step``,
``prefill``, ``decode_step`` and ``serve_batch`` (tokens only: its
``{}`` extras), and through the port's.  The JAX results are computed once
per module (the ``run`` fixture).

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
from repro.launch import serve as jserve
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

ARCH = "qwen2-vl-2b"
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
    """The first ``synthetic_lm_batches`` batch: tokens, then patches."""
    return next(lm.synthetic_lm_batches(cfg, b, s, seed=seed, device="cpu"))


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
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch(cfg).items()}

    def loss_and_logits(p, b):
        loss, (ce, aux) = jtransformer.lm_loss(p, b, cfg_j)
        logits, _ = jtransformer.forward_train(p, b["tokens"], cfg_j,
                                               _extras(b))
        return loss, (ce, aux, logits)
    (loss, (ce, _, logits)), grads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(params, batch)
    p1, o1, m1 = jax.jit(jstep.make_train_step(cfg_j, lr=LR))(
        params, joptim.adamw_init(params), batch)

    # serving: prefill 20 tokens, the first 8 patches (cache 24), three
    # teacher-forced decodes
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg_j.vocab, (2, 20))
    patches = (rng.normal(size=(2, cfg_j.n_patches, cfg_j.d_model)) * 0.1
               ).astype(np.float32)
    forced = rng.integers(0, cfg_j.vocab, (3, 2, 1))
    lp, cache = jax.jit(lambda p, t, x: jtransformer.prefill(
        p, t, cfg_j, {"patches": x}, cache_len=24))(params, prompt, patches)
    step = jax.jit(lambda p, c, t, pos: jtransformer.decode_step(
        p, c, t, pos, cfg_j))
    caches, decoded = [jax.tree.map(np.asarray, cache)], []
    for t in range(3):
        ld, cache = step(params, cache, jnp.asarray(forced[t]),
                         jnp.int32(20 + t))
        decoded.append(np.asarray(ld))
        caches.append(jax.tree.map(np.asarray, cache))
    # greedy: the JAX package's serve_batch (tokens only), and the JAX
    # prefill + decode loop with the patches
    prompts = lm._markov_tokens(np.random.default_rng(7), cfg_j.vocab,
                                (2, 16))
    served, _ = jserve.serve_batch(cfg_j, params, prompts, 6, 22)
    lg, cache = jax.jit(lambda p, t, x: jtransformer.prefill(
        p, t, cfg_j, {"patches": x}, cache_len=22))(params, prompts,
                                                     patches)
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
            "prompt": prompt, "patches": patches, "forced": forced,
            "prefill": np.asarray(lp), "caches": caches, "decoded": decoded,
            "prompts": prompts, "served": served,
            "greedy": np.asarray(jnp.concatenate(greedy, 1))}


def _port(run, **kw):
    _, cfg = _configs(**kw)
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


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_patches_bit_equal(dtype):
    """Tokens and patches of two batches equal the JAX package's bit for
    bit, in float32 and in bfloat16."""
    cfg_j, cfg = _configs(dtype=dtype)
    mine = lm.synthetic_lm_batches(cfg, 2, 12, seed=5, device="cpu")
    theirs = jlm.synthetic_lm_batches(cfg_j, 2, 12, seed=5)
    for _ in range(2):
        a, b = next(mine), next(theirs)
        assert a.keys() == b.keys() == {"tokens", "patches"}
        assert a["patches"].shape == (2, cfg.n_patches, cfg.d_model)
        assert a["patches"].dtype == getattr(torch, dtype)
        assert np.array_equal(a["tokens"].numpy(), np.asarray(b["tokens"]))
        got, want = a["patches"], np.asarray(b["patches"])
        if dtype == "bfloat16":
            got, want = got.view(torch.int16), want.view(np.int16)
        assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------------ M-RoPE
@pytest.mark.parametrize("offset,seq", [(0, 300), (300, 1), (20, 40)])
def test_mrope_positions_and_rotation_match_jax(offset, seq):
    """At qwen2-vl-2b's own sizes (256 patches on a 16 x 16 grid, head dim
    128, sections (16, 24, 24)): the (t, h, w) position streams equal the
    JAX package's exactly — prefill from 0, a decode position past the
    patches, a window straddling the grid's end — and the rotation of
    random heads within 1e-5."""
    cfg_j, cfg = jregistry.get(ARCH), registry.get(ARCH)
    assert cfg.mrope_sections == (16, 24, 24) and cfg.head_dim == 128
    want = np.asarray(jtransformer._positions_for(cfg_j, 2, seq, offset))
    got = transformer._positions_for(cfg, 2, seq, offset, "cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    if offset == 0:   # patch i at (0, i // 16, i % 16); text advances t
        assert np.array_equal(want[:, 0, 17], [0, 1, 1])
        assert np.array_equal(want[:, 0, 260], [4, 4, 4])
    x = np.random.default_rng(seq).normal(
        size=(2, seq, 2, cfg.head_dim)).astype(np.float32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), got, cfg.rope_theta,
                          cfg.mrope_sections).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(want),
                                      cfg_j.rope_theta,
                                      cfg_j.mrope_sections)),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- forward and loss
def test_forward_train_matches_jax(run):
    cfg, model = _port(run)
    batch = _batch(cfg)
    logits, aux = model.forward_train(batch["tokens"], _extras(batch))
    assert logits.shape == (2, 32, cfg.vocab) and float(aux) == 0.0
    _assert_leaves_close({"logits": logits}, {"logits": run["logits"]},
                         LEAF_TOL, "logits")


def test_loss_and_every_gradient_leaf_match_jax(run):
    """Every gradient leaf in the JAX pytree's layout, ``vision_proj``'s
    among them."""
    cfg, model = _port(run)
    loss, ce, grads = _grads(model, _batch(cfg))
    assert float(loss) == pytest.approx(run["loss"], rel=LOSS_RTOL)
    assert float(ce) == pytest.approx(run["ce"], rel=LOSS_RTOL)
    got = _flat(convert.lm_params_to_numpy(model, grads))
    _assert_leaves_close(got, run["grads"], LEAF_TOL, "grad")
    assert float(np.abs(got["['vision_proj']"]).max()) > 0


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip(dtype):
    """``lm_params_to_numpy(lm_params_from_numpy(tree))`` is the JAX tree
    leaf for leaf (bfloat16 bit for bit), ``vision_proj`` at the top; a
    missing ``vision_proj`` raises."""
    cfg_j, cfg = _configs(dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(1), cfg_j))
    model = convert.lm_params_from_numpy(tree, cfg, "cpu")
    assert model.vision_proj.dtype == getattr(torch, dtype)
    back = convert.lm_params_to_numpy(model)
    want, got = _flat(tree), _flat(back)
    assert got.keys() == want.keys() and "['vision_proj']" in got
    for k, w in want.items():
        assert np.array_equal(got[k], w), k
    with pytest.raises(ValueError, match="not the port's"):
        del tree["vision_proj"]
        convert.lm_params_from_numpy(tree, cfg, "cpu")


# --------------------------------------------------------------- serving
def test_prefill_and_decode_match_jax(run):
    """Prefill with the patches (logits and every ring), then three
    teacher-forced decode steps, which embed no patches."""
    cfg, model = _port(run)
    lt, ct = model.prefill(torch.from_numpy(run["prompt"]), cache_len=24,
                           extras={"patches":
                                   torch.from_numpy(run["patches"])})
    _assert_leaves_close({"l": lt}, {"l": run["prefill"]}, LEAF_TOL,
                         "prefill")
    for t in range(4):
        want = convert.lm_cache_from_numpy(run["caches"][t], cfg, "cpu")
        assert len(ct) == len(want) == cfg.n_layers
        for i, (g, w) in enumerate(zip(ct, want)):
            assert torch.equal(g["kpos"], w.pop("kpos")), (t, i)
            g = {k: v for k, v in g.items() if k != "kpos"}
            _assert_leaves_close(g, {k: v.numpy() for k, v in w.items()},
                                 LEAF_TOL, f"cache {t} layer {i}")
        if t == 3:
            break
        lt, ct = model.decode_step(ct, torch.from_numpy(run["forced"][t]),
                                   20 + t)
        _assert_leaves_close({"l": lt}, {"l": run["decoded"][t]}, LEAF_TOL,
                             f"decode {t}")


def test_serve_batch_tokens_equal_jax(run):
    """No extras: the port's ``serve_batch`` (None) and the JAX package's
    (``{}``) serve the tokens alone, to the same greedy tokens."""
    cfg, model = _port(run)
    got, stats = serve.serve_batch(cfg, model, run["prompts"], 6, 22)
    assert got.shape == (2, 6) and np.array_equal(got, run["served"])
    assert stats["logits_finite"]


def test_serve_batch_with_patches_equals_jax_loop(run):
    """With the patches as extras, the greedy tokens of the JAX package's
    prefill + decode loop; the patches change them."""
    cfg, model = _port(run)
    got, _ = serve.serve_batch(
        cfg, model, run["prompts"], 6, 22,
        extras={"patches": torch.from_numpy(run["patches"])})
    assert np.array_equal(got, run["greedy"])
    assert not np.array_equal(run["greedy"], run["served"])


def test_decode_consistency_with_forward(run):
    """tests/test_archs_smoke.py::test_decode_consistency_with_forward on
    the port, with n_patches = 4 so that the patches fit in the 12-token
    prompt: prefill 12 then decode the 13th equals the full forward's last
    position, within 1e-4 of the logits' largest."""
    cfg, model = _port(run, n_patches=4)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 13)))
    patches = torch.from_numpy(rng.normal(
        size=(1, 4, cfg.d_model)).astype(np.float32))
    _, cache = model.prefill(toks[:, :12], cache_len=20,
                             extras={"patches": patches})
    dec, _ = model.decode_step(cache, toks[:, 12:], 12)
    with torch.no_grad():
        full, _ = model.forward_train(toks, {"patches": patches})
    _assert_leaves_close({"l": dec[0]}, {"l": full[0, -1].numpy()},
                         LEAF_TOL, "decode vs forward")


def test_patch_positions_take_no_token_embedding(run):
    """The patches replace the first n_patches positions: the tokens there
    change nothing once patches are given."""
    cfg, model = _port(run)
    batch = _batch(cfg, seed=2)
    other = batch["tokens"].clone()
    other[:, :cfg.n_patches] = (other[:, :cfg.n_patches] + 1) % cfg.vocab
    with torch.no_grad():
        a, _ = model.forward_train(batch["tokens"], _extras(batch))
        b, _ = model.forward_train(other, _extras(batch))
        c, _ = model.forward_train(other)
    assert torch.equal(a, b) and not torch.equal(b, c)


def test_patches_that_do_not_fit_raise(run):
    """Fewer positions than patches, or patches of another shape, raise a
    ValueError (the JAX package fails on a shape mismatch)."""
    cfg, model = _port(run)
    batch = _batch(cfg, s=6)
    with pytest.raises(ValueError, match="cannot hold"):
        model.prefill(batch["tokens"], extras=_extras(batch))
    batch = _batch(cfg)
    with pytest.raises(ValueError, match="patches of shape"):
        model.forward_train(batch["tokens"],
                            {"patches": batch["patches"][:, :5]})


def test_make_cache_and_serve_steps():
    """``make_cache`` lays each layer out as the JAX package's, the prefill
    step passes the patches on, and the serve step runs from the empty
    cache."""
    cfg_j, cfg = _configs()
    got = serve_step.make_cache(cfg, 2, 12, device="cpu")
    want = convert.lm_cache_from_numpy(
        jax.tree.map(np.asarray, jtransformer.make_cache(cfg_j, 2, 12)), cfg,
        "cpu")
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        assert {k: (v.shape, v.dtype) for k, v in g.items()} == \
            {k: (v.shape, v.dtype) for k, v in w.items()}
        assert all(torch.equal(g[k], w[k]) for k in w)
    model = transformer.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, s=12)
    l1, _ = serve_step.make_prefill_step(cfg)(model, batch)
    assert torch.equal(l1, model.prefill(batch["tokens"],
                                         extras=_extras(batch))[0])
    assert not torch.equal(l1, model.prefill(batch["tokens"])[0])
    l2, _ = serve_step.make_serve_step(cfg)(model, got,
                                            batch["tokens"][:, :1], 4)
    assert l2.shape == (2, cfg.vocab) and torch.isfinite(l2).all()


# ------------------------------------------------------- the port alone
def test_remat_unit_equals_none_bit_for_bit():
    """``remat="unit"`` checkpoints each layer: the loss and every gradient
    (``vision_proj``'s too) are the same bits as without it."""
    _, cfg = _configs()
    batch = _batch(cfg, seed=3)
    out = {}
    for remat in ("unit", "none"):
        model = transformer.init_params(cfg.with_(remat=remat), seed=4,
                                        device="cpu")
        out[remat] = _grads(model, batch)
    assert torch.equal(out["unit"][0], out["none"][0])
    for k, g in out["none"][2].items():
        assert torch.equal(out["unit"][2][k], g), k


def test_forward_and_loss_invariants():
    """The port's own initialisation: ``vision_proj`` (d, d) in the
    model's dtype; finite (B, S, V) logits and an untrained CE within 2 of
    ln V."""
    _, cfg = _configs()
    model = transformer.init_params(cfg, seed=0, device="cpu")
    assert model.vision_proj.shape == (cfg.d_model, cfg.d_model)
    batch = _batch(cfg)
    with torch.no_grad():
        logits, _ = model.forward_train(batch["tokens"], _extras(batch))
        loss, (ce, _) = transformer.lm_loss(model, batch)
    assert logits.shape == (2, 32, cfg.vocab)
    assert torch.isfinite(logits).all() and math.isfinite(float(loss))
    assert abs(float(ce) - math.log(cfg.vocab)) < 2.0

"""The port's SSM and hybrid models against the JAX package's, on the CPU.

xlstm-350m (mLSTM + sLSTM units) and zamba2-7b (five Mamba2 blocks and a
use of the weight-tied attention block per unit) at ``reduced()`` size in
float32, and zamba2-7b at 15 layers: ``reduced()`` gives zamba2 one unit
and no tail, 15 layers reach two uses of the shared block and the three
Mamba2 tail blocks.  The same weights (carried over by
``convert.lm_params_from_numpy``) and the same NumPy-seeded tokens go
through the JAX package's ``forward_train``, ``lm_loss``,
``jax.value_and_grad``, jitted ``make_train_step``, ``prefill``,
``decode_step`` and ``serve_batch``, and through the port's.  Each arch's
JAX results are computed once per module (``jax_run``).

Tolerances are tests/test_torch_train.py's and tests/test_torch_lm.py's
(float32; PyTorch's and XLA's CPU matrix products sum in different
orders): logits, caches and every gradient leaf within 1e-4 of the leaf's
largest magnitude; loss and CE rtol 1e-5; parameters after a step within
1e-3·lr where the gradient is at least 1e-2 of its leaf's largest.  The
AdamW moments are held to the gradients' 1e-4 of the leaf's largest
(tests/test_torch_train.py's 1e-5 for the attention models: here a Mamba2
``a_log`` gradient, a sum over every token of products with the exp
decays, was measured 1.3e-5 apart).

Adam's first step g / (|g| + eps) turns a gradient that is zero up to
rounding into a whole step of either sign.  tests/test_torch_train.py
allows 10 such elements in a model; these models have more parameters
whose gradient is rounding noise (measured: 19 in zamba2-7b, 110 at 15
layers, each with |g| under 1e-4 of its leaf's largest), so here an
element may move differently by more than 0.1·lr only where the reference
gradient is itself within the gradients' tolerance (1e-4 of the leaf's
largest) of zero, and by at most the step's range, 2·lr.  For the same
reason five steps chained at lr 3e-3 drift apart (measured: the fifth
loss 0.01 % apart for xlstm-350m, 6 % for zamba2 at 15 layers), as
boosting's chained rounds do (tests/test_torch_boosting.py compares each
round from the JAX fit's margin): each of the five steps here starts from
the JAX package's parameters and moments before it, and the port's own
chain is held to falling.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import transformer as jtransformer
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import reduced
from repro_torch.data import lm
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.serve import step as serve_step
from repro_torch.train import adamw_init
from repro_torch.train.step import make_train_step

# id -> (arch, overrides of reduced())
ARCHS = {"xlstm-350m": ("xlstm-350m", {}),
         "zamba2-7b": ("zamba2-7b", {}),
         "zamba2-7b-15L": ("zamba2-7b", {"n_layers": 15})}
LR = 3e-3
STEPS = 5
LEAF_TOL = 1e-4
LOSS_RTOL = 1e-5


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _configs(arch_id, **kw):
    arch, over = ARCHS[arch_id]
    return (jreduced(jregistry.get(arch)).with_(**over, **kw),
            reduced(registry.get(arch)).with_(**over, **kw))


def _tokens(cfg, b=2, s=32, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _jax_run(arch_id) -> dict:
    cfg_j, _ = _configs(arch_id)
    params = jtransformer.init_params(jax.random.key(0), cfg_j)
    batch = {"tokens": jnp.asarray(_tokens(cfg_j))}

    def loss_and_logits(p, b):
        loss, (ce, aux) = jtransformer.lm_loss(p, b, cfg_j)
        logits, _ = jtransformer.forward_train(p, b["tokens"], cfg_j)
        return loss, (ce, aux, logits)
    (loss, (ce, _, logits)), grads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(params, batch)
    fn = jax.jit(jstep.make_train_step(cfg_j, lr=LR))
    p, o = params, joptim.adamw_init(params)
    steps = []
    for _ in range(STEPS):   # each step's state before it, and after
        before = (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o))
        p, o, m = fn(p, o, batch)
        steps.append({"before": before, "params": _flat(p),
                      "mu": _flat(o["mu"]), "nu": _flat(o["nu"]),
                      "loss": float(m["loss"]), "ce": float(m["ce"])})

    # serving: prefill 20 tokens (cache 24), three teacher-forced decodes
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg_j.vocab, (2, 20))
    forced = rng.integers(0, cfg_j.vocab, (3, 2, 1))
    lp, cache = jtransformer.prefill(params, jnp.asarray(prompt), cfg_j, {},
                                     cache_len=24)
    caches, decoded = [jax.tree.map(np.asarray, cache)], []
    for t in range(3):
        ld, cache = jtransformer.decode_step(params, cache,
                                             jnp.asarray(forced[t]),
                                             jnp.int32(20 + t), cfg_j)
        decoded.append(np.asarray(ld))
        caches.append(jax.tree.map(np.asarray, cache))
    prompts = lm._markov_tokens(np.random.default_rng(7), cfg_j.vocab,
                                (2, 16))
    served, _ = jserve.serve_batch(cfg_j, params, prompts, 6, 22)
    return {"params": jax.tree.map(np.asarray, params),
            "logits": np.asarray(logits), "loss": float(loss),
            "ce": float(ce), "grads": _flat(grads), "steps": steps,
            "prompt": prompt, "forced": forced,
            "prefill": np.asarray(lp), "caches": caches, "decoded": decoded,
            "prompts": prompts, "served": served}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two threads each keep this module's share of a busy host's cores
    (the suite runs in several workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_run():
    cache: dict = {}

    def get(arch_id):
        if arch_id not in cache:
            cache[arch_id] = _jax_run(arch_id)
        return cache[arch_id]
    return get


def _port(arch_id, run):
    _, cfg = _configs(arch_id)
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


# ------------------------------------------------------- forward and loss
@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_forward_train_matches_jax(arch_id, jax_run):
    run = jax_run(arch_id)
    cfg, model = _port(arch_id, run)
    logits, aux = model.forward_train(torch.from_numpy(_tokens(cfg)))
    assert logits.shape == (2, 32, cfg.vocab) and float(aux) == 0.0
    _assert_leaves_close({"logits": logits}, {"logits": run["logits"]},
                         LEAF_TOL, arch_id)


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_loss_and_every_gradient_leaf_match_jax(arch_id, jax_run):
    """Every gradient leaf, leaf by leaf in the JAX pytree's layout; the
    shared attention block's is the sum over its uses in both packages."""
    run = jax_run(arch_id)
    cfg, model = _port(arch_id, run)
    loss, ce, grads = _grads(model,
                             {"tokens": torch.from_numpy(_tokens(cfg))})
    assert float(loss) == pytest.approx(run["loss"], rel=LOSS_RTOL)
    assert float(ce) == pytest.approx(run["ce"], rel=LOSS_RTOL)
    got = _flat(convert.lm_params_to_numpy(model, grads))
    _assert_leaves_close(got, run["grads"], LEAF_TOL, "grad")
    if "attn_shared" in cfg.pattern:
        assert float(np.abs(got["['shared_attn']['attn']['wq']"]).max()) > 0


def test_shared_block_is_held_once_and_its_gradient_sums_the_uses():
    """zamba2 at 15 layers has two uses of the shared block: its weights
    are listed once by ``named_parameters`` (so AdamW keeps one state for
    them), the uses hold no weights, and its gradient is the sum of the
    gradients each use alone would give."""
    _, cfg = _configs("zamba2-7b-15L")
    model = transformer.init_params(cfg, seed=2, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    shared = [n for n in names if n.startswith("shared_attn.")]
    assert len(shared) == len(set(shared)) == 9
    uses = [i for i, k in enumerate(transformer.layer_kinds(cfg))
            if k == "attn_shared"]
    assert uses == [5, 11]
    assert not any(n.startswith(f"blocks.{i}.") for i in uses for n in names)
    assert set(adamw_init(model)["mu"]) == set(names)
    toks = torch.from_numpy(_tokens(cfg, seed=4))
    _, _, whole = _grads(model, {"tokens": toks})
    # each use alone: the other use runs on a detached copy of the weights
    per_use = []
    for keep in uses:
        copy = transformer.Block(cfg, "cpu")
        copy.load_state_dict(model.shared_attn.state_dict())
        orig = model._layer

        def layer(i, keep=keep, orig=orig, copy=copy):
            return copy if i in uses and i != keep else orig(i)
        model._layer = layer
        _, _, g = _grads(model, {"tokens": toks})
        del model._layer
        per_use.append(g)
    for n in shared:
        want = per_use[0][n] + per_use[1][n]
        assert torch.allclose(whole[n], want, rtol=1e-5,
                              atol=1e-6 * float(want.abs().max())), n


def _opt_from_jax(opt: dict, cfg) -> dict:
    """The port's AdamW state holding the JAX package's (float32 moments
    carried over by parameter name)."""
    out = {"step": torch.tensor(int(opt["step"]), dtype=torch.int32)}
    for key in ("mu", "nu"):
        held = convert.lm_params_from_numpy(opt[key], cfg, "cpu")
        out[key] = {n: p.detach() for n, p in held.named_parameters()}
    return out


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_train_step_matches_jax(arch_id, jax_run):
    """One ``make_train_step`` step from the same weights: loss, CE,
    moments and parameters (the rule in the module's docstring)."""
    run = jax_run(arch_id)
    want = run["steps"][0]
    cfg, model = _port(arch_id, run)
    model, opt, metrics = make_train_step(cfg, lr=LR)(
        model, adamw_init(model), {"tokens": torch.from_numpy(_tokens(cfg))})
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


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_five_steps_match_jax(arch_id, jax_run):
    """Five AdamW steps at lr 3e-3 on one batch, each from the JAX
    package's parameters and moments before it: the loss and CE of each
    (rtol 1e-5) and the moments after it (1e-4 of the leaf's largest)
    equal the JAX package's; then the port's own five chained steps lower
    the loss, from the same first loss."""
    run = jax_run(arch_id)
    _, cfg = _configs(arch_id)
    step = make_train_step(cfg, lr=LR)
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    for k, want in enumerate(run["steps"]):
        params, opt = want["before"]
        model = convert.lm_params_from_numpy(params, cfg, "cpu")
        model, opt, metrics = step(model, _opt_from_jax(opt, cfg), batch)
        assert int(opt["step"]) == k + 1
        assert float(metrics["loss"]) == pytest.approx(want["loss"],
                                                       rel=LOSS_RTOL), k
        assert float(metrics["ce"]) == pytest.approx(want["ce"],
                                                     rel=LOSS_RTOL), k
        for key in ("mu", "nu"):
            _assert_leaves_close(
                _flat(convert.lm_params_to_numpy(model, opt[key])),
                want[key], LEAF_TOL, f"step {k} {key}")
    cfg, model = _port(arch_id, run)
    opt = adamw_init(model)
    losses = []
    for _ in range(STEPS):
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[0] == pytest.approx(run["steps"][0]["loss"], rel=LOSS_RTOL)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_lm_params_round_trip(arch_id, dtype):
    """``lm_params_to_numpy(lm_params_from_numpy(tree))`` is the JAX tree
    leaf for leaf (bfloat16 bit for bit), with the empty mapping of each
    ``attn_shared`` use in its place."""
    cfg_j, cfg = _configs(arch_id, dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(1), cfg_j))
    model = convert.lm_params_from_numpy(tree, cfg, "cpu")
    back = convert.lm_params_to_numpy(model)
    want, got = _flat(tree), _flat(back)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.array_equal(got[k], w), k
    assert list(back["units"]) == list(tree["units"])
    if "attn_shared" in cfg.pattern:
        assert back["units"]["blk5"] == {} == tree["units"]["blk5"]
    assert len(back.get("tail", [])) == len(tree.get("tail", [])) == len(
        cfg.tail_blocks)
    with pytest.raises(ValueError, match="not the port's"):
        del tree["units"]["blk0"]["core"]["out_proj"]
        convert.lm_params_from_numpy(tree, cfg, "cpu")


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_prefill_and_decode_match_jax(arch_id, jax_run):
    """Prefill logits and every cache leaf (the KV ring of each shared-block
    use, each SSM state), then three teacher-forced decode steps: logits
    and caches."""
    run = jax_run(arch_id)
    cfg, model = _port(arch_id, run)
    lt, ct = model.prefill(torch.from_numpy(run["prompt"]), cache_len=24)
    _assert_leaves_close({"l": lt}, {"l": run["prefill"]}, LEAF_TOL,
                         "prefill")
    for t in range(4):
        want = convert.lm_cache_from_numpy(run["caches"][t], cfg, "cpu")
        assert len(ct) == len(want) == cfg.n_layers
        for i, (g, w) in enumerate(zip(ct, want)):
            if "kpos" in w:
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


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_serve_batch_tokens_equal_jax(arch_id, jax_run):
    run = jax_run(arch_id)
    cfg, model = _port(arch_id, run)
    got, stats = serve.serve_batch(cfg, model, run["prompts"], 6, 22)
    assert got.shape == (2, 6) and np.array_equal(got, run["served"])
    assert stats["logits_finite"]


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_decode_consistency_with_forward(arch_id, jax_run):
    """tests/test_archs_smoke.py::test_decode_consistency_with_forward on
    the port: prefill 12 tokens then decode the 13th equals the full
    forward's last position (the recurrent states and the shared block's
    caches carried right), within 1e-4 of the logits' largest."""
    run = jax_run(arch_id)
    cfg, model = _port(arch_id, run)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 13)))
    _, cache = model.prefill(toks[:, :12], cache_len=20)
    dec, _ = model.decode_step(cache, toks[:, 12:], 12)
    with torch.no_grad():
        full, _ = model.forward_train(toks)
    _assert_leaves_close({"l": dec[0]}, {"l": full[0, -1].numpy()},
                         LEAF_TOL, "decode vs forward")


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_make_cache_and_serve_steps(arch_id):
    """``make_cache`` lays each layer out as the JAX package's (a ring per
    attention use, a zero state per SSM block), and the serve steps run
    from it."""
    cfg_j, cfg = _configs(arch_id)
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
    toks = torch.from_numpy(_tokens(cfg, s=8))
    l1, c1 = serve_step.make_prefill_step(cfg)(model, {"tokens": toks})
    assert torch.equal(l1, model.prefill(toks)[0])
    l2, _ = serve_step.make_serve_step(cfg)(model, got, toks[:, :1], 4)
    assert l2.shape == (2, cfg.vocab) and torch.isfinite(l2).all()


# ------------------------------------------------------- the port alone
@pytest.mark.parametrize("remat", ["unit", "dots", "attn_out"])
def test_remat_unit_equals_none_bit_for_bit(remat):
    """``remat="unit"`` checkpoints each pattern unit (six blocks, one of
    them a use of the shared block; the tail is not checkpointed), and
    ``"dots"`` and ``"attn_out"`` the same units keeping what their policy
    saves (the shared block's attention output is marked at each use):
    the loss and every gradient are the same bits as without remat."""
    _, cfg = _configs("zamba2-7b-15L")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, seed=3))}
    out = {}
    for policy in (remat, "none"):
        model = transformer.init_params(cfg.with_(remat=policy), seed=4,
                                        device="cpu")
        out[policy] = _grads(model, batch)
    assert torch.equal(out[remat][0], out["none"][0])
    for k, g in out["none"][2].items():
        assert torch.equal(out[remat][2][k], g), k


@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_forward_and_loss_invariants(arch_id):
    """The port's own initialisation: finite (B, S, V) logits and an
    untrained CE within 2 of ln V."""
    _, cfg = _configs(arch_id)
    model = transformer.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg))
    with torch.no_grad():
        logits, _ = model.forward_train(toks)
        loss, (ce, _) = transformer.lm_loss(model, {"tokens": toks})
    assert logits.shape == (2, 32, cfg.vocab)
    assert torch.isfinite(logits).all() and math.isfinite(float(loss))
    assert abs(float(ce) - math.log(cfg.vocab)) < 2.0

"""The port's LM training path against the JAX package, on the CPU.

For the four dense configs and the two MoE configs at ``reduced()`` size in
float32, the same weights (carried over by ``convert.lm_params_from_numpy``)
and the same NumPy-seeded tokens go through the JAX package's
``forward_train``, ``lm_loss``, ``jax.value_and_grad`` and jitted
``make_train_step``, and through the port's.  Each arch's JAX results are
computed once per module (``jax_run``).

Tolerances, set from float32 and the measured differences (PyTorch's and
XLA's CPU matrix products sum in different orders):
  * logits and every gradient leaf: within 1e-4 of the leaf's largest
    magnitude (measured: up to 2.3e-6);
  * loss, CE and aux: rtol 1e-5; the CE of 5 chained steps: rtol 1e-4;
  * AdamW moments: within 1e-5 of the leaf's largest magnitude;
  * parameters after a step: within 1e-3·lr where the reference gradient
    is at least 1e-2 of its leaf's largest magnitude (measured: up to
    2e-5·lr).  Elsewhere Adam's first step g / (|g| + eps) turns the
    gradients' rounding differences (up to 1e-4 of the leaf's largest, as
    above) into up to a whole step where g is that small, so there only
    the step's range (2·lr) holds, and at most 10 elements of a model may
    differ by more than 0.1·lr (measured: 0 to 5).  ``adamw_update``
    itself is held tightly on identical inputs.
"""
import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jregistry
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtransformer
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import reduced
from repro_torch.kernels.attention import flash_attention
from repro_torch.models import layers, transformer
from repro_torch.train import adamw_init, adamw_update, cosine_lr, optim
from repro_torch.train.step import make_train_step

ARCHS = ["internlm2-1.8b", "glm4-9b", "mistral-nemo-12b", "qwen3-32b",
         "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"]
LR = 3e-3
STEPS = 5
LEAF_TOL = 1e-4
LOSS_RTOL = 1e-5
CHAIN_RTOL = 1e-4


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _configs(arch, **kw):
    return (jreduced(jregistry.get(arch)).with_(**kw),
            reduced(registry.get(arch)).with_(**kw))


def _tokens(cfg, b=2, s=32, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _jax_run(arch) -> dict:
    cfg_j, _ = _configs(arch)
    params = jtransformer.init_params(jax.random.key(0), cfg_j)
    batch = {"tokens": jnp.asarray(_tokens(cfg_j))}

    def loss_and_logits(p, b):       # one compile for both
        loss, (ce, aux) = jtransformer.lm_loss(p, b, cfg_j)
        logits, _ = jtransformer.forward_train(p, b["tokens"], cfg_j)
        return loss, (ce, aux, logits)
    (loss, (ce, aux, logits)), grads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(params, batch)
    opt = joptim.adamw_init(params)
    steps = {}
    for mb in (2, 1):       # one backward; two microbatches of one row
        fn = jax.jit(jstep.make_train_step(cfg_j, micro_batch=mb, lr=LR))
        p, o, m = fn(params, opt, batch)
        steps[mb] = {"params": _flat(p), "mu": _flat(o["mu"]),
                     "nu": _flat(o["nu"]), "loss": float(m["loss"]),
                     "ce": float(m["ce"]), "fn": fn, "next": (p, o)}
    p, o = steps[2].pop("next")
    losses = [steps[2]["loss"]]
    for _ in range(STEPS - 1):
        p, o, m = steps[2]["fn"](p, o, batch)
        losses.append(float(m["loss"]))
    return {"params": jax.tree.map(np.asarray, params),
            "logits": np.asarray(logits), "aux": float(aux),
            "loss": float(loss), "ce": float(ce), "grads": _flat(grads),
            "steps": steps, "losses": losses}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The reduced models' ops are small: two threads each keep this
    module's share of a busy host's cores (the suite runs in several
    workers) without losing speed alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_run():
    cache: dict = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _jax_run(arch)
        return cache[arch]
    return get


def _port(arch, run):
    _, cfg = _configs(arch)
    return cfg, convert.lm_params_from_numpy(run["params"], cfg, "cpu")


def _grads(model, batch):
    model.requires_grad_()
    loss, (ce, aux) = transformer.lm_loss(model, batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), ce.detach(), aux.detach(), dict(zip(names, grads))


def _assert_leaves_close(got: dict, want: dict, tol: float, what: str):
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        bound = tol * float(np.abs(w).max()) + 1e-12
        assert err <= bound, f"{what} {k}: {err:.3g} > {bound:.3g}"


def _assert_params_after_step(got: dict, want: dict, grads: dict):
    loose = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        conditioned = np.abs(grads[k]) >= 1e-2 * np.abs(grads[k]).max()
        assert diff[conditioned].max(initial=0) <= 1e-3 * LR, k
        assert diff.max() <= 2 * LR, k
        loose += int((diff[~conditioned] > 0.1 * LR).sum())
    assert loose <= 10, f"{loose} parameters beyond 0.1·lr"


# ------------------------------------------------------- forward and loss
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch, jax_run):
    run = jax_run(arch)
    cfg, model = _port(arch, run)
    model.requires_grad_()
    logits, aux = model.forward_train(torch.from_numpy(_tokens(cfg)))
    assert logits.shape == (2, 32, cfg.vocab) and logits.requires_grad
    _assert_leaves_close({"logits": logits.detach().numpy()},
                         {"logits": run["logits"]}, LEAF_TOL, arch)
    assert aux.dtype == torch.float32
    if cfg.n_experts:
        assert float(aux.detach()) == pytest.approx(run["aux"],
                                                    rel=LOSS_RTOL)
    else:
        assert float(aux) == run["aux"] == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch, jax_run):
    run = jax_run(arch)
    cfg, model = _port(arch, run)
    loss, ce, _, grads = _grads(model,
                                {"tokens": torch.from_numpy(_tokens(cfg))})
    assert float(loss) == pytest.approx(run["loss"], rel=LOSS_RTOL)
    assert float(ce) == pytest.approx(run["ce"], rel=LOSS_RTOL)
    got = _flat(convert.lm_params_to_numpy(model, grads))
    _assert_leaves_close(got, run["grads"], LEAF_TOL, "grad")
    # the attention projections train: the flash kernel (no backward) is
    # not on this path
    for k in ("wq", "wk", "wv"):
        assert float(np.abs(got[f"['units']['blk0']['attn']['{k}']"]).max()) > 0


@pytest.mark.parametrize("micro_batch", [2, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, micro_batch, jax_run):
    """One ``make_train_step`` step from the same weights: one backward
    (micro_batch 2 of a batch of 2), or two microbatches accumulated in
    float32 (micro_batch 1)."""
    run = jax_run(arch)
    want = run["steps"][micro_batch]
    cfg, model = _port(arch, run)
    step = make_train_step(cfg, micro_batch=micro_batch, lr=LR)
    model, opt, metrics = step(model, adamw_init(model),
                               {"tokens": torch.from_numpy(_tokens(cfg))})
    assert int(opt["step"]) == 1 and opt["step"].dtype == torch.int32
    assert float(metrics["loss"]) == pytest.approx(want["loss"],
                                                   rel=LOSS_RTOL)
    assert float(metrics["ce"]) == pytest.approx(want["ce"], rel=LOSS_RTOL)
    _assert_leaves_close(_flat(convert.lm_params_to_numpy(model, opt["mu"])),
                         want["mu"], 1e-5, "mu")
    _assert_leaves_close(_flat(convert.lm_params_to_numpy(model, opt["nu"])),
                         want["nu"], 1e-5, "nu")
    _assert_params_after_step(_flat(convert.lm_params_to_numpy(model)),
                              want["params"], run["grads"])


@pytest.mark.parametrize("arch", ARCHS)
def test_five_steps_from_converted_weights_match_jax(arch, jax_run):
    """Five chained steps on one batch at lr 3e-3: the losses equal the JAX
    package's jitted step's, and fall (``test_train_step_reduces_loss``)."""
    run = jax_run(arch)
    cfg, model = _port(arch, run)
    step = make_train_step(cfg, lr=LR)
    opt = adamw_init(model)
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    losses = []
    for _ in range(STEPS):
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, run["losses"], rtol=CHAIN_RTOL)
    assert losses[-1] < losses[0] and run["losses"][-1] < run["losses"][0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip(arch, dtype):
    """``lm_params_to_numpy`` inverts ``lm_params_from_numpy``: the JAX
    pytree comes back leaf for leaf (an MoE layer's router, expert stacks
    and shared MLP too; bfloat16 as float32, exactly)."""
    cfg_j, cfg = _configs(arch, dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        jtransformer.init_params(jax.random.key(1), cfg_j))
    back = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(tree, cfg, "cpu"))
    want, got = _flat(tree), _flat(back)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.array_equal(got[k], w), k
    if cfg.n_experts:
        assert {"router", "we_gate", "we_up", "we_down"} <= set(
            back["units"]["blk0"]["ffn"])
    with pytest.raises(ValueError, match="not the port's"):
        del tree["units"]["blk0"]["ffn"]["wd" if not cfg.n_experts
                                         else "we_down"]
        convert.lm_params_from_numpy(tree, cfg, "cpu")


# ------------------------------------------------------- remat policies
REMATS = ["unit", "dots", "attn_out"]


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_unit_equals_none_bit_for_bit(arch, remat):
    """``remat="unit"`` checkpoints each block and recomputes it in the
    backward pass; ``"dots"`` and ``"attn_out"`` checkpoint the same spans
    and keep what their policy saves: on the CPU the loss, aux and every
    gradient are the same bits as without remat."""
    _, cfg = _configs(arch)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, seed=3))}
    out = {}
    for policy in (remat, "none"):
        model = transformer.init_params(cfg.with_(remat=policy), seed=4,
                                        device="cpu")
        loss, _, aux, grads = _grads(model, batch)
        out[policy] = (loss, aux, grads)
    assert torch.equal(out[remat][0], out["none"][0])
    assert torch.equal(out[remat][1], out["none"][1])
    for k, g in out["none"][2].items():
        assert torch.equal(out[remat][2][k], g), k


@pytest.mark.parametrize("remat", ["dots", "attn_out"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b"])
def test_remat_policy_gradients_match_jax(arch, remat):
    """Under the same ``cfg.remat`` (JAX: ``jax.checkpoint`` of each unit
    with ``dots_with_no_batch_dims_saveable`` or
    ``save_only_these_names("attn_out")``), the loss and every gradient
    leaf equal the JAX package's ``lm_loss`` gradient within the module's
    tolerances."""
    cfg_j, cfg = _configs(arch, remat=remat)
    params = jtransformer.init_params(jax.random.key(2), cfg_j)
    toks = _tokens(cfg, seed=5)
    (loss, (ce, aux)), grads = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.lm_loss(p, {"tokens": jnp.asarray(toks)},
                                       cfg_j), has_aux=True))(params)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                         cfg, "cpu")
    got_loss, got_ce, got_aux, got = _grads(
        model, {"tokens": torch.from_numpy(toks)})
    assert float(got_loss) == pytest.approx(float(loss), rel=LOSS_RTOL)
    assert float(got_ce) == pytest.approx(float(ce), rel=LOSS_RTOL)
    assert float(got_aux) == pytest.approx(float(aux), rel=LOSS_RTOL,
                                           abs=1e-12)
    _assert_leaves_close(_flat(convert.lm_params_to_numpy(model, got)),
                         _flat(grads), LEAF_TOL, f"grad ({remat})")


class _CountOps(TorchDispatchMode):
    """Counts each ATen operator dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_save_what_they_name():
    """What each policy keeps, by counting the operators one backward pass
    dispatches (the recomputed ones among them; early stop off, so that a
    recompute runs its whole unit): ``"unit"`` recomputes every ``mm`` of
    its units (all of the forward's but ``lm_head``'s), ``"dots"`` none —
    its backward runs as many as ``"none"``'s — but the attention's and
    the experts' ``bmm``s; ``"attn_out"`` recomputes the ``mm``s and keeps
    the marked attention output (its operator never runs again)."""
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    mark = torch.ops.repro_torch.attn_out.default
    _, cfg = _configs("qwen2-moe-a2.7b")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, seed=3))}
    fwd, bwd = {}, {}
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        for remat in ("none", *REMATS):
            model = transformer.init_params(cfg.with_(remat=remat), seed=4,
                                            device="cpu")
            model.requires_grad_()
            with _CountOps() as counted:
                loss, _ = transformer.lm_loss(model, batch)
            fwd[remat] = counted.counts
            with _CountOps() as counted:
                torch.autograd.grad(loss, list(model.parameters()))
            bwd[remat] = counted.counts
    in_units = fwd["none"][mm] - 1                  # all but lm_head's
    assert bwd["unit"][mm] == bwd["none"][mm] + in_units
    assert bwd["dots"][mm] == bwd["none"][mm]
    assert bwd["dots"][bmm] == bwd["unit"][bmm] > bwd["none"][bmm]
    assert bwd["attn_out"][mm] == bwd["unit"][mm]
    assert fwd["attn_out"][mark] == cfg.n_layers
    assert bwd["attn_out"][mark] == 0
    assert all(fwd[r][mark] == 0 for r in ("none", "unit", "dots"))


def test_remat_policies_and_batches_refused():
    """The remat policies train (each of ``"dots"``, ``"attn_out"`` gives
    ``"none"``'s loss); an unknown remat raises ValueError; a model
    sharded for serving (a model-axis comm, no training layout) refuses
    to train and names ``mode="train"``; a batch that is no multiple of
    micro_batch raises."""
    _, cfg = _configs("internlm2-1.8b")
    toks = torch.from_numpy(_tokens(cfg))
    with torch.no_grad():
        losses = [transformer.lm_loss(transformer.init_params(
            cfg.with_(remat=policy), seed=0, device="cpu"),
            {"tokens": toks})[0] for policy in ("none", "dots", "attn_out")]
    assert all(torch.equal(loss, losses[0]) for loss in losses)
    with pytest.raises(ValueError, match="unknown remat"):
        transformer.init_params(cfg.with_(remat="full"), seed=0,
                                device="cpu").forward_train(toks)
    served = transformer.init_params(cfg, seed=0, device="cpu")
    served.tp = object()           # a model-axis comm, as shard_model binds
    with pytest.raises(NotImplementedError, match="mode='train'"):
        served.forward_train(toks)
    model = transformer.init_params(cfg, seed=0, device="cpu")
    # a batch's other keys are extras, which a decoder-only config ignores
    # (as the JAX package's lm_loss does): the same loss, not a refusal
    with torch.no_grad():
        plain, _ = transformer.lm_loss(model, {"tokens": toks})
        extra, _ = transformer.lm_loss(model, {"tokens": toks,
                                               "frames": toks.float()})
    assert torch.equal(plain, extra)
    with pytest.raises(ValueError, match="no multiple"):
        make_train_step(cfg, micro_batch=3)(
            model, adamw_init(model),
            {"tokens": torch.from_numpy(_tokens(cfg, b=8))})


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_invariants(arch):
    """tests/test_archs_smoke.py::test_forward_and_loss on the port's own
    initialisation: (B, S, V) finite logits, a finite loss and an untrained
    CE within 2 of ln V."""
    _, cfg = _configs(arch)
    model = transformer.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg))
    with torch.no_grad():
        logits, _ = model.forward_train(toks)
        loss, (ce, _) = transformer.lm_loss(model, {"tokens": toks})
    assert logits.shape == (2, 32, cfg.vocab)
    assert torch.isfinite(logits).all() and math.isfinite(float(loss))
    assert abs(float(ce) - math.log(cfg.vocab)) < 2.0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reduces_loss_invariant(arch):
    """tests/test_archs_smoke.py::test_train_step_reduces_loss on the
    port's own initialisation: 5 steps of value-and-grad + AdamW at lr
    3e-3 on one batch lower the loss."""
    _, cfg = _configs(arch)
    model = transformer.init_params(cfg, seed=1, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, seed=1))}
    opt = adamw_init(model)
    losses = []
    for _ in range(STEPS):
        loss, _, _, grads = _grads(model, batch)
        opt = adamw_update(model, grads, opt, lr=LR)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"loss did not drop: {losses}"


def test_training_never_reaches_the_flash_kernel(monkeypatch):
    """``forward_train`` and its backward run no flash attention (the
    kernel's wrapper would raise on the grad-requiring q, k, v); prefill,
    under inference mode, still goes through it."""
    _, cfg = _configs("internlm2-1.8b")
    model = transformer.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg))
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return flash_attention(*a, **kw)
    monkeypatch.setattr(layers, "flash_attention", counted)
    loss, _, _, grads = _grads(model, {"tokens": toks})
    assert calls == [] and all(torch.isfinite(g).all()
                               for g in grads.values())
    model.prefill(toks)
    assert len(calls) == cfg.n_layers


def test_flash_wrapper_refuses_grad_requiring_inputs():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 8, 64)).astype(
        np.float32)) for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward pass"):
        flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape
    # prefill-phase attention with trainable weights and grad enabled
    _, cfg = _configs("internlm2-1.8b")
    model = transformer.init_params(cfg, seed=0, device="cpu")
    model.requires_grad_()
    x = torch.zeros((1, 4, cfg.d_model))
    pos = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward pass"):
        layers.attention(model.blocks[0].attn, x, cfg,
                         mode=layers.AttnMode("causal"), positions=pos,
                         phase="prefill")
    with pytest.raises(ValueError, match="phase"):
        layers.attention(model.blocks[0].attn, x, cfg,
                         mode=layers.AttnMode("causal"), positions=pos,
                         phase="serve")
    with pytest.raises(ValueError, match="only decode reads a cache"):
        layers.attention(model.blocks[0].attn, x, cfg,
                         mode=layers.AttnMode("causal"), positions=pos,
                         phase="decode")


# -------------------------------------------------------------- optimizer
def jparams_dtype(tree, key: str):
    return {jax.tree_util.keystr(k): v.dtype for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Two AdamW steps on the same parameters and gradients (norm scales
    among them: weight decay applies to every leaf): moments within 1e-6 of
    their leaf's largest magnitude, parameters within 1e-6 of it (XLA fuses
    the update and rounds it a step apart at most), bfloat16 ones within
    one bfloat16 step more."""
    rng = np.random.default_rng(5)
    _, cfg = _configs("internlm2-1.8b", dtype=dtype, n_layers=1)
    model = transformer.init_params(cfg, seed=2, device="cpu")
    tree = convert.lm_params_to_numpy(model)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = jax.tree_util.tree_map_with_path(
        lambda k, a: jnp.asarray(a).astype(
            jnp.float32 if "ln" in str(k) or "norm" in str(k) else jdt),
        tree)
    jstate = joptim.adamw_init(jparams)
    state = adamw_init(model)
    names = [n for n, _ in model.named_parameters()]
    for i in range(2):
        g = {n: rng.normal(size=p.shape).astype(np.float32)
             * 10.0 ** rng.integers(-6, 0)
             for n, p in model.named_parameters()}
        gt = {n: torch.from_numpy(a).to(dict(model.named_parameters())[n]
                                        .dtype) for n, a in g.items()}
        jg = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(model, gt))
        jg = jax.tree.map(lambda gg, p: gg.astype(p.dtype), jg, jparams)
        jparams, jstate = joptim.adamw_update(jparams, jg, jstate, lr=1e-2)
        state = adamw_update(model, gt, state, lr=1e-2)
    assert int(state["step"]) == int(jstate["step"]) == 2
    for key in ("mu", "nu"):
        _assert_leaves_close(
            _flat(convert.lm_params_to_numpy(model, state[key])),
            _flat(jstate[key]), 1e-6, key)
    got, want = _flat(convert.lm_params_to_numpy(model)), _flat(jparams)
    for k, w in want.items():
        tol = 1e-6 * np.abs(w).max()           # a few float32 steps
        if dtype == "bfloat16" and jparams_dtype(jparams, k) != jnp.float32:
            tol = tol + 2.0 ** -7 * np.abs(w)  # one bfloat16 step
        assert (np.abs(got[k] - w) <= tol).all(), k
    assert set(state["mu"]) == set(names)


def test_cosine_lr_matches_jax():
    for warmup, total in ((10, 100), (0, 50), (5, 5)):
        for s in range(0, total + 8):
            got = cosine_lr(torch.tensor(s, dtype=torch.int32), peak=3e-4,
                            warmup=warmup, total=total)
            want = joptim.cosine_lr(jnp.int32(s), peak=3e-4, warmup=warmup,
                                    total=total)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(want), rel=1e-6,
                                               abs=1e-12)
    assert optim.cosine_lr(0, peak=1.0, warmup=4, total=8) == 0.0

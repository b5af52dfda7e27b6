"""The port's FSDP × tensor-parallel training on gloo ranks, on the CPU.

``models/parallel.py::ShardedLM(..., mode="train")`` — one process a rank
of a ("data", "model") mesh, each holding its slices of the JAX package's
weights by ``param_specs(mode="train")`` and its AdamW moments by
``opt_specs``, trained by the port's own ``make_train_step`` on its rows
— against the unsharded port's step (one thread, as each rank runs) and
the JAX package's ``make_train_step`` on the same weights and batch:

  * the loss, CE and aux and every leaf's reduced gradient slice: at
    (data, model) = (1, 1) bit for bit (every collective is over a group
    of one); at (1, 2), (2, 1) and (2, 2) the gradients within 1e-5 of
    the leaf's largest magnitude of the unsharded port's (the sums of the
    axes' all-reduces and reduce-scatters run in an order of their own;
    measured up to 2.4e-6) and within 1e-4 of JAX's (as
    tests/test_torch_train.py), the loss, CE and aux within rtol 1e-5;
    slices that two ranks both hold (replicas) are equal bit for bit;
  * the parameter, μ and ν slices after three steps at lr 3e-3, with one
    backward pass a step and with micro_batch 2 of 4, bit for bit at
    (1, 1).  Elsewhere as tests/test_torch_train.py compares an Adam
    step, over three chained ones: Adam's first step g / (|g| + eps)
    turns rounding in near-zero gradients into up to a whole step, and
    the next steps' gradients then differ by more than the first's.  So
    the parameters within 0.05·lr where the first step's gradient is at
    least 1e-2 of its leaf's largest (measured up to 0.022·lr), 2·lr a
    step elsewhere (measured 0.69·lr), with at most 10 elements a model
    beyond 0.1·lr (measured 3); μ and ν within 5e-3 of the leaf's
    largest magnitude (measured 1.2e-3 against JAX, 7.2e-4 against the
    port at model = 2, 3.4e-5 at (2, 1));
  * the router's (MoE) and ``q_norm`` / ``k_norm``'s (qwen3-32b) gradients
    summed once over the model axis; the MoE's aux loss on a batch split
    over "data" equal to the whole batch's; a rank's gathered FSDP
    weights never more than one layer's; the remat policies "dots" and
    "attn_out" under the collectives, bit-equal to "unit".

The configurations, at ``reduced()`` size in float32: internlm2-1.8b
(dense), qwen2-moe-a2.7b (4 experts top 2 and a shared expert, capacity
8.0: nothing drops) and qwen3-32b (qk_norm).  A batch of 4 × 16.  One
spawned world a mesh shape; each case rebuilds its ranks' model.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtransformer
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import reduced
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import collectives, parallel, transformer
from repro_torch.train import adamw_init
from repro_torch.train.step import accumulate_grads, make_train_step

CASES = {"dense": "internlm2-1.8b", "moe": "qwen2-moe-a2.7b",
         "qk": "qwen3-32b"}
WORLDS = ((1, 1), (1, 2), (2, 1), (2, 2))
RUNS = [(mesh, case) for mesh in WORLDS for case in CASES]
IDS = [f"{d}x{m}-{case}" for (d, m), case in RUNS]
MICRO = (0, 2)
POLICIES = ("dots", "attn_out")
B, S, LR, STEPS = 4, 16, 3e-3, 3
GRAD_TOL, JAX_TOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
CHAIN_MOMENT_TOL, CHAIN_PARAM_TOL = 5e-3, 0.05     # the latter times lr


def _configs(case, **kw):
    arch = CASES[case]
    return (jreduced(jregistry.get(arch)).with_(**kw),
            reduced(registry.get(arch)).with_(**kw))


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(11).integers(0, cfg.vocab, (B, S))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _one_thread(fn):
    @functools.wraps(fn)
    def run(*args):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*args)
        finally:
            torch.set_num_threads(threads)
    return run


@functools.lru_cache(maxsize=None)
@_one_thread
def _port(case):
    """The JAX weights and the unsharded port's gradients, metrics and
    three-step states (one thread, as each rank runs)."""
    cfg_j, cfg = _configs(case)
    params = jax.tree.map(np.asarray,
                          jtransformer.init_params(jax.random.key(0), cfg_j))
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    model = convert.lm_params_from_numpy(params, cfg, "cpu")
    names, grads, metrics = accumulate_grads(model, batch)
    out = {"params": params, "grads": dict(zip(names, grads)),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "model": model, "steps": {}}
    for mb in MICRO:
        model = convert.lm_params_from_numpy(params, cfg, "cpu")
        step = make_train_step(cfg, micro_batch=mb, lr=LR)
        opt = adamw_init(model)
        for _ in range(STEPS):
            model, opt, _ = step(model, opt, batch)
        out["steps"][mb] = {"params": dict(model.named_parameters()),
                            "mu": opt["mu"], "nu": opt["nu"]}
    return out


@functools.lru_cache(maxsize=None)
def _jax(case):
    """JAX's loss, CE, aux and gradients (``lm_loss``), and its jitted
    ``make_train_step``'s three-step states, both micro_batch settings."""
    cfg_j, cfg = _configs(case)
    params = jax.tree.map(jnp.asarray, _port(case)["params"])
    batch = {"tokens": jnp.asarray(_tokens(cfg))}
    (loss, (ce, aux)), grads = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.lm_loss(p, batch, cfg_j), has_aux=True))(
            params)
    out = {"loss": float(loss), "ce": float(ce), "aux": float(aux),
           "grads": _flat(grads), "steps": {}}
    for mb in MICRO:
        fn = jax.jit(jstep.make_train_step(cfg_j, micro_batch=mb, lr=LR))
        p, o = params, joptim.adamw_init(params)
        for _ in range(STEPS):
            p, o, _ = fn(p, o, batch)
        out["steps"][mb] = {"params": _flat(p), "mu": _flat(o["mu"]),
                            "nu": _flat(o["nu"])}
    return out


@pytest.fixture(scope="module")
def runs():
    """Each world's gradients, its three-step states for each micro_batch
    and, at (2, 2), the gradients under each remat policy, per case.  The
    JAX references are computed on a thread meanwhile (the session mostly
    waits on its ranks)."""
    for case in CASES:
        _port(case)
    with ThreadPoolExecutor(1) as pool:
        jax_done = pool.submit(lambda: [_jax(case) for case in CASES])
        out = _worlds()
        jax_done.result()
    return out


def _worlds() -> dict:
    out = {}
    for d, m in WORLDS:
        mesh = make_lm_mesh(data=d, model=m, devices="cpu")
        lm = None
        try:
            for case in CASES:
                cfg = _configs(case)[1]
                params = _port(case)["params"]
                if lm is None:
                    lm = parallel.ShardedLM(cfg, mesh, params=params,
                                            mode="train")
                else:
                    lm.build(cfg, params=params)
                toks = _tokens(cfg)
                lm.train_init(lr=LR, micro_batch=0)
                stats, per = lm.grads(toks)
                run = {"stats": stats, "built": lm.built,
                       "grads": {r: o["grads"] for r, o in per.items()},
                       "steps": {}}
                for mb in MICRO:
                    lm.build(cfg, params=params)
                    lm.train_init(lr=LR, micro_batch=mb)
                    for i in range(STEPS):
                        st, per = lm.train_step(toks,
                                                return_state=i == STEPS - 1)
                    run["steps"][mb] = {k: {r: o[k] for r, o in per.items()}
                                        for k in ("params", "mu", "nu")}
                    run["steps"][mb]["stats"] = st
                if (d, m) == (2, 2):
                    run["policies"] = {}
                    for policy in POLICIES:
                        lm.build(cfg.with_(remat=policy), params=params)
                        lm.train_init(lr=LR)
                        run["policies"][policy] = {
                            r: o["grads"] for r, o in lm.grads(toks)[1].items()}
                out[(d, m), case] = run
        finally:
            if lm is not None:
                lm.close()
    return out


def _whole(per_rank: dict, mesh, cfg) -> dict:
    """Leaf name -> the whole array assembled from every rank's slice;
    slices that several ranks hold must agree bit for bit."""
    lm_mesh = make_lm_mesh(data=mesh[0], model=mesh[1], devices="cpu")
    out = {n: np.full(tuple(p.shape), np.nan, np.float32)
           for n, p in transformer.Transformer(cfg, "meta").named_parameters()}
    for r, leaves in per_rank.items():
        parts = parallel.rank_slices(cfg, lm_mesh, r)
        for n, v in leaves.items():
            part = parts[n]
            held = out[n][part]
            seen = ~np.isnan(held)
            assert np.array_equal(held[seen], v[seen]), \
                f"{n}: rank {r}'s replica differs"
            out[n][part] = v
    for n, v in out.items():
        assert not np.isnan(v).any(), f"{n}: part of it is on no rank"
    return out


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        err = float(np.abs(got[k] - w).max())
        bound = tol * float(np.abs(w).max()) + 1e-12
        assert err <= bound, f"{what} {k}: {err:.3g} > {bound:.3g}"


def _params_close(got: dict, want: dict, grads: dict) -> None:
    """tests/test_torch_train.py's comparison of an Adam step, over the
    three steps: tight where the first step's gradient is conditioned."""
    loose = 0
    for k, w in want.items():
        diff = np.abs(got[k] - np.asarray(w, np.float32))
        g = np.abs(np.asarray(grads[k], np.float32))
        conditioned = g >= 1e-2 * g.max()
        assert diff[conditioned].max(initial=0) <= CHAIN_PARAM_TOL * LR, k
        assert diff.max() <= 2 * LR * STEPS, k
        loose += int((diff[~conditioned] > 0.1 * LR).sum())
    assert loose <= 10, f"{loose} parameters beyond 0.1·lr"


def _np(tensors: dict) -> dict:
    return {n: t.detach().float().numpy() for n, t in tensors.items()}


def _as_jax(case, leaves: dict) -> dict:
    """Port leaves (name -> array) as JAX's flattened pytree."""
    model = _port(case)["model"]
    return _flat(convert.lm_params_to_numpy(
        model, {n: torch.from_numpy(v) for n, v in leaves.items()}))


@pytest.mark.parametrize("mesh,case", RUNS, ids=IDS)
def test_loss_and_gradient_slices_match_unsharded_and_jax(runs, mesh, case):
    run, ref, jref = runs[mesh, case], _port(case), _jax(case)
    cfg = _configs(case)[1]
    st = run["stats"]
    if mesh == (1, 1):
        assert [st[k] for k in ("loss", "ce", "aux")] == \
            [ref["metrics"][k] for k in ("loss", "ce", "aux")]
        for n, g in ref["grads"].items():
            assert np.array_equal(run["grads"][0][n], g.numpy()), n
        assert st["rounds"] == [0]
    for k in ("loss", "ce", "aux"):
        assert st[k] == pytest.approx(ref["metrics"][k], rel=LOSS_RTOL), k
        assert st[k] == pytest.approx(jref[k], rel=LOSS_RTOL), k
    got = _whole(run["grads"], mesh, cfg)
    _close(got, _np(ref["grads"]), GRAD_TOL, "grad vs port")
    _close(_as_jax(case, got), jref["grads"], JAX_TOL, "grad vs JAX")


@pytest.mark.parametrize("micro_batch", MICRO)
@pytest.mark.parametrize("mesh,case", RUNS, ids=IDS)
def test_params_and_adamw_slices_after_three_steps(runs, mesh, case,
                                                   micro_batch):
    """Three steps (one backward pass a step, or two microbatches of 2
    rows, each split over "data"): every rank's parameter, μ and ν slices
    against the unsharded port's (bit for bit at (1, 1)) and JAX's."""
    run, ref, jref = runs[mesh, case], _port(case), _jax(case)
    cfg = _configs(case)[1]
    got = {k: _whole(run["steps"][micro_batch][k], mesh, cfg)
           for k in ("params", "mu", "nu")}
    want = {k: _np(v) for k, v in ref["steps"][micro_batch].items()}
    if mesh == (1, 1):
        for k in got:
            for n, w in want[k].items():
                assert np.array_equal(got[k][n], w), (k, n)
    grads = _np(ref["grads"])
    for k in ("mu", "nu"):
        _close(got[k], want[k], CHAIN_MOMENT_TOL, f"{k} vs port")
        _close(_as_jax(case, got[k]), jref["steps"][micro_batch][k],
               CHAIN_MOMENT_TOL, f"{k} vs JAX")
    _params_close(got["params"], want["params"], grads)
    _params_close(_as_jax(case, got["params"]),
                  jref["steps"][micro_batch]["params"], _as_jax(case, grads))
    # the losses fall on the fixed batch
    assert run["steps"][micro_batch]["stats"]["loss"] < ref["metrics"]["loss"]


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_router_and_qk_norm_gradients_summed_once(runs, mesh):
    """The leaves held whole but used on a model rank's share of a region
    — the MoE's router (through its own experts' gates and the whole aux)
    and qwen3-32b's ``q_norm`` / ``k_norm`` (on its own heads) — are
    summed over the model axis once: each equal to the unsharded
    gradient, which no rank's own share is."""
    for case, leaves in (("moe", ("ffn.router",)),
                         ("qk", ("attn.q_norm", "attn.k_norm"))):
        run, ref = runs[mesh, case], _port(case)
        for layer in range(2):
            for leaf in leaves:
                name = f"blocks.{layer}.{leaf}"
                want = ref["grads"][name].numpy()
                for r, g in run["grads"].items():
                    err = np.abs(g[name] - want).max()
                    assert err <= GRAD_TOL * np.abs(want).max(), (name, r)


def test_moe_aux_is_the_whole_batchs(runs):
    """At (2, 1) each rank routes its 2 rows; its aux is the whole batch's
    (``me`` averaged over "data", ``ce`` from the gathered choices) — not
    its own rows', which the unsharded model gives a value of its own."""
    ref = _port("moe")
    st = runs[(2, 1), "moe"]["stats"]
    assert st["aux"] == pytest.approx(ref["metrics"]["aux"], rel=1e-6)
    model = ref["model"]
    with torch.no_grad():
        for half in (slice(0, 2), slice(2, 4)):
            toks = torch.from_numpy(_tokens(model.cfg)[half])
            _, (_, own) = transformer.lm_loss(model, {"tokens": toks})
            assert abs(float(own) - st["aux"]) > 1e-4 * st["aux"]


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_a_rank_holds_one_layers_gathered_weights_at_most(runs, mesh):
    """The FSDP products save the shard, not the gathered weight: the
    gathered weights alive on a rank peak under one layer's (or the
    embedding's or the head's) — its parameter bytes plus that — through
    a step's forward, remat and backward, not the whole model's."""
    d, m = mesh
    for case in CASES:
        cfg = _configs(case)[1]
        specs = parallel.train_specs(cfg, {"data": d, "model": m})
        sizes = {n: p.numel() * 4 // (m if "model" in specs[n] else 1)
                 for n, p in transformer.Transformer(cfg, "meta")
                 .named_parameters() if "data" in specs[n]}
        layer = sum(v for n, v in sizes.items() if n.startswith("blocks.0."))
        bound = max(layer, sizes.get("embed", 0), sizes.get("lm_head", 0))
        all_gathered = sum(sizes.values())
        run = runs[mesh, case]
        for stats in (run["stats"], *(s["stats"] for s in
                                      run["steps"].values())):
            peak = stats["gathered_peak_bytes"]
            assert all(0 < p <= bound < all_gathered for p in peak), \
                (case, peak, bound)
        full = sum(p.numel() * 4 for p in transformer.Transformer(
            cfg, "meta").parameters())
        for b in run["built"].values():
            assert b["param_bytes"] + max(run["stats"]["gathered_peak_bytes"]) \
                < full


def test_remat_policies_under_the_collectives_equal_unit(runs):
    """At (2, 2), "dots" and "attn_out" recompute what they do not save,
    collectives included, in the same order on every rank: every rank's
    gradients equal "unit"'s bit for bit."""
    for case in CASES:
        run = runs[(2, 2), case]
        for policy, per in run["policies"].items():
            for r, grads in per.items():
                for n, g in grads.items():
                    assert np.array_equal(g, run["grads"][r][n]), \
                        (case, policy, r, n)


def test_fsdp_matmul_saves_the_shard_only():
    """In one process, with a stand-in data axis of two ranks that hold
    the same shard: ``collectives.matmul`` frees every gathered weight
    after its use (the tracker's count falls back to 0), while the
    product of a gathered weight (``fsdp_gather``) keeps each layer's
    alive for the backward pass; both give the plain product's output."""

    class Pair:
        n_parties, party_index = 2, 0

        def all_gather_cat(self, t, dim):
            return torch.cat([t, t], dim)

        def reduce_scatter(self, t, dim):
            return t.narrow(dim, 0, t.shape[dim] // 2) * 2

    class Lin(torch.nn.Module):
        def __init__(self, shard):
            super().__init__()
            self.w = torch.nn.Parameter(shard)
            self.fsdp = collectives.FSDP(Pair(), {"w": 0})

    torch.manual_seed(0)
    mods = [Lin(torch.randn(4, 8)) for _ in range(3)]
    x = torch.randn(2, 5, 8, requires_grad=True)
    live = collectives.GATHERED
    for gathered in (False, True):
        base = live.live
        live.reset()
        h = x
        for mod in mods:
            h = (h @ collectives.weight(mod, "w") if gathered
                 else collectives.matmul(mod, "w", h))
        one = 8 * 8 * 4
        held = live.live - base
        assert held == (3 * one if gathered else 0)
        want = x
        for mod in mods:
            want = want @ torch.cat([mod.w, mod.w], 0)
        assert torch.allclose(h, want)
        h.sum().backward()
        assert live.live == base and live.peak - base <= \
            (3 * one if gathered else one)


def test_train_layouts_and_refusals():
    """``train_specs`` holds the serve layout's checks and adds the data
    axis (xlstm-350m's 4 SSM heads lay out in runs of whole heads at model
    = 8, zamba2-7b's 112 keep JAX's specs at (2, 2); glm4-9b's 2 kv heads
    at model = 4 keep JAX's spec, each head replicated on two ranks, their
    in-dim split over "data"; q heads that the model axis does not divide
    lay out in runs too, whisper-large-v3's 20 at model = 8 and glm4-9b's
    32 at 64, while a ``wk`` whose width does not divide raises (glm4-9b
    at 512); whisper's encoder and cross-attention lay out as a decoder
    block does at (2, 2)); the mode is checked before
    anything is spawned; alone on a (1, 1) mesh a train-mode model holds
    ``init_params``'s numbers."""
    _, cfg = _configs("moe")
    specs = parallel.train_specs(cfg, {"data": 2, "model": 2})
    assert specs["blocks.0.attn.wq"] == ("data", "model")
    assert specs["blocks.0.ffn.we_down"] == ("model", "data", None)
    assert specs["embed"] == ("model", "data")
    assert specs["blocks.0.ffn.router"] == ()
    parallel.train_specs(registry.get("xlstm-350m"), {"data": 1, "model": 8})
    zamba = parallel.train_specs(registry.get("zamba2-7b"),
                                 {"data": 2, "model": 2})
    assert zamba["blocks.0.core.in_proj"] == ("data", "model")
    whisper = registry.get("whisper-large-v3")
    specs = parallel.train_specs(whisper, {"data": 2, "model": 2})
    assert specs["enc_blocks.0.attn.wq"] == ("data", "model")
    assert specs["blocks.0.cross.wo"] == ("model", "data")
    parallel.train_specs(whisper, {"data": 1, "model": 8})
    glm = registry.get("glm4-9b")
    specs = parallel.train_specs(glm, {"data": 2, "model": 4})
    assert specs["blocks.0.attn.wk"] == ("data", "model")
    parts = parallel.rank_slices(glm, make_lm_mesh(data=2, model=4,
                                                   devices="cpu"), 7)
    assert parts["blocks.0.attn.wk"] == (slice(2048, 4096), slice(128, 256))
    parallel.train_specs(glm, {"data": 1, "model": 64})
    with pytest.raises(NotImplementedError, match="attn.wk"):
        parallel.train_specs(glm, {"data": 1, "model": 512})
    mesh = make_lm_mesh(data=1, model=1, devices="cpu")
    with pytest.raises(ValueError, match="mode"):
        parallel.ShardedLM(cfg, mesh, mode="infer")
    with pytest.raises(ValueError, match="mode"):
        parallel.shard_model(cfg, mesh, 0, mode="infer")
    part = parallel.shard_model(cfg, mesh, 0, seed=3, mode="train")
    whole = transformer.init_params(cfg, seed=3, device="cpu")
    for (n, a), (_, b) in zip(whole.named_parameters(),
                              part.named_parameters()):
        assert torch.equal(a, b), n

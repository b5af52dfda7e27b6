"""The sharded LM's last decoder-only layouts, and the encoder-decoder and
VLM, on gloo ranks, on the CPU.

``models/parallel.py::ShardedLM`` served and trained in the layouts the
JAX package's ``param_specs`` gives that the port refused before:

  * ``expert_data`` — the expert stacks' expert dim on "data", d_expert
    on "model": a rank runs its experts over every data shard's tokens
    and returns each shard its rows; reduced phi3.5-moe-42b-a6.6b (4
    experts) at (data, model) = (1, 1), (2, 1), (2, 2) and (2, 4), and
    reduced qwen2-moe-a2.7b cut to 3 experts at data = 2, which pads the
    stacks with a dead expert (ranks hold experts {0, 1} and {2, dead});
  * kv heads replicated past the model axis — the reduced configs' own 4
    q heads on 2 kv heads at model = 4: rank j holds q head j and kv head
    j // 2 whole; reduced qwen3-32b (qk_norm) and phi3.5-moe at (1, 4)
    and (2, 4);
  * the encoder-decoder and the VLM — reduced whisper-large-v3 (2
    encoder layers over 16 frames, each decoder block's cross-attention)
    and qwen2-vl-2b (8 patches through ``vision_proj``, M-RoPE) at (1, 1),
    (2, 2) and (1, 4), their 4 q heads on 2 kv heads replicated at model
    = 4 (the cross-attention's and the encoder's too), the stubs
    (``frames``, ``patches``) passed beside the tokens as ``extras``;
  * the recurrent families — reduced zamba2-7b (one pattern unit: 5
    Mamba2 layers and a use of the shared attention block, its 4 q heads
    on 2 kv heads replicated at model = 4) and xlstm-350m (an mLSTM and an
    sLSTM layer), 8 SSM heads at d 256, at (1, 1), (2, 2) and (1, 4): each
    rank holds its heads of every per-head leaf and Mamba2's B / C and
    mLSTM's ``xi`` columns whole, whose gradients the model axis sums; each
    rank's SSM cache is the slice of the unsharded cache that
    ``sharding.cache_specs`` places; zamba2's remat "dots" equals "unit"
    at (2, 2).

Each is held against the unsharded port holding the JAX package's
weights (one thread, as each rank runs) and against the JAX package, at
``tests/test_torch_parallel.py`` / ``test_torch_sharded_train.py``'s
bounds: (1, 1) bit for bit; elsewhere prefill logits within 1e-5 of
their largest magnitude, each rank's cache its kv head's (a
cross-attention layer's cross {k, v} too; an SSM layer's its heads),
greedy tokens equal to the unsharded port's and JAX's (JAX's ``prefill`` + ``decode_step`` loop with the stubs where
the model takes them: its ``serve_batch`` passes none); a step's loss, CE and aux within
rtol 1e-5, every gradient slice within 1e-5 of the leaf's largest
against the port and 1e-4 against JAX; three steps' parameters and μ / ν
as test_torch_sharded_train.py compares them.  Slices that several ranks
hold — a shared kv head, a leaf held whole — are equal bit for bit, the
gradients and the three steps' parameters, μ and ν alike.  No expert
stack is gathered over "data" under ``expert_data``.

One spawned world a mesh shape; ``ShardedLM.build`` rebuilds its ranks'
model for each case, layout and mode.
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
from repro.launch import serve as jserve
from repro.models import transformer as jtransformer
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import reduced
from repro_torch.launch import cases, serve
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import (collectives, parallel, sharding, ssm,
                                transformer)
from repro_torch.train import adamw_init
from repro_torch.train.step import accumulate_grads, make_train_step

CASES = {"phi": ("phi3.5-moe-42b-a6.6b", {}),
         "qwen2-pad": ("qwen2-moe-a2.7b", {"n_experts": 3}),
         "qwen3": ("qwen3-32b", {}),
         "whisper": ("whisper-large-v3", {}),
         "qwen2-vl": ("qwen2-vl-2b", {}),
         "zamba2": ("zamba2-7b", {}),
         "xlstm": ("xlstm-350m", {}),
         # head counts that model = 4 does not divide: whisper's 6 q heads
         # on 3 kv (rank 1's run straddles two kv heads' groups), qwen2-vl's
         # 3 on 1 (rank 0 holds no head), xLSTM's 6 SSM heads and its 2
         # (ranks 0 and 2 hold none, as xlstm-350m's 4 at model = 8)
         "whisper-6": ("whisper-large-v3", {"n_heads": 6, "n_kv_heads": 3}),
         "qwen2-vl-3": ("qwen2-vl-2b", {"n_heads": 3, "n_kv_heads": 1}),
         "xlstm-6": ("xlstm-350m", {"ssm_heads": 6, "ssm_expand": 3}),
         "xlstm-2": ("xlstm-350m", {"ssm_heads": 2})}
STUBBED = (("whisper", False), ("qwen2-vl", False))
RECURRENT = (("zamba2", False), ("xlstm", False))
UNEVEN = (("whisper-6", False), ("qwen2-vl-3", False), ("xlstm-6", False),
          ("xlstm-2", False))
STEPPED_FROM = RECURRENT + (("xlstm-6", False), ("xlstm-2", False))
# mesh -> the (case, expert_data) runs of its world: each served, a
# step's gradients, and three steps where STEPS_AT says
WORLDS = {(1, 1): (("phi", True),) + STUBBED + RECURRENT,
          (2, 1): (("phi", True), ("qwen2-pad", True)),
          (2, 2): (("phi", True),) + STUBBED + RECURRENT,
          (1, 4): ((("qwen3", False), ("phi", False)) + STUBBED + RECURRENT
                   + UNEVEN),
          (2, 4): (("qwen3", False), ("phi", True))}
STEPS_AT = {(1, 1), (2, 1), (2, 2), (1, 4)}
CONTRAST = (2, 1)          # and the default layout's gradients of "phi"
DROP = (2, 2)              # and "phi" at capacity 0.5 served, expert_data
POLICIES_AT = (2, 2)       # and these runs under these policies
POLICIES = {"whisper": ("dots", "attn_out"), "zamba2": ("dots",)}
RUNS = [(mesh, case, ed) for mesh, runs in WORLDS.items()
        for case, ed in runs]
IDS = [f"{d}x{m}-{case}{'-ed' if ed else ''}" for (d, m), case, ed in RUNS]
STEP_RUNS = [r for r in RUNS
             if r[0] in STEPS_AT and r[1:] not in STEPPED_FROM]
STEP_IDS = [i for r, i in zip(RUNS, IDS)
            if r[0] in STEPS_AT and r[1:] not in STEPPED_FROM]
FROM_RUNS = [r for r in RUNS if r[0] in STEPS_AT and r[1:] in STEPPED_FROM]
FROM_IDS = [i for r, i in zip(RUNS, IDS)
            if r[0] in STEPS_AT and r[1:] in STEPPED_FROM]
BATCH, PROMPT, MAX_NEW, CACHE_LEN = 4, 12, 8, 20
B, S, LR, STEPS = 4, 16, 3e-3, 3
TOL, GRAD_TOL, JAX_TOL, LOSS_RTOL = 1e-5, 1e-5, 1e-4, 1e-5
CHAIN_MOMENT_TOL, CHAIN_PARAM_TOL = 5e-3, 0.05     # the latter times lr
STACKS = {"we_gate", "we_up", "we_down"}


def _configs(case):
    arch, kw = CASES[case]
    return (jreduced(jregistry.get(arch)).with_(**kw),
            reduced(registry.get(arch)).with_(**kw))


def _prompts(cfg):
    return np.random.default_rng(7).integers(0, cfg.vocab, (BATCH, PROMPT))


def _tokens(cfg):
    return np.random.default_rng(11).integers(0, cfg.vocab, (B, S))


def _stubs(cfg, batch: int, seed: int) -> dict:
    """The modality stubs ``cfg`` takes (``frames``, ``patches``):
    N(0, 1)·0.1 in float32, as ``data/lm.py`` draws them; {} for a
    decoder-only model."""
    rng = np.random.default_rng(seed)
    shapes = {"frames": (batch, cfg.enc_frames, cfg.d_model)
              if cfg.enc_layers else None,
              "patches": (batch, cfg.n_patches, cfg.d_model)
              if cfg.n_patches else None}
    return {k: (rng.normal(size=shape) * 0.1).astype(np.float32)
            for k, shape in shapes.items() if shape}


def _prompt_stubs(cfg) -> dict:
    return _stubs(cfg, BATCH, 13)


def _batch_stubs(cfg) -> dict:
    return _stubs(cfg, B, 17)


def _torch(stubs: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in stubs.items()}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _np(tensors: dict) -> dict:
    return {n: t.detach().float().numpy() for n, t in tensors.items()}


@functools.lru_cache(maxsize=None)
def _port(case):
    """The JAX weights and the unsharded port on one thread: prefill
    logits and cache, greedy tokens, a step's gradients and metrics, the
    three-step state."""
    cfg_j, cfg = _configs(case)
    params = jax.tree.map(np.asarray,
                          jtransformer.init_params(jax.random.key(0), cfg_j))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = convert.lm_params_from_numpy(params, cfg, "cpu")
        prompts, stubs = _prompts(cfg), _torch(_prompt_stubs(cfg))
        logits, cache = model.prefill(torch.from_numpy(prompts),
                                      cache_len=CACHE_LEN, extras=stubs)
        tokens, _ = serve.serve_batch(cfg, model, prompts, MAX_NEW,
                                      CACHE_LEN, stubs)
        batch = {"tokens": torch.from_numpy(_tokens(cfg)),
                 **_torch(_batch_stubs(cfg))}
        names, grads, metrics = accumulate_grads(model, batch)
        out = {"params": params, "model": model, "logits": logits.numpy(),
               "cache": cache, "tokens": tokens,
               "grads": _np(dict(zip(names, grads))),
               "metrics": {k: float(v) for k, v in metrics.items()}}
        model = convert.lm_params_from_numpy(params, cfg, "cpu")
        step, opt = make_train_step(cfg, lr=LR), adamw_init(model)
        out["chain"] = []
        for k in range(STEPS):
            before = {"params": jax.tree.map(
                          np.copy, convert.lm_params_to_numpy(model)),
                      "opt": {"mu": _np(opt["mu"]), "nu": _np(opt["nu"]),
                              "step": k}}
            model, opt, metrics = step(model, opt, batch)
            out["chain"].append({
                "before": before, "loss": float(metrics["loss"]),
                "params": {n: v.copy() for n, v in
                           _np(dict(model.named_parameters())).items()},
                "mu": _np(opt["mu"]), "nu": _np(opt["nu"])})
        out["steps"] = {k: out["chain"][-1][k] for k in ("params", "mu",
                                                          "nu")}
    finally:
        torch.set_num_threads(threads)
    return out


def _jax_greedy(cfg_j, params, prompts, stubs) -> np.ndarray:
    """JAX's greedy tokens through its ``prefill`` + ``decode_step`` loop
    with the stubs (``serve_batch``'s loop; its ``serve_batch`` passes
    none)."""
    logits, cache = jax.jit(lambda p, t, e: jtransformer.prefill(
        p, t, cfg_j, e, cache_len=CACHE_LEN))(params, prompts, stubs)
    step = jax.jit(lambda p, c, t, pos: jtransformer.decode_step(
        p, c, t, pos, cfg_j))
    tok = jnp.argmax(logits, -1)[:, None]
    out = [tok]
    for i in range(MAX_NEW - 1):
        logits, cache = step(params, cache, tok,
                             jnp.int32(prompts.shape[1] + i))
        tok = jnp.argmax(logits, -1)[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, 1))


@functools.lru_cache(maxsize=None)
def _jax(case):
    """JAX's greedy tokens, ``lm_loss`` and gradients, and its jitted
    ``make_train_step``'s three-step state."""
    cfg_j, cfg = _configs(case)
    params = jax.tree.map(jnp.asarray, _port(case)["params"])
    stubs = _prompt_stubs(cfg)
    if stubs:
        jtokens = _jax_greedy(cfg_j, params, _prompts(cfg),
                              {k: jnp.asarray(v) for k, v in stubs.items()})
    else:
        jtokens, _ = jserve.serve_batch(cfg_j, params, _prompts(cfg),
                                        MAX_NEW, CACHE_LEN)
    batch = {"tokens": jnp.asarray(_tokens(cfg)),
             **{k: jnp.asarray(v) for k, v in _batch_stubs(cfg).items()}}
    (loss, (ce, aux)), grads = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.lm_loss(p, batch, cfg_j), has_aux=True))(
            params)
    fn = jax.jit(jstep.make_train_step(cfg_j, lr=LR))
    p, o = params, joptim.adamw_init(params)
    for _ in range(STEPS):
        p, o, _ = fn(p, o, batch)
    out = {"tokens": np.asarray(jtokens), "loss": float(loss),
           "ce": float(ce), "aux": float(aux), "grads": _flat(grads),
           "steps": {"params": _flat(p), "mu": _flat(o["mu"]),
                     "nu": _flat(o["nu"])}}
    if case in dict(STEPPED_FROM):    # a step from each of the port's states
        model, out["from"] = _port(case)["model"], []
        for link in _port(case)["chain"]:
            before = link["before"]
            o = {k: jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(
                model, {n: torch.from_numpy(v)
                        for n, v in before["opt"][k].items()}))
                 for k in ("mu", "nu")}
            o["step"] = jnp.int32(before["opt"]["step"])
            p, o, _ = fn(jax.tree.map(jnp.asarray, before["params"]), o,
                         batch)
            out["from"].append({"params": _flat(p), "mu": _flat(o["mu"]),
                                "nu": _flat(o["nu"])})
    return out


@pytest.fixture(scope="module")
def runs():
    """Each world's prefill, serving wave, gradients and (where STEPS_AT
    says) three-step state of each run; the JAX references on a thread
    meanwhile."""
    for case in CASES:
        _port(case)
    with ThreadPoolExecutor(1) as pool:
        jax_done = pool.submit(lambda: [_jax(case) for case in CASES])
        out = _worlds()
        jax_done.result()
    return out


def _worlds() -> dict:
    out = {}
    for (d, m), world in WORLDS.items():
        mesh = make_lm_mesh(data=d, model=m, devices="cpu")
        lm = None
        try:
            for case, ed in world:
                cfg, params = _configs(case)[1], _port(case)["params"]
                stubs, bstubs = _prompt_stubs(cfg), _batch_stubs(cfg)
                run = out[(d, m), case, ed] = {}
                if lm is None:
                    lm = parallel.ShardedLM(cfg, mesh, params=params,
                                            expert_data=ed)
                else:
                    lm.build(cfg, params=params, mode="serve", expert_data=ed)
                run["logits"], per = lm.prefill(_prompts(cfg), CACHE_LEN,
                                                return_cache=True,
                                                extras=stubs)
                run["caches"] = {r: o["cache"] for r, o in per.items()}
                run["tokens"], run["stats"] = lm.serve(
                    _prompts(cfg), MAX_NEW, CACHE_LEN, extras=stubs)
                run["odd"] = lm.prefill(
                    _prompts(cfg)[:3],
                    extras={k: v[:3] for k, v in stubs.items()})[0]
                lm.build(cfg, params=params, mode="train", expert_data=ed)
                lm.train_init(lr=LR)
                stats, per = lm.grads(_tokens(cfg), extras=bstubs)
                run["train"] = stats
                run["grads"] = {r: o["grads"] for r, o in per.items()}
                if (d, m) == POLICIES_AT and case in POLICIES:
                    run["policies"] = {}
                    for policy in POLICIES[case]:
                        lm.build(cfg.with_(remat=policy), params=params)
                        lm.train_init(lr=LR)
                        run["policies"][policy] = {
                            r: o["grads"] for r, o in
                            lm.grads(_tokens(cfg), extras=bstubs)[1].items()}
                if (d, m) in STEPS_AT and (case, ed) in STEPPED_FROM:
                    run["from"] = []
                    for link in _port(case)["chain"]:
                        lm.build(cfg, params=link["before"]["params"])
                        lm.train_init(lr=LR, state=link["before"]["opt"])
                        st, per = lm.train_step(_tokens(cfg),
                                                return_state=True)
                        run["from"].append({k: {r: o[k] for r, o in
                                                per.items()}
                                            for k in ("params", "mu", "nu")})
                        run["from"][-1]["stats"] = st
                elif (d, m) in STEPS_AT:
                    lm.build(cfg, params=params)
                    lm.train_init(lr=LR)
                    for i in range(STEPS):
                        st, per = lm.train_step(_tokens(cfg),
                                                return_state=i == STEPS - 1,
                                                extras=bstubs)
                    run["steps"] = {k: {r: o[k] for r, o in per.items()}
                                    for k in ("params", "mu", "nu")}
                    run["steps"]["stats"] = st
            if (d, m) == DROP:
                cfg = _configs("phi")[1].with_(moe_capacity=0.5)
                lm.build(cfg, params=_port("phi")["params"], mode="serve",
                         expert_data=True)
                out["drop"] = lm.prefill(_prompts(cfg))[0]
            if (d, m) == CONTRAST:
                lm.build(_configs("phi")[1], params=_port("phi")["params"],
                         expert_data=False)
                lm.train_init(lr=LR)
                out["contrast"] = lm.grads(_tokens(_configs("phi")[1]))[0]
        finally:
            if lm is not None:
                lm.close()
    return out


def _whole(per_rank: dict, mesh, cfg, ed) -> dict:
    """Leaf name -> the whole array assembled from every rank's slice;
    slices that several ranks hold must agree bit for bit."""
    lm_mesh = make_lm_mesh(data=mesh[0], model=mesh[1], devices="cpu")
    out = {n: np.full(tuple(p.shape), np.nan, np.float32)
           for n, p in transformer.Transformer(cfg, "meta").named_parameters()}
    for r, leaves in per_rank.items():
        parts = parallel.rank_slices(cfg, lm_mesh, r, expert_data=ed)
        for n, v in leaves.items():
            held = out[n][parts[n]]
            seen = ~np.isnan(held)
            assert np.array_equal(held[seen], v[seen]), \
                f"{n}: rank {r}'s replica differs"
            out[n][parts[n]] = v
    for n, v in out.items():
        assert not np.isnan(v).any(), f"{n}: part of it is on no rank"
    return out


def _close(got: dict, want: dict, tol: float, what: str) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        bound = tol * float(np.abs(w).max()) + 1e-12
        assert err <= bound, f"{what} {k}: {err:.3g} > {bound:.3g}"


def _params_close(got: dict, want: dict, grads: dict) -> None:
    """test_torch_sharded_train.py's comparison of three chained Adam
    steps: tight where the first step's gradient is conditioned."""
    loose = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        g = np.abs(grads[k])
        conditioned = g >= 1e-2 * g.max()
        assert diff[conditioned].max(initial=0) <= CHAIN_PARAM_TOL * LR, k
        assert diff.max() <= 2 * LR * STEPS, k
        loose += int((diff[~conditioned] > 0.1 * LR).sum())
    assert loose <= 10, f"{loose} parameters beyond 0.1·lr"


def _step_close(got: dict, want: dict, rms: dict) -> None:
    """One step's parameters from a shared state: within 0.05·lr where the
    step's √ν (the running RMS of the gradient) is at least 1e-2 of its
    leaf's largest, within 2·lr anywhere, and beyond 0.1·lr only where √ν
    is under 1e-5 of the leaf's largest — the near-zero gradients whose
    sign rounding decides, which Adam's g / (|g| + eps) turns into up to a
    whole step (zamba2: 25 such elements of 1.3 M between the port and JAX
    at (1, 1), at 7e-9–2.7e-6 of their leaves' largest)."""
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        g = np.abs(rms[k])
        assert diff[g >= 1e-2 * g.max()].max(initial=0) <= \
            CHAIN_PARAM_TOL * LR, k
        assert diff.max() <= 2 * LR, k
        assert (g[diff > 0.1 * LR] <= 1e-5 * g.max()).all(), k


def _as_jax(case, leaves: dict) -> dict:
    """Port leaves (name -> array) as JAX's flattened pytree."""
    return _flat(convert.lm_params_to_numpy(
        _port(case)["model"],
        {n: torch.from_numpy(v) for n, v in leaves.items()}))


def _kv(layer: dict) -> dict:
    """A layer's cached keys and values by name: the ring's k, v, and a
    cross-attention layer's cross k, v."""
    if "cross" not in layer:
        return {key: layer[key] for key in ("k", "v")}
    return {**{key: layer["self"][key] for key in ("k", "v")},
            **{f"cross {key}": layer["cross"][key] for key in ("k", "v")}}


def _placed(full: np.ndarray, spec: tuple, mesh, rank: int,
            heads: int) -> np.ndarray:
    """The part of a whole cache tensor that rank ``rank`` of ``mesh``
    holds: the data axis's contiguous chunk of the dim its spec
    (``sharding.cache_specs``) puts there, and the rank's run of
    ``heads`` (``parallel.head_run``) on the heads' dim (the conv state's
    d_inner) — where the model axis divides the heads, the dim the spec
    puts on "model"."""
    d, m = mesh
    dim = 1 if full.shape[1] == heads else full.ndim - 1
    if m > 1 and full.shape[dim] % m == 0:
        assert spec[dim] == "model", spec
    lo, hi = parallel.head_run(heads, rank % m, m)
    width = full.shape[dim] // heads
    index = [slice(None)] * full.ndim
    index[dim] = slice(lo * width, hi * width)
    if spec[0] == "data":
        n = full.shape[0]
        index[0] = slice(rank // m * n // d, (rank // m + 1) * n // d)
    return full[tuple(index)]


def _ssm_caches_placed(run, ref, mesh, cfg) -> None:
    """Each rank's recurrent caches against the slices of the unsharded
    caches that it holds: the batch's rows on "data", its heads (the conv
    state's channels of them) on "model"."""
    d, m = mesh
    for rank, cache in run["caches"].items():
        for got, full in zip(cache, ref["cache"]):
            if "k" in full or "self" in full:   # an attention layer's
                continue
            full = {k: v.numpy() for k, v in full.items()}
            specs = sharding.cache_specs(full, BATCH, {"data": d,
                                                       "model": m})
            assert got.keys() == full.keys()
            for key, g in got.items():
                w = _placed(full[key], specs[key], mesh, rank,
                            cfg.n_ssm_heads)
                assert g.shape == w.shape, key
                if mesh == (1, 1):
                    assert np.array_equal(g, w), key
                assert (np.abs(g - w).max(initial=0)
                        <= TOL * np.abs(w).max(initial=0)), key


@pytest.mark.parametrize("mesh,case,ed", RUNS, ids=IDS)
def test_prefill_and_caches_equal_unsharded(runs, mesh, case, ed):
    """Logits against the unsharded port (bit for bit at (1, 1), within
    1e-5 of the largest elsewhere), also on a batch of 3 that does not
    split over "data"; each rank's cache holds its rows and its kv heads —
    every kv head its q heads read (``parallel.kv_run``), none where it
    holds no q head — its cross k, v (the encoder's frames through its
    share of ``wk`` / ``wv``) too."""
    run, ref = runs[mesh, case, ed], _port(case)
    cfg = _configs(case)[1]
    want = ref["logits"]
    if mesh == (1, 1):
        assert np.array_equal(run["logits"], want)
    err = np.abs(run["logits"] - want).max()
    assert err <= TOL * np.abs(want).max(), err
    assert run["odd"].shape == (3, cfg.vocab)
    assert np.abs(run["odd"] - want[:3]).max() <= TOL * np.abs(want).max()
    d, m = mesh
    rows = BATCH // d
    _ssm_caches_placed(run, ref, mesh, cfg)
    for rank, cache in run["caches"].items():
        di, mi = divmod(rank, m)
        first, last = parallel.kv_run(cfg, mi, m)
        for got, full in zip(cache, ref["cache"]):
            if "k" not in full and "self" not in full:
                continue                        # a recurrent layer's
            got, full = _kv(got), _kv(full)
            assert got.keys() == full.keys()
            for key, g in got.items():
                w = full[key][di * rows:(di + 1) * rows, :,
                              first:last].numpy()
                assert g.shape == w.shape
                assert (np.abs(g - w).max(initial=0)
                        <= TOL * np.abs(w).max(initial=0)), key


def test_expert_data_keeps_the_unsharded_slots_when_capacity_drops(runs):
    """At capacity 0.5 routing drops assignments: under ``expert_data`` at
    (2, 2) each rank's slot table, over the whole batch, keeps exactly the
    unsharded model's slots of its experts, so the logits agree (a slot
    kept or dropped otherwise moves them by far more than 1e-5)."""
    cfg = _configs("phi")[1].with_(moe_capacity=0.5)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = convert.lm_params_from_numpy(_port("phi")["params"], cfg,
                                             "cpu")
        want = model.prefill(torch.from_numpy(_prompts(cfg)))[0].numpy()
        full = _port("phi")["logits"]
    finally:
        torch.set_num_threads(threads)
    assert np.abs(want - full).max() > 1e-3 * np.abs(full).max()
    err = np.abs(runs["drop"] - want).max()
    assert err <= TOL * np.abs(want).max(), err


@pytest.mark.parametrize("mesh,case,ed", RUNS, ids=IDS)
def test_greedy_tokens_equal_unsharded_and_jax(runs, mesh, case, ed):
    run = runs[mesh, case, ed]
    assert np.array_equal(run["tokens"], _port(case)["tokens"])
    assert np.array_equal(run["tokens"], _jax(case)["tokens"])
    assert run["stats"]["logits_finite"]


@pytest.mark.parametrize("mesh,case,ed", RUNS, ids=IDS)
def test_loss_and_gradient_slices_match_unsharded_and_jax(runs, mesh, case,
                                                          ed):
    run, ref, jref = runs[mesh, case, ed], _port(case), _jax(case)
    cfg = _configs(case)[1]
    st = run["train"]
    if mesh == (1, 1):
        assert [st[k] for k in ("loss", "ce", "aux")] == \
            [ref["metrics"][k] for k in ("loss", "ce", "aux")]
        for n, g in ref["grads"].items():
            assert np.array_equal(run["grads"][0][n], g), n
    for k in ("loss", "ce", "aux"):
        assert st[k] == pytest.approx(ref["metrics"][k], rel=LOSS_RTOL), k
        assert st[k] == pytest.approx(jref[k], rel=LOSS_RTOL), k
    got = _whole(run["grads"], mesh, cfg, ed)
    _close(got, ref["grads"], GRAD_TOL, "grad vs port")
    _close(_as_jax(case, got), jref["grads"], JAX_TOL, "grad vs JAX")


@pytest.mark.parametrize("mesh,case,ed", STEP_RUNS, ids=STEP_IDS)
def test_params_and_adamw_slices_after_three_steps(runs, mesh, case, ed):
    """Three steps: every rank's parameter, μ and ν slices against the
    unsharded port's (bit for bit at (1, 1)) and JAX's; the copies of a
    leaf that several ranks hold (a shared kv head among them) bit-equal
    (``_whole``)."""
    run, ref, jref = runs[mesh, case, ed], _port(case), _jax(case)
    cfg = _configs(case)[1]
    got = {k: _whole(run["steps"][k], mesh, cfg, ed)
           for k in ("params", "mu", "nu")}
    want = ref["steps"]
    if mesh == (1, 1):
        for k in got:
            for n, w in want[k].items():
                assert np.array_equal(got[k][n], w), (k, n)
    for k in ("mu", "nu"):
        _close(got[k], want[k], CHAIN_MOMENT_TOL, f"{k} vs port")
        _close(_as_jax(case, got[k]), jref["steps"][k], CHAIN_MOMENT_TOL,
               f"{k} vs JAX")
    _params_close(got["params"], want["params"], ref["grads"])
    _params_close(_as_jax(case, got["params"]), jref["steps"]["params"],
                  _as_jax(case, ref["grads"]))
    assert run["steps"]["stats"]["loss"] < ref["metrics"]["loss"]


@pytest.mark.parametrize("mesh,case,ed", FROM_RUNS, ids=FROM_IDS)
def test_recurrent_steps_from_the_ports_states(runs, mesh, case, ed):
    """The recurrent models' three steps, each from the unsharded port's
    parameters and moments before it (``train_init(state=...)`` slices the
    whole moments as the weights are sliced), as tests/test_torch_ssm.py
    and test_torch_hybrid.py hold the port's steps against JAX's: chained
    independently, float32 rounding in these models' near-zero gradients
    grows through Adam's g / (|g| + eps) past the chained bounds within
    three steps — the unsharded port's own chain moves so under its
    weights scaled by (1 + 3e-8·N(0, 1)).  Each step's loss (rtol 1e-5),
    parameters, μ and ν against the port's next state (bit for bit at (1,
    1)) and JAX's step from the same state: μ and ν at the bounds of
    :func:`test_params_and_adamw_slices_after_three_steps`, the parameters
    by :func:`_step_close`."""
    run, ref, jref = runs[mesh, case, ed], _port(case), _jax(case)
    cfg = _configs(case)[1]
    assert len(run["from"]) == len(ref["chain"]) == STEPS
    for k, (got_k, link, jlink) in enumerate(zip(run["from"], ref["chain"],
                                                 jref["from"])):
        got = {key: _whole(got_k[key], mesh, cfg, ed)
               for key in ("params", "mu", "nu")}
        if mesh == (1, 1):
            for key in got:
                for n, w in link[key].items():
                    assert np.array_equal(got[key][n], w), (k, key, n)
        assert got_k["stats"]["loss"] == pytest.approx(link["loss"],
                                                       rel=LOSS_RTOL), k
        for key in ("mu", "nu"):
            _close(got[key], link[key], CHAIN_MOMENT_TOL, f"{k} {key} vs port")
            _close(_as_jax(case, got[key]), jlink[key], CHAIN_MOMENT_TOL,
                   f"{k} {key} vs JAX")
        rms = {n: np.sqrt(v) for n, v in link["nu"].items()}
        _step_close(got["params"], link["params"], rms)
        _step_close(_as_jax(case, got["params"]), jlink["params"],
                    _as_jax(case, rms))
    assert ref["chain"][-1]["loss"] < ref["chain"][0]["loss"]


def _shared_kv_heads_equal(runs, mesh, case) -> None:
    """At model = 4 each kv head is held by two ranks: their weights,
    gradients and (after three steps, where run) parameters, μ and ν of
    every ``wk`` / ``wv`` leaf bit-equal, the gradient within the bounds of
    the unsharded head's."""
    d, m = mesh
    ed = (case, True) in WORLDS[mesh]
    run, ref = runs[mesh, case, ed], _port(case)
    cfg = _configs(case)[1]
    assert parallel.kv_replicas(cfg, m) == 2
    states = [run["grads"]]
    if "steps" in run:
        states += [run["steps"][k] for k in ("params", "mu", "nu")]
    leaves = [n for n in ref["grads"] if n.rpartition(".")[2] in ("wk", "wv")]
    assert len(leaves) == 2 * (cfg.n_layers * (2 if cfg.enc_layers else 1)
                               + cfg.enc_layers)
    for per in states:
        for di in range(d):
            for pair in ((0, 1), (2, 3)):
                a, b = (per[di * m + j] for j in pair)
                for n in leaves:
                    assert a[n].shape[-1] == cfg.head_dim
                    assert np.array_equal(a[n], b[n]), (case, n, pair)
    got = _whole(run["grads"], mesh, cfg, ed)
    for n in leaves:
        w = ref["grads"][n]
        assert np.abs(got[n] - w).max() <= GRAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("mesh", [(1, 4), (2, 4)])
def test_shared_kv_heads_bit_equal_on_their_ranks(runs, mesh):
    """A kv head that two model ranks share: both hold the same weights
    of it, and the same gradient (its two q heads' parts summed over the
    pair only) — and, after three steps, the same weights, μ and ν — bit
    for bit, each equal to the unsharded head's within the bounds."""
    for case in ("qwen3", "phi"):
        _shared_kv_heads_equal(runs, mesh, case)


@pytest.mark.parametrize("case", ["whisper", "qwen2-vl"])
def test_encdec_and_vlm_shared_kv_heads_bit_equal(runs, case):
    """At (1, 4) whisper's 2 kv heads — of every self-attention, the
    encoder's and each cross-attention's — and qwen2-vl's are each held by
    two ranks, bit-equal there through the gradients and three steps."""
    _shared_kv_heads_equal(runs, (1, 4), case)


def test_encoder_remat_policies_under_the_collectives_equal_unit(runs):
    """At (2, 2) whisper's encoder blocks, like its decoder blocks, are
    checkpointed with their collectives inside: under "dots" and
    "attn_out" every rank's gradients equal "unit"'s bit for bit."""
    run = runs[POLICIES_AT, "whisper", False]
    assert set(run["policies"]) == {"dots", "attn_out"}
    for policy, per in run["policies"].items():
        for r, grads in per.items():
            for n, g in grads.items():
                assert np.array_equal(g, run["grads"][r][n]), (policy, r, n)


def test_hybrid_remat_dots_under_the_collectives_equals_unit(runs):
    """At (2, 2) zamba2's pattern unit (5 Mamba2 layers and the shared
    attention block) is checkpointed with its collectives inside — the
    ``out_norm`` statistics' sums among them: under "dots" every rank's
    gradients equal "unit"'s bit for bit."""
    run = runs[POLICIES_AT, "zamba2", False]
    assert set(run["policies"]) == {"dots"}
    for r, grads in run["policies"]["dots"].items():
        assert grads.keys() == run["grads"][r].keys()
        for n, g in grads.items():
            assert np.array_equal(g, run["grads"][r][n]), (r, n)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_recurrent_shared_columns_summed_once(runs, mesh):
    """Mamba2's B and C columns and mLSTM's ``xi`` columns of ``in_proj``
    are held whole on every model rank, each rank's gradient of them from
    its own heads only: summed over "model" exactly once, every rank holds
    the unsharded gradient of those columns (twice, or not at all, would
    be off by a whole gradient); the rank's own z / x / dt columns are
    its heads' slices."""
    d, m = mesh
    for case, layer in (("zamba2", 0), ("xlstm", 0)):
        cfg = _configs(case)[1]
        di, n = cfg.d_inner, cfg.ssm_state
        whole = (np.arange(2 * di, 2 * di + 2 * n) if case == "zamba2"
                 else np.arange(di))
        name = f"blocks.{layer}.core.in_proj"
        want = _port(case)["grads"][name]
        lm_mesh = make_lm_mesh(data=d, model=m, devices="cpu")
        replicas = []
        for r, grads in runs[mesh, case, False]["grads"].items():
            rows, cols = parallel.rank_slices(cfg, lm_mesh, r)[name]
            assert set(whole) <= set(cols) and len(cols) < want.shape[1]
            shared = np.isin(cols, whole)
            got = grads[name][:, shared]
            w = want[rows][:, whole]
            assert np.abs(got - w).max() <= GRAD_TOL * np.abs(want).max(), \
                (case, r)
            if rows == slice(0, cfg.d_model // d) or d == 1:
                replicas.append(got)
        assert all(np.array_equal(replicas[0], g) for g in replicas[1:])


def test_out_norm_statistic_sums_both_ways():
    """The recurrent blocks' ``out_norm`` over a d_inner split on four
    model ranks (threads with a stand-in comm): each rank's output and
    its input's gradient equal ``rmsnorm``'s on the whole, its channels of
    them — the statistic's sum (``collectives.all_sum``) carries every
    rank's part of the gradient back to every rank; an identity backward
    leaves each rank its own part only and fails here."""
    import threading
    m, di = 4, 64
    barrier = threading.Barrier(m)
    slots: list = [None] * m

    class Ranks:
        n_parties = m

        def __init__(self, j):
            self.party_index = j

        def all_reduce(self, t):
            slots[self.party_index] = t.detach().clone()
            barrier.wait()
            out = sum(slots[1:], slots[0].clone())
            barrier.wait()
            return out

    gen = torch.Generator().manual_seed(2)
    y = torch.randn(2, 5, di, generator=gen)
    scale = torch.rand(di, generator=gen) + 0.5
    g_out = torch.randn(2, 5, di, generator=gen)
    cfg = reduced(registry.get("zamba2-7b")).with_(ssm_expand=1,
                                                   d_model=di)
    assert cfg.d_inner == di
    whole = y.clone().requires_grad_()
    want = ssm.rmsnorm(whole, scale, cfg.norm_eps)
    (want * g_out).sum().backward()
    got = [None] * m

    def rank(j):
        part = slice(j * di // m, (j + 1) * di // m)
        core = ssm.Mamba2.__new__(ssm.Mamba2)
        torch.nn.Module.__init__(core)
        core.out_norm = torch.nn.Parameter(scale[part].clone())
        core.tp = Ranks(j)
        x = y[..., part].clone().requires_grad_()
        out = ssm._out_norm(core, x, cfg)
        (out * g_out[..., part]).sum().backward()
        got[j] = (out.detach(), x.grad)

    threads = [threading.Thread(target=rank, args=(j,)) for j in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = torch.cat([g[0] for g in got], -1)
    grad = torch.cat([g[1] for g in got], -1)
    assert (out - want.detach()).abs().max() <= 1e-6 * want.abs().max()
    assert (grad - whole.grad).abs().max() <= 1e-6 * whole.grad.abs().max()
    assert collectives.all_sum(y, None) is y


def test_encdec_and_vlm_train_with_their_stubs(runs):
    """The stubs reach the ranks' training batches: at (2, 2) each run's
    loss is the unsharded port's and JAX's with the stubs and differs from
    the loss with zero stubs; every gradient of ``vision_proj`` and of the
    encoder is a slice of the unsharded one (each model rank's columns of
    ``vision_proj``, each data rank's rows of them)."""
    for case in ("whisper", "qwen2-vl"):
        cfg = _configs(case)[1]
        st = runs[(2, 2), case, False]["train"]
        zero = {k: torch.zeros_like(v) for k, v in
                _torch(_batch_stubs(cfg)).items()}
        with torch.no_grad():
            loss, _ = transformer.lm_loss(_port(case)["model"], {
                "tokens": torch.from_numpy(_tokens(cfg)), **zero})
        assert abs(float(loss) - st["loss"]) > 1e-4 * abs(st["loss"])
        assert st["loss"] == pytest.approx(_jax(case)["loss"], rel=LOSS_RTOL)
        mesh = make_lm_mesh(data=2, model=2, devices="cpu")
        leaf = "vision_proj" if cfg.n_patches else "enc_blocks.0.attn.wq"
        for r, g in runs[(2, 2), case, False]["grads"].items():
            part = parallel.rank_slices(cfg, mesh, r)[leaf]
            assert g[leaf].shape == (cfg.d_model // 2, cfg.d_model // 2)
            w = _port(case)["grads"][leaf][part]
            assert np.abs(g[leaf] - w).max() <= GRAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2), (2, 4)])
def test_expert_stacks_not_gathered_over_data(runs, mesh):
    """Under ``expert_data`` a rank's FSDP gathers (``collectives.
    GATHERED``'s names) name no expert stack, and it holds 1 / data of the
    experts, its share of d_expert; the default layout at (2, 1) gathers
    every stack."""
    d, m = mesh
    for case, ed in WORLDS[mesh]:
        if not ed:
            continue
        run = runs[mesh, case, ed]
        cfg = _configs(case)[1]
        st = run["train"]
        assert all(not set(names) & STACKS for names in
                   st["gathered_leaves"]), st["gathered_leaves"]
        assert all(names for names in st["gathered_leaves"])
        e_loc = -(-cfg.n_experts // d)
        for r, g in run["grads"].items():
            held = g["blocks.0.ffn.we_gate"]
            di = r // m
            live = min(e_loc, cfg.n_experts - di * e_loc)
            assert held.shape == (live, cfg.d_model, cfg.d_expert // m)
    default = runs["contrast"]
    assert all(STACKS <= set(names) for names in default["gathered_leaves"])


@pytest.mark.parametrize("case", ["whisper", "qwen2-vl"])
def test_encdec_and_vlm_from_the_seed_are_the_unsharded_models(case):
    """Drawn from a seed rather than handed JAX's weights, alone on a (1,
    1) mesh, whisper's and qwen2-vl's shares in both modes hold
    ``init_params``'s numbers: the encoder blocks, the cross-attention and
    ``vision_proj`` among them."""
    cfg = _configs(case)[1]
    whole = transformer.init_params(cfg, seed=5, device="cpu")
    mesh = make_lm_mesh(data=1, model=1, devices="cpu")
    for mode in ("serve", "train"):
        part = parallel.shard_model(cfg, mesh, 0, seed=5, mode=mode)
        names = [n for n, _ in part.named_parameters()]
        assert names == [n for n, _ in whole.named_parameters()]
        assert any(n.startswith("enc_blocks.") or n == "vision_proj"
                   for n in names)
        for (n, a), (_, b) in zip(whole.named_parameters(),
                                  part.named_parameters()):
            assert torch.equal(a, b), (mode, n)


def test_padded_experts_are_dead_and_zero():
    """qwen2-moe with 3 experts at data = 2: the stacks split as 4 (GSPMD's
    padding), rank 1 holds expert 2 and one dead expert of zeros that no
    token is routed to; ``rank_slices`` places the live ones only, and a
    leaf that no axis divides is refused rather than cut."""
    cfg = _configs("qwen2-pad")[1]
    mesh = make_lm_mesh(data=2, model=1, devices="cpu")
    whole = transformer.init_params(cfg, seed=4, device="cpu")
    specs = parallel.serve_specs(cfg, {"data": 2, "model": 1},
                                 expert_data=True)
    assert specs["blocks.0.ffn.we_up"] == ("data", None, "model")
    slices = parallel.rank_slices(cfg, mesh, 1, mode="serve",
                                  expert_data=True)
    assert slices["blocks.0.ffn.we_up"][0] == slice(2, 3)
    layout = parallel._layout(cfg, specs, {"data": (1, 2), "model": (0, 1)})
    part = parallel._take(whole.get_parameter("blocks.0.ffn.we_up"),
                          layout["blocks.0.ffn.we_up"])
    assert part.shape == (2, cfg.d_model, cfg.d_expert)
    assert torch.equal(part[0], whole.blocks[0].ffn.we_up[2])
    assert not part[1].any()
    with pytest.raises(ValueError, match="does not split"):
        parallel._slices("blocks.0.attn.wq", (None, "model"), (256, 256),
                         {"model": (0, 3)})


@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("expert_data", [False, True])
@pytest.mark.parametrize("sizes", [(1, 2), (1, 4), (2, 2), (1, 8), (1, 16)])
def test_decoder_only_configs_shard_at_every_probed_mesh(mode, expert_data,
                                                         sizes):
    """The six decoder-only configs at full size lay out at (1, 2), (1,
    4), (2, 2), (1, 8) and (1, 16), both layouts, both modes: the specs
    raise nothing and every rank's slices cover every leaf; so do
    whisper-large-v3 and qwen2-vl-2b, their 20 and 12 q heads in uneven
    runs of whole heads at model = 8 and 16 (qwen2-vl's 12 leave 4 ranks
    without a head at 16), and the recurrent configs, zamba2-7b (112
    heads) and xlstm-350m (4 heads: at model = 8 and 16 half and three
    quarters of the ranks hold none).  Every rank holds at most ⌈H/m⌉ q
    heads; a recurrent core's leaves are covered by its ranks' heads
    exactly once over the model axis, but for the columns every head
    reads (Mamba2's B and C, mLSTM's ``xi``), which each model rank
    holds."""
    d, m = sizes
    axis = {"data": d, "model": m}
    for arch in ("internlm2-1.8b", "qwen3-32b", "mistral-nemo-12b",
                 "glm4-9b", "phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b",
                 "whisper-large-v3", "qwen2-vl-2b", "zamba2-7b",
                 "xlstm-350m"):
        cfg = registry.get(arch)
        specs = parallel.SPECS[mode](cfg, axis, expert_data)
        layouts = [parallel._layout(cfg, specs, {"data": (r // m, d),
                                                 "model": (r % m, m)})
                   for r in range(d * m)]
        assert all(lay.keys() == specs.keys() for lay in layouts)
        most = -(-cfg.n_heads // m) * cfg.head_dim
        assert all(parallel._extent(lay["blocks.0.attn.wq"],
                                    (cfg.d_model, cfg.n_heads * cfg.head_dim)
                                    )[1] <= most
                   for lay in layouts if "blocks.0.attn.wq" in lay)
        if cfg.n_ssm_heads > 1 and arch in ("zamba2-7b", "xlstm-350m"):
            _cores_covered(cfg, layouts[:m])


# the dim of each recurrent leaf that its model ranks split by heads
HEAD_DIM = {"in_proj": 1, "w_in": 1, "wq": 1, "wk": 1, "wi": 1, "wf": 1,
            "conv": 1, "r": 1, "a_log": 0, "dt_bias": 0, "d_skip": 0,
            "out_norm": 0, "out_proj": 0, "in_norm": 0}


def _cores_covered(cfg, layouts: list) -> None:
    """The model ranks' indices of the leaves of each kind of recurrent
    core cover the head dim: the per-head parts once, the shared columns
    (and sLSTM's ``in_norm``) on every rank."""
    meta = dict(transformer.Transformer(cfg, "meta").named_parameters())
    m = len(layouts)
    first = {kind: transformer.layer_kinds(cfg).index(kind)
             for kind in set(cfg.pattern) & set(ssm.CORES)}
    for kind, layer in first.items():
        for name, p in meta.items():
            if not name.startswith(f"blocks.{layer}.core."):
                continue
            leaf = name.rpartition(".")[2]
            dim = HEAD_DIM[leaf]
            seen = np.zeros(p.shape[dim], int)
            for lay in layouts:
                seen[np.arange(seen.size)[lay[name][dim]]] += 1
            want = np.ones_like(seen)
            if leaf == "in_norm":
                want[:] = m
            elif leaf == "in_proj":
                di, n = cfg.d_inner, cfg.ssm_state
                want[np.arange(2 * di, 2 * di + 2 * n) if kind == "mamba2"
                     else np.arange(di)] = m
            assert np.array_equal(seen, want), name


@pytest.mark.parametrize("case,ed", WORLDS[(2, 2)],
                         ids=[c for c, _ in WORLDS[(2, 2)]])
def test_dry_run_comms_count_what_the_ranks_sent(runs, case, ed):
    """The dry run's fake comms (``launch/cases.py``, on fake tensors)
    tally for a rank's training step the rounds and the bytes sent and
    received that the (2, 2) gloo world's ``DistComm`` counted for that
    rank's step (its ``grads``: every collective of the forward, the
    backward and the reductions; AdamW has none)."""
    run, cfg = runs[(2, 2), case, ed], _configs(case)[1]
    step = cases.Case(case, cases.InputShape("t", "train", S, B), cfg,
                      make_lm_mesh(data=2, model=2, devices="cpu"), "train",
                      0, ed)
    for rank in (0, 3):
        coll = step.run(rank, exact=True).roofline.coll_detail
        got = [sum(d[k] for d in coll.values())
               for k in ("count", "bytes_sent", "bytes_received")]
        assert got == [run["train"][k][rank] for k in
                       ("rounds", "bytes_sent", "bytes_received")], rank


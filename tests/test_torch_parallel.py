"""The port's tensor- and expert-parallel LM on gloo ranks, on the CPU.

``models/parallel.py::ShardedLM`` — one process a rank of a ("data",
"model") mesh, each holding its ``shard_model`` slices of the JAX
package's weights (``init_params(key 0)``, carried by
``convert.lm_param_leaves``) — against the unsharded port holding the
same weights, and against the JAX package's ``serve_batch``:

  * at (data, model) = (1, 1) every collective is over a group of one:
    logits and caches ``torch.equal`` to the unsharded port's (which runs
    on one thread here, as each rank does, so that CPU reductions sum in
    the same order);
  * at (1, 2), (1, 4) and (2, 2): logits within 1e-5 of their largest
    magnitude (the model axis's all-reduce sums in an order of its own),
    each rank's cache equal, within the same bound, to its kv heads of
    the unsharded cache, and the greedy tokens of an 8-step serving wave
    equal to the unsharded port's and to JAX's.

The configurations are the reduced phi3.5-moe-42b-a6.6b and qwen3-32b
(qk_norm), and at (1, 2) the reduced qwen2-vl-2b, whose 8 patches go
through ``vision_proj`` split on its columns and gathered (its stubs
passed as ``extras``; JAX's tokens through its ``prefill`` +
``decode_step`` loop, since its ``serve_batch`` passes no stubs), and
the reduced zamba2-7b and xlstm-350m, 4 of their 8 SSM heads a rank
(each rank's recurrent cache the slice of the unsharded one that
``sharding.cache_specs`` places: its heads, the conv state's channels).
The reduced phi3.5-moe is widened from 4 q heads on 2 kv heads
to 8 on 4, so that model = 4 splits its kv heads (its 4 experts put one on
each rank); the reduced qwen3-32b keeps its 2 kv heads, and a copy widened
the same way runs at model = 4 (the unwidened configs, whose kv heads are
replicated there, are tests/test_torch_sharded_layouts.py's).  A copy of
the widened phi3.5-moe with capacity 0.5 drops assignments, so routing
over the whole batch (the data axis's gather) is what keeps it equal.
Spawned worlds: one per mesh shape, each rebuilding its ranks' model for
every case.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import reduced
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import parallel, sharding

WIDE = {"n_heads": 8, "n_kv_heads": 4}
CASES = {"phi": ("phi3.5-moe-42b-a6.6b", WIDE),
         "phi-drop": ("phi3.5-moe-42b-a6.6b", dict(WIDE, moe_capacity=0.5)),
         "qwen3": ("qwen3-32b", {}),
         "qwen3-wide": ("qwen3-32b", WIDE),
         "qwen2-vl": ("qwen2-vl-2b", {}),
         "zamba2": ("zamba2-7b", {}),
         "xlstm": ("xlstm-350m", {})}
WORLDS = {(1, 1): ("phi", "qwen3"),
          (1, 2): ("phi", "qwen3", "qwen2-vl", "zamba2", "xlstm"),
          (1, 4): ("phi", "phi-drop", "qwen3-wide"),
          (2, 2): ("phi", "phi-drop", "qwen3")}
RUNS = [(mesh, case) for mesh, cases in WORLDS.items() for case in cases]
IDS = [f"{d}x{m}-{case}" for (d, m), case in RUNS]
BF16_AT = (1, 2)           # and reduced zamba2 in bf16, from a seed
BATCH, PROMPT, MAX_NEW, CACHE_LEN = 4, 12, 8, 20
TOL = 1e-5


def _configs(case):
    arch, kw = CASES[case]
    return (jreduced(jregistry.get(arch)).with_(**kw),
            reduced(registry.get(arch)).with_(**kw))


def _prompts(cfg):
    return np.random.default_rng(7).integers(0, cfg.vocab, (BATCH, PROMPT))


def _patches(cfg) -> dict:
    """A VLM's ``patches`` stub for the prompts, N(0, 1)·0.1 in float32;
    {} for a model without patches."""
    if not cfg.n_patches:
        return {}
    rng = np.random.default_rng(13)
    return {"patches": (rng.normal(size=(BATCH, cfg.n_patches, cfg.d_model))
                        * 0.1).astype(np.float32)}


def _jax_greedy(cfg_j, params, prompts, stubs) -> np.ndarray:
    """JAX's ``serve_batch`` loop (``prefill``, then ``decode_step``) with
    the stubs, which its ``serve_batch`` does not pass."""
    logits, cache = jtransformer.prefill(params, prompts, cfg_j, stubs,
                                         cache_len=CACHE_LEN)
    tok = jnp.argmax(logits, -1)[:, None]
    out = [tok]
    for i in range(MAX_NEW - 1):
        logits, cache = jtransformer.decode_step(
            params, cache, tok, jnp.int32(prompts.shape[1] + i), cfg_j)
        tok = jnp.argmax(logits, -1)[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, 1))


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The JAX weights, the unsharded port's prefill (one thread) and
    tokens, and JAX's tokens."""
    cfg_j, cfg = _configs(case)
    params = jax.tree.map(np.asarray,
                          jtransformer.init_params(jax.random.key(0), cfg_j))
    model = convert.lm_params_from_numpy(params, cfg, "cpu")
    prompts, stubs = _prompts(cfg), _patches(cfg)
    extras = {k: torch.from_numpy(v) for k, v in stubs.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        logits, cache = model.prefill(torch.from_numpy(prompts),
                                      cache_len=CACHE_LEN, extras=extras)
        tokens, _ = serve.serve_batch(cfg, model, prompts, MAX_NEW,
                                      CACHE_LEN, extras)
    finally:
        torch.set_num_threads(threads)
    jparams = jax.tree.map(jnp.asarray, params)
    if stubs:
        jtokens = _jax_greedy(cfg_j, jparams, prompts,
                              {k: jnp.asarray(v) for k, v in stubs.items()})
    else:
        jtokens, _ = jserve.serve_batch(cfg_j, jparams, prompts, MAX_NEW,
                                        CACHE_LEN)
    return {"params": params, "logits": logits, "cache": cache,
            "tokens": tokens, "jax_tokens": np.asarray(jtokens)}


@pytest.fixture(scope="module")
def runs():
    """Each world's prefill (logits, every rank's cache) and serving wave
    for each of its cases."""
    out = {}
    for (d, m), cases in WORLDS.items():
        mesh = make_lm_mesh(data=d, model=m, devices="cpu")
        lm = None
        try:
            for case in cases:
                cfg = _configs(case)[1]
                params = _reference(case)["params"]
                if lm is None:
                    lm = parallel.ShardedLM(cfg, mesh, params=params)
                else:
                    lm.build(cfg, params=params)
                logits, per_rank = lm.prefill(_prompts(cfg), CACHE_LEN,
                                              return_cache=True,
                                              extras=_patches(cfg))
                tokens, stats = lm.serve(_prompts(cfg), MAX_NEW, CACHE_LEN,
                                         extras=_patches(cfg))
                out[(d, m), case] = {
                    "logits": logits, "tokens": tokens, "stats": stats,
                    "caches": {r: o["cache"] for r, o in per_rank.items()},
                    "built": lm.built}
            if (d, m) == BF16_AT:
                cfg = _configs("zamba2")[1].with_(dtype="bfloat16")
                lm.build(cfg, seed=3)
                out["bf16"] = lm.prefill(_prompts(cfg))[0]
        finally:
            if lm is not None:
                lm.close()
    return out


@pytest.mark.parametrize("mesh,case", RUNS, ids=IDS)
def test_sharded_prefill_equals_unsharded(runs, mesh, case):
    """Logits and each rank's cache (its kv heads, its rows of the batch)
    against the unsharded port: bit for bit at model = 1, within 1e-5 of
    the largest magnitude otherwise."""
    run, ref = runs[mesh, case], _reference(case)
    d, m = mesh
    want = ref["logits"].numpy()
    assert run["logits"].shape == want.shape
    if mesh == (1, 1):
        assert np.array_equal(run["logits"], want)
    else:
        err = np.abs(run["logits"] - want).max()
        assert err <= TOL * np.abs(want).max(), err
    rows, kh = BATCH // d, _configs(case)[1].n_kv_heads // m
    for r, cache in run["caches"].items():
        di, mi = divmod(r, m)
        for got, full in zip(cache, ref["cache"]):
            if "kpos" not in full:               # a recurrent layer's
                _ssm_cache_placed(got, full, mesh, r)
                continue
            assert np.array_equal(got["kpos"], full["kpos"].numpy())
            for key in ("k", "v"):
                w = full[key][di * rows:(di + 1) * rows, :,
                              mi * kh:(mi + 1) * kh].numpy()
                assert got[key].shape == w.shape
                if mesh == (1, 1):
                    assert np.array_equal(got[key], w)
                else:
                    assert (np.abs(got[key] - w).max()
                            <= TOL * np.abs(w).max())


def _ssm_cache_placed(got: dict, full: dict, mesh, rank: int) -> None:
    """A rank's recurrent cache against the slice of the unsharded cache
    that ``sharding.cache_specs`` places: each spec's axis a contiguous
    chunk (the rows on "data", the heads or the conv state's channels on
    "model")."""
    d, m = mesh
    at = {"data": (rank // m, d), "model": (rank % m, m)}
    specs = sharding.cache_specs(full, BATCH, {"data": d, "model": m})
    assert got.keys() == full.keys()
    for key, g in got.items():
        w = full[key].numpy()
        index = tuple(slice(at[a][0] * n // at[a][1],
                            (at[a][0] + 1) * n // at[a][1]) if a in at
                      else slice(None) for a, n in zip(specs[key], w.shape))
        w = w[index]
        assert g.shape == w.shape, key
        assert np.abs(g - w).max() <= TOL * np.abs(w).max(), key


@pytest.mark.parametrize("mesh,case", RUNS, ids=IDS)
def test_sharded_greedy_tokens_equal_unsharded_and_jax(runs, mesh, case):
    run, ref = runs[mesh, case], _reference(case)
    assert run["tokens"].shape == (BATCH, MAX_NEW)
    assert np.array_equal(run["tokens"], ref["tokens"])
    assert np.array_equal(run["tokens"], ref["jax_tokens"])
    assert run["stats"]["logits_finite"]
    assert run["stats"]["flash_launches"] == [0] * (mesh[0] * mesh[1])


def test_bf16_prefill_returns_float32_logits(runs):
    """A bf16 model's prefill on the ranks: the logits come back as
    float32 host arrays (NumPy has no bfloat16), as close to the float32
    model holding the same (bf16) weights as the unsharded bf16 model's
    are, within half as much again (both ~5e-2 of the largest here: six
    layers of bf16 rounding)."""
    cfg = _configs("zamba2")[1].with_(dtype="bfloat16")
    got = runs["bf16"]
    prompts = torch.from_numpy(_prompts(cfg))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = parallel.transformer.init_params(cfg, seed=3, device="cpu")
        bf16 = model.prefill(prompts)[0].float().numpy()
        f32 = parallel.transformer.Transformer(cfg.with_(dtype="float32"),
                                               "cpu")
        f32.load_state_dict({k: v.float()
                             for k, v in model.state_dict().items()})
        want = f32.prefill(prompts)[0].numpy()
    finally:
        torch.set_num_threads(threads)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1.5 * np.abs(bf16 - want).max()


def test_weights_are_the_unsharded_models_slices(runs):
    """``shard_model`` from a seed, alone on a (1, 1) mesh, holds
    ``init_params``'s numbers; each rank at (1, 4) holds a quarter of
    every sharded leaf and the whole of every replicated one."""
    _, cfg = _configs("phi")
    mesh = make_lm_mesh(data=1, model=1, devices="cpu")
    whole = parallel.transformer.init_params(cfg, seed=5, device="cpu")
    part = parallel.shard_model(cfg, mesh, 0, seed=5)
    assert part.tp is None
    for (name, a), (_, b) in zip(whole.named_parameters(),
                                 part.named_parameters()):
        assert torch.equal(a, b), name
    specs = parallel.serve_specs(cfg, {"data": 1, "model": 4})
    n = sum(p.numel() // (4 if "model" in specs[name] else 1)
            for name, p in whole.named_parameters())
    built = runs[(1, 4), "phi"]["built"]
    assert sorted(built) == [0, 1, 2, 3]
    assert {b["params"] for b in built.values()} == {n}


def test_layouts_off_head_boundaries_raise():
    """Reduced qwen3-32b's 2 kv heads and glm4-9b's 2 at model = 4 lay out
    by JAX's spec with each kv head replicated on the two ranks whose q
    heads read it.  Head counts that the model axis does not divide lay
    out in runs of whole heads (``parallel.head_run``): reduced qwen3 at
    model = 8 (two ranks without a head, each kv head on the ranks that
    read it), glm4-9b at model = 64, whisper-large-v3's 20 q heads and
    xlstm-350m's 4 SSM heads at model = 8.  What still raises, before
    anything is spawned, naming the config and the leaf, is a block whose
    projections JAX's spec splits over "model" but for one whose width
    does not divide (glm4-9b's ``wk``, 256 columns, at model = 512); the
    recurrent families, the encoder-decoder and the VLM lay out."""
    _, qwen = _configs("qwen3")
    mesh = make_lm_mesh(data=1, model=4, devices="cpu")
    glm = registry.get("glm4-9b")
    for cfg, dh in ((qwen, qwen.head_dim), (glm, glm.head_dim)):
        specs = parallel.serve_specs(cfg, {"data": 1, "model": 4})
        assert specs["blocks.0.attn.wk"] == (None, "model")
        assert parallel.kv_replicas(cfg, 4) == 2
        for r in range(4):
            parts = parallel.rank_slices(cfg, mesh, r, mode="serve")
            assert parts["blocks.0.attn.wk"][1] == slice(r // 2 * dh,
                                                         (r // 2 + 1) * dh)
            q = cfg.n_heads // 4 * dh
            assert parts["blocks.0.attn.wq"][1] == slice(r * q, (r + 1) * q)
    mesh8 = make_lm_mesh(data=1, model=8, devices="cpu")
    dh = qwen.head_dim
    for r in range(8):
        parts = parallel.rank_slices(qwen, mesh8, r, mode="serve")
        q = parts["blocks.0.attn.wq"][1]
        assert (q.start, q.stop) == (r // 2 * dh, (r + 1) // 2 * dh)
        k = parts["blocks.0.attn.wk"][1]
        if r % 2:
            assert (k.start, k.stop) == (r // 4 * dh, (r // 4 + 1) * dh)
        else:
            assert q.start == q.stop and k.start == k.stop
    parallel.serve_specs(glm, {"data": 1, "model": 64})
    with pytest.raises(NotImplementedError, match=r"glm4-9b: .*attn\.wk"):
        parallel.serve_specs(glm, {"data": 1, "model": 512})
    for arch in ("zamba2-7b", "xlstm-350m"):
        parallel.serve_specs(registry.get(arch), {"data": 1, "model": 2})
    parallel.serve_specs(registry.get("xlstm-350m"), {"data": 1, "model": 8})
    whisper = registry.get("whisper-large-v3")
    parallel.serve_specs(whisper, {"data": 1, "model": 8})
    parallel.serve_specs(whisper, {"data": 1, "model": 4})
    assert parallel.serve_specs(registry.get("qwen2-vl-2b"), {
        "data": 1, "model": 2})["vision_proj"] == (None, "model")
    parallel.serve_specs(registry.get("phi3.5-moe-42b-a6.6b"),
                         {"data": 1, "model": 4})
    with pytest.raises(ValueError, match="comm"):
        parallel.shard_model(_configs("phi")[1],
                             make_lm_mesh(data=1, model=2, devices="cpu"), 0)
    with pytest.raises(ValueError, match="'data', 'model'"):
        parallel.ShardedLM(_configs("phi")[1],
                           parallel.RankMesh(("parties",), (1,), ("cpu",)))


def test_lm_mesh_layout_and_refusals():
    """The ("data", "model") mesh: row-major ranks, each axis's groups;
    NCCL ranks need a card each; with no devices named the ranks go on
    the cards and, with none, it raises — no fallback to the CPU."""
    mesh = make_lm_mesh(data=2, model=2, devices="cpu")
    assert mesh.axis_names == ("data", "model") and mesh.size == 4
    assert [mesh.coords(r) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    assert [mesh.axis_index(r, "model") for r in range(4)] == [0, 1, 0, 1]
    assert [mesh.axis_index(r, "data") for r in range(4)] == [0, 0, 1, 1]
    assert mesh.axis_ranks("model") == [(0, 1), (2, 3)]
    assert mesh.axis_ranks("data") == [(0, 2), (1, 3)]
    forest = parallel.RankMesh(("trees", "parties"), (2, 3), ("cpu",) * 6)
    assert forest.axis_ranks("parties") == [(0, 1, 2), (3, 4, 5)]
    assert [forest.coords(r) for r in (0, 4)] == [(0, 0), (1, 1)]
    with pytest.raises(ValueError, match="axes"):
        parallel.RankMesh(("model", "data"), (1, 2), ("cpu",) * 2)
    with pytest.raises(ValueError, match="cards only"):
        make_lm_mesh(data=1, model=2, backend="nccl", devices="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_lm_mesh(data=1, model=2)


@pytest.mark.parametrize("arch,m", [("whisper-large-v3", 8),
                                    ("whisper-large-v3", 16),
                                    ("qwen2-vl-2b", 8), ("qwen2-vl-2b", 16),
                                    ("xlstm-350m", 8)])
def test_uneven_head_runs_cover_every_head_once(arch, m):
    """The configs whose heads the production model axes do not divide —
    whisper-large-v3's 20 and qwen2-vl-2b's 12 q heads at model = 8 and
    16, xlstm-350m's 4 SSM heads at 8 — lay out in both modes, their
    ranks' runs of q heads covering each head once (at most ⌈H/m⌉ a
    rank, in rank order, ranks past the heads empty), each rank holding
    exactly the kv heads its q heads read (qwen2-vl's 2 kv heads: a run
    that straddles the two groups holds both), and each rank's recurrent
    heads its own run."""
    cfg = registry.get(arch)
    for mode in ("serve", "train"):
        parallel.SPECS[mode](cfg, {"data": 1, "model": m})
    runs = [parallel.head_run(cfg.n_heads, j, m) for j in range(m)]
    assert runs[0][0] == 0 and runs[-1][1] == cfg.n_heads
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert max(hi - lo for lo, hi in runs) == -(-cfg.n_heads // m)
    g = cfg.n_heads // cfg.n_kv_heads
    mesh = make_lm_mesh(data=1, model=m, devices="cpu")
    dh = cfg.head_dim
    for j, (lo, hi) in enumerate(runs):
        read = sorted({h // g for h in range(lo, hi)})
        assert list(range(*parallel.kv_run(cfg, j, m))) == read
        if cfg.has_attention:
            parts = parallel.rank_slices(cfg, mesh, j, mode="serve")
            assert parts["blocks.0.attn.wq"][1] == slice(lo * dh, hi * dh)
            assert parts["blocks.0.attn.wo"][0] == slice(lo * dh, hi * dh)
            kv = (read[0] * dh, (read[-1] + 1) * dh) if read else None
            k = parts["blocks.0.attn.wk"][1]
            assert kv is None and k.start == k.stop or \
                (k.start, k.stop) == kv
    if arch == "qwen2-vl-2b" and m == 8:
        assert parallel.kv_run(cfg, 2, 8) == (0, 1)
    if arch == "xlstm-350m":
        ssm = [parallel.head_run(cfg.n_ssm_heads, j, m) for j in range(m)]
        assert [hi - lo for lo, hi in ssm] == [0, 1] * (m // 2)


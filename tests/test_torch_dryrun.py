"""The port's dry run (``repro_torch/launch/cases.py``, ``dryrun.py``,
``perf.py``, ``launch/mesh.py::make_production_mesh``) against the JAX
package's, on the CPU, at reduced size, no process spawned.

The cases' tables equal JAX's; one rank's decode and train steps at (1,
1) count the FLOPs that ``repro.hlo_analysis.analyze_hlo`` counts in the
same step lowered by JAX (prefill the same outside attention, where the
flash op counts ``attention_work``'s figure — the visible pairs — and
JAX's plain attention every pair); a fake run counts what a real CPU run
counts; a deep step's extrapolated counts equal a full run's; a rank's
shard shapes at (16, 16) and (2, 16, 16) equal ``NamedSharding``'s of
JAX's specs wherever the layout is JAX's; and the CLI's records hold
``ok`` / ``skip`` with the terms, the peak and ``fits``."""
import ast
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from repro import compat
from repro import hlo_analysis
from repro.configs import registry as jregistry
from repro.configs.base import reduced as jreduced
from repro.launch import cases as jcases
from repro.models import sharding as jsharding
from repro.models import transformer as jtransformer
from repro.serve import step as jserve_step
from repro.train import optim as joptim
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import reduced
from repro_torch.kernels import attention
from repro_torch.launch import cases, dryrun, perf
from repro_torch.launch.mesh import (make_forest_mesh, make_lm_mesh,
                                     make_production_mesh)
from repro_torch.models import parallel, transformer

ROOT = Path(__file__).resolve().parents[1]
B, S, MB = 4, 64, 2


def _jax_table(module: str, name: str) -> dict:
    """A module-level dict of the JAX package read from its source (its
    ``launch/perf.py`` forces 512 host devices when imported)."""
    tree = ast.parse((ROOT / "src" / "repro" / module).read_text())
    for node in tree.body:
        target = (node.target if isinstance(node, ast.AnnAssign) else
                  node.targets[0] if isinstance(node, ast.Assign) else None)
        if getattr(target, "id", None) == name:
            return {ast.literal_eval(k): None for k in node.value.keys}
    raise KeyError(name)


def test_tables_equal_jax():
    assert {k: tuple(v.__dict__.values()) for k, v in cases.SHAPES.items()} \
        == {k: tuple(v.__dict__.values()) for k, v in jcases.SHAPES.items()}
    assert cases.SKIPS == jcases.SKIPS
    assert (cases.SWA_WINDOW, cases.TRAIN_MICRO_BATCH) == \
        (jcases.SWA_WINDOW, jcases.TRAIN_MICRO_BATCH)
    assert {k: tuple(v.__dict__.values())
            for k, v in cases.FOREST_SHAPES.items()} == \
        {k: tuple(v.__dict__.values())
         for k, v in jcases.FOREST_SHAPES.items()}
    assert list(perf.NN_VARIANTS) == list(_jax_table("launch/perf.py",
                                                     "NN_VARIANTS"))
    assert list(perf.FF_TRAIN_VARIANTS) == list(
        _jax_table("launch/perf.py", "FF_TRAIN_VARIANTS"))
    assert {v["hist_impl"] for v in perf.FF_TRAIN_VARIANTS.values()} <= \
        set(perf.ROUTES)
    for arch in jregistry.ARCH_IDS:
        for name, shape in cases.SHAPES.items():
            try:
                want = jcases.arch_for_shape(arch, jcases.SHAPES[name])
            except jcases.Skip:
                with pytest.raises(cases.Skip):
                    cases.arch_for_shape(arch, shape)
                continue
            got = cases.arch_for_shape(arch, shape)
            assert got.sliding_window == want.sliding_window, (arch, name)
            assert got.name == want.name


def test_production_meshes():
    """(16, 16) and (2, 16, 16), abstract, "pod" folded into "data"."""
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.shape, one.abstract) == (
        ("data", "model"), (16, 16), True)
    assert two.axis_names == ("pod", "data", "model") and two.size == 512
    assert (two.axis_size("data"), two.axis_size("model")) == (32, 16)
    assert two.axis_index(300, "pod") == 1
    assert two.axis_index(300, "data") == 18
    forest = make_forest_mesh(multi_pod=True)
    assert forest.axis_names == ("pod", "trees", "parties")
    with pytest.raises(ValueError, match="abstract"):
        parallel.ShardedLM(registry.get("internlm2-1.8b"), one)


def _case(arch, kind, cfg, mb=0, mesh=(1, 1), seq=S, batch=B):
    return cases.Case(arch, cases.InputShape("t", kind, seq, batch), cfg,
                      make_lm_mesh(data=mesh[0], model=mesh[1],
                                   devices="cpu"), "train", mb)


@functools.lru_cache(maxsize=None)
def _jax_flops(kind: str) -> float:
    cfg = jreduced(jregistry.get("internlm2-1.8b"))
    params = jax.eval_shape(lambda k: jtransformer.init_params(k, cfg),
                            jax.random.key(0))
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "decode":
        cache = jax.eval_shape(lambda: jtransformer.make_cache(cfg, B, S))
        fn = jserve_step.make_serve_step(cfg)
        args = (params, cache, jax.ShapeDtypeStruct((B, 1), jnp.int32),
                jax.ShapeDtypeStruct((), jnp.int32))
    elif kind == "prefill":
        fn = jserve_step.make_prefill_step(cfg)
        args = (params, {"tokens": tokens})
    else:
        fn = jmake_train_step(cfg, micro_batch=MB)
        args = (params, jax.eval_shape(joptim.adamw_init, params),
                {"tokens": tokens})
    text = jax.jit(fn).lower(*args).compile().as_text()
    return hlo_analysis.analyze_hlo(text).flops


@pytest.mark.parametrize("kind,tol", [("decode", 0.02), ("train", 0.05)])
def test_step_flops_match_jax_hlo_analysis(kind, tol):
    """One rank's step at (1, 1), reduced internlm2-1.8b: the op counter's
    FLOPs within 2 % (decode) and 5 % (train) of the JAX package's HLO
    analysis of the same step."""
    cfg = reduced(registry.get("internlm2-1.8b"))
    got = _case("internlm2-1.8b", kind, cfg, MB if kind == "train" else 0
                ).run(0, exact=True).roofline.flops
    want = _jax_flops(kind)
    assert abs(got - want) <= tol * want, (got, want)


def test_prefill_flops_match_jax_outside_attention():
    """Prefill: the same FLOPs outside attention; the flash op counts
    ``attention_work``'s visible pairs, JAX's plain attention every pair
    (4·B·H·S²·D a layer at S under its query chunk)."""
    cfg = reduced(registry.get("internlm2-1.8b"))
    run = _case("internlm2-1.8b", "prefill", cfg).run(0, exact=True)
    assert run.count("kernel:") == {
        "repro_torch::flash_attention": cfg.n_layers}
    flash = cfg.n_layers * attention.attention_work(
        B, cfg.n_heads, S, S, cfg.head_dim, 4, True, None)[0]
    plain = cfg.n_layers * 4 * B * cfg.n_heads * S * S * cfg.head_dim
    got = run.roofline.flops - flash
    want = _jax_flops("prefill") - plain
    assert abs(got - want) <= 0.02 * want, (got, want)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_fake_run_equals_a_real_cpu_run(kind):
    """The same step on fake tensors and on real CPU tensors (weights
    unset): the same FLOPs, bytes and peak live bytes."""
    cfg = reduced(registry.get("qwen2-moe-a2.7b"))
    case = _case("qwen2-moe-a2.7b", kind, cfg, MB if kind == "train" else 0)
    fake = case.run(0, exact=True).counts
    real = case.run(0, exact=True, fake=False).counts
    assert fake == real


def test_extrapolated_counts_equal_a_full_run():
    """A step counted at 2 and 3 units and 2 and 3 microbatches, carried
    to 6 units and 4 microbatches, against the whole step: FLOPs, bytes,
    collectives and kernel calls equal (within rounding), the peak within
    5 % (reduced whisper-large-v3, its encoder cut in step, at (1, 2))."""
    cfg = reduced(registry.get("whisper-large-v3")).with_(n_layers=6,
                                                          enc_layers=6)
    case = _case("whisper-large-v3", "train", cfg, 1, mesh=(1, 2),
                 seq=16, batch=4)
    full = case.run(0, exact=True).counts
    got = case.run(0).counts
    assert case.points == 4
    assert got.keys() == full.keys()
    for k, v in full.items():
        tol = 0.05 * v if k.startswith("peak:") else 1e-6 * max(abs(v), 1)
        assert abs(got[k] - v) <= tol, (k, got[k], v)


def _jax_shard_shapes(arch: str, sizes: dict, mode: str) -> dict:
    cfg = jregistry.get(arch)
    shapes = jax.eval_shape(lambda k: jtransformer.init_params(k, cfg),
                            jax.random.key(0))
    mesh = compat.abstract_mesh(tuple(sizes.values()), tuple(sizes))
    specs = jsharding.param_specs(shapes, mesh, mode)
    return jax.tree.map(lambda s, p: NamedSharding(mesh, p).shard_shape(
        s.shape), shapes, specs)


def _jax_layout(cfg, name: str, m: int) -> bool:
    """Whether the port lays leaf ``name`` out as JAX's spec does at a
    model axis of ``m``: all but a recurrent core's leaves and, where m
    does not divide the heads, the attention projections' (their runs of
    whole heads: ``parallel.head_run``; a kv head on several ranks)."""
    owner, _, leaf = name.rpartition(".")
    if owner.endswith(".core"):
        return False
    if leaf in ("wq", "wo"):
        return cfg.n_heads % m == 0
    if leaf in ("wk", "wv"):
        return cfg.n_kv_heads % m == 0 and cfg.n_heads % m == 0
    return True


@pytest.mark.parametrize("sizes", [{"data": 16, "model": 16},
                                   {"pod": 2, "data": 16, "model": 16}],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_shard_shapes_equal_jax_named_sharding(arch, sizes):
    """Rank 0's shard of every leaf whose layout is JAX's, in both modes,
    has ``NamedSharding.shard_shape`` of JAX's ``param_specs`` (a
    unit-stacked JAX leaf without its unit axis); the pod axis folded
    into "data"."""
    cfg = registry.get(arch)
    mesh = make_production_mesh(multi_pod="pod" in sizes)
    meta = dict(transformer.Transformer(cfg, "meta").named_parameters())
    for mode in ("train", "serve"):
        want = _jax_shard_shapes(arch, sizes, mode)
        specs = parallel.SPECS[mode](cfg, parallel._sizes(mesh))
        lay = parallel._layout(cfg, specs, parallel._coords(mesh, 0))
        n = 0
        for name, p in meta.items():
            if not _jax_layout(cfg, name, 16):
                continue
            path, u = convert._jax_path(name, cfg)
            w = want
            for k in path:
                w = w[k]
            w = tuple(w[1:] if u is not None else w)
            assert tuple(parallel._extent(lay[name], p.shape)) == w, (
                name, mode)
            n += 1
        assert n


def test_dryrun_records(tmp_path):
    """The CLI's record: ``ok`` with the three terms, the bottleneck, the
    peak and ``fits``, the flash op's calls; JAX's skip as ``skip``; a
    forest case ``ok`` through the histogram kernel's op."""
    rec = dryrun.run_case("internlm2-1.8b", "prefill_32k", False, tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    ro = rec["roofline"]
    assert ro["bottleneck"] in ("compute", "memory", "collective")
    assert ro["least_s"] == max(ro["t_compute_s"], ro["t_memory_s"],
                                ro["t_collective_s"])
    assert rec["memory"]["fits"] is True
    assert rec["kernel_calls"] == {"repro_torch::flash_attention": 24}
    assert json.loads((tmp_path / "internlm2-1.8b__prefill_32k__pod16x16"
                       ".json").read_text())["status"] == "ok"
    skip = dryrun.run_case("whisper-large-v3", "long_500k", True, tmp_path)
    assert skip["status"] == "skip"
    ff = dryrun.run_case("federated-forest", "ff_train", False, tmp_path)
    assert ff["status"] == "ok", ff.get("error")
    assert ff["kernel_calls"]["repro_torch::histogram"] > 0
    assert ff["rounds"] > 0
    assert dryrun.line(rec).startswith("OK ")


def test_uneven_heads_run_as_distinct_layouts():
    """whisper-large-v3's 20 q heads at model = 16: runs of one and two
    heads, each layout counted once, the record the larger's."""
    case = cases.input_specs("whisper-large-v3", "decode_32k",
                             make_production_mesh())
    layouts = case.layouts()
    assert sorted(len(r) for r in layouts) == [4, 12]
    assert sorted(r for rs in layouts for r in rs) == list(range(16))
    heads = {len(range(*parallel.head_run(20, rs[0], 16))) for rs in layouts}
    assert heads == {1, 2}
    assert np.isfinite(cases.input_specs(
        "qwen2-vl-2b", "decode_32k", make_production_mesh()).run(
            2).roofline.least_s)

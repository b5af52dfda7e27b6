"""The port's sharding rules against the JAX package's, on the CPU.

``repro_torch.models.sharding`` (pure functions over shapes and a dict of
axis sizes) against ``repro.models.sharding`` (over an ``AbstractMesh``):
``param_specs`` in both modes with ``expert_data`` on and off,
``opt_specs``, ``batch_spec`` and ``cache_specs``, leaf for leaf, for all
ten configurations at full size (the JAX package's through
``jax.eval_shape``, the port's on the ``meta`` device) on the (data,
model) axis sizes (16, 16), (1, 4), (2, 2) and (1, 2), and the multi-pod
(2, 16, 16).  A JAX spec of a leaf stacked over the pattern units has one
leading ``None`` more than the port's spec of the same layer's leaf
(``convert._jax_path`` and ``_layer_path`` give the correspondence).
Specs are compared exactly.
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.configs import registry as jregistry
from repro.models import sharding as jsharding
from repro.models import transformer as jtransformer
from repro.train import optim as joptim
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import sharding, transformer

MESHES = {"16x16": {"data": 16, "model": 16}, "1x4": {"data": 1, "model": 4},
          "2x2": {"data": 2, "model": 2}, "1x2": {"data": 1, "model": 2},
          "pod": {"pod": 2, "data": 16, "model": 16}}
CACHE_BATCH, CACHE_SEQ = 16, 64


def _mesh(name):
    sizes = MESHES[name]
    return compat.abstract_mesh(tuple(sizes.values()), tuple(sizes))


def _tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _unstacked(spec: tuple, u) -> tuple:
    """A JAX spec of a unit-stacked leaf without its unit axis."""
    if u is None or not spec:
        return spec
    assert spec[0] is None, spec
    return spec[1:]


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jregistry.get(arch)
    return jax.eval_shape(lambda k: jtransformer.init_params(k, cfg),
                          jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return transformer.Transformer(registry.get(arch), "meta")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_param_and_opt_specs_equal_jax(arch, mesh):
    """Every parameter's spec, both modes, ``expert_data`` on and off; and
    ``opt_specs`` (mu and nu as the params, step replicated)."""
    cfg = registry.get(arch)
    shapes, model = _jax_params(arch), _port_model(arch)
    names = [n for n, _ in model.named_parameters()]
    for mode in ("train", "serve"):
        for expert_data in (False, True):
            want = _tuples(jsharding.param_specs(shapes, _mesh(mesh), mode,
                                                 expert_data))
            got = sharding.param_specs(model, MESHES[mesh], mode,
                                       expert_data)
            assert list(got) == names
            for name in names:
                path, u = convert._jax_path(name, cfg)
                assert got[name] == _unstacked(_get(want, path), u), (
                    name, mode, expert_data)
    pspecs = sharding.param_specs(model, MESHES[mesh])
    jo = jsharding.opt_specs(jax.eval_shape(joptim.adamw_init, shapes),
                             jsharding.param_specs(shapes, _mesh(mesh)))
    got = sharding.opt_specs(None, pspecs)
    assert set(got) == set(jo) == {"mu", "nu", "step"}
    assert got["step"] == tuple(jo["step"]) == ()
    assert got["mu"] is pspecs and got["nu"] is pspecs


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_equals_jax(mesh):
    for batch in (1, 2, 3, 4, 6, 8, 16, 32, 48, 64, 256):
        for extra in (0, 1, 2):
            want = tuple(jsharding.batch_spec(batch, _mesh(mesh), extra))
            assert sharding.batch_spec(batch, MESHES[mesh], extra) == want, (
                batch, extra)


@pytest.mark.parametrize("mesh", ["16x16", "1x4", "2x2", "1x2"])
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_cache_specs_equal_jax(arch, mesh):
    """The decode cache's specs, layer by layer: an attention layer's ring
    (the JAX package's ``{"self": ring}``), cross-attention k and v, the
    recurrent states; batches that split over the data axis and one that
    does not."""
    cfg = registry.get(arch)
    jcache = jax.eval_shape(lambda: jtransformer.make_cache(
        jregistry.get(arch), CACHE_BATCH, CACHE_SEQ))
    cache = transformer.make_cache(cfg, CACHE_BATCH, CACHE_SEQ, "meta")
    for batch in (CACHE_BATCH, 3):
        want = _tuples(jsharding.cache_specs(jcache, batch, _mesh(mesh)))
        got = sharding.cache_specs(cache, batch, MESHES[mesh])
        assert len(got) == cfg.n_layers
        for i, kind in enumerate(transformer.layer_kinds(cfg)):
            path, u = convert._layer_path(i, cfg)
            w = _get(want, path)
            if kind in ("attn", "attn_shared") and not cfg.cross_attention:
                w = w["self"]
            flat_w = jax.tree_util.tree_flatten_with_path(
                w, is_leaf=lambda x: isinstance(x, tuple))[0]
            flat_g = jax.tree_util.tree_flatten_with_path(
                got[i], is_leaf=lambda x: isinstance(x, tuple))[0]
            assert [p for p, _ in flat_g] == [p for p, _ in flat_w], (i, kind)
            for (p, g), (_, ws) in zip(flat_g, flat_w):
                assert g == _unstacked(ws, u), (i, kind, p, batch)


def test_serve_mode_replicates_over_data_and_specs_divide():
    """Serve mode names no data axis; every named axis divides its dim
    (tests/test_substrate.py's invariant, on the port's shapes)."""
    for arch in jregistry.ARCH_IDS:
        model = _port_model(arch)
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        for sizes in MESHES.values():
            for mode in ("train", "serve"):
                for name, spec in sharding.param_specs(model, sizes,
                                                       mode).items():
                    for dim, ax in zip(shapes[name], spec):
                        if ax is None:
                            continue
                        assert mode == "train" or ax == "model", (name, spec)
                        size = int(np.prod([sizes[a] for a in (
                            ax if isinstance(ax, tuple) else (ax,))]))
                        assert dim % size == 0, (arch, name, spec)
    with pytest.raises(ValueError, match="mode"):
        sharding.param_specs(_port_model("qwen3-32b"), MESHES["1x4"], "fsdp")

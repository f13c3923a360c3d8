"""The port's mesh rules held to the reference's, spec for spec:
``param_spec`` / ``named_sharding_tree`` over every leaf path of all ten
architectures' parameter trees (with and without ``fsdp`` and
``moe2d``), ``batch_spec``, ``_cache_leaf_spec`` / ``cache_shardings``,
``input_specs``, ``batch_shardings``, ``serve_param_fsdp``,
``build_cell``'s shardings, ``applicable_shapes`` and
``make_batch_specs``, on meshes (16, 16), (2, 16, 16), (2, 2), (1, 4)
and (4, 1).  The reference side uses an abstract ``Mesh`` over repeated
CPU devices, as ``tests/test_sharding.py::mesh16`` does; nothing is
placed.  Specs are compared as tuples (``repro_torch.sharding.rules.P``
normalizes a one-name tuple to the name, as JAX's ``PartitionSpec``
does).  Plus the port's own pieces: ``maybe_constrain`` resolves a spec
as the reference does and returns ``x`` unchanged, and blocks placed
under a spec read back whole."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

import repro.launch.steps as jsteps
import repro.sharding.rules as jrules
from repro.configs import applicable_shapes as japplicable
from repro.configs import get_config as jget_config
from repro.data.pipeline import make_batch_specs as jbatch_specs
from repro.models import get_model as jget_model
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable_shapes,
                                 get_config)
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tree import leaves_with_path
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.sharding import rules

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}


@functools.lru_cache(maxsize=None)
def _meshes(name):
    shape, axes = MESHES[name]
    n = int(np.prod(shape))
    ref = JMesh(np.array(jax.devices() * n)[:n].reshape(shape), axes)
    return ref, rules.Mesh.meta(shape, axes)


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _tflat(tree):
    return dict(leaves_with_path(tree))


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    cfg = jget_config(arch)
    return _jflat(jax.eval_shape(functools.partial(
        jget_model(cfg).init_params, cfg=cfg), jax.random.PRNGKey(0)))


def _spec(x):
    """A sharding or spec as a plain tuple."""
    return tuple(getattr(x, "spec", x))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_every_leaf_matches_reference(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    ref = _ref_param_shapes(arch)
    port = _tflat(steps.abstract_params(get_config(arch)))
    assert set(port) == set(ref)
    for path, leaf in port.items():
        assert tuple(leaf.shape) == tuple(ref[path].shape), path
        for fsdp in (True, False):
            for moe2d in (False, True):
                want = jrules.param_spec(path, ref[path].shape, jm,
                                         fsdp=fsdp, moe2d=moe2d)
                got = rules.param_spec(path, tuple(leaf.shape), tm,
                                       fsdp=fsdp, moe2d=moe2d)
                assert tuple(got) == tuple(want), (path, fsdp, moe2d)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_match_reference(arch, mesh_name):
    """Every cache leaf of every architecture at decode_32k's length, for
    batch sizes that divide the batch axes and ones that do not."""
    jm, tm = _meshes(mesh_name)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for batch in (128, 6, 1):
        shape = ShapeConfig("d", 32768, batch, "decode")
        ref = _jflat(jsteps.cache_shardings(
            jsteps.abstract_cache(jcfg, shape), jm, batch))
        cache = steps.abstract_cache(cfg, shape)
        port = _tflat(steps.cache_shardings(cache, tm, batch))
        assert set(port) == set(ref)
        shapes = _tflat(cache)
        for path, sh in port.items():
            assert _spec(sh) == _spec(ref[path]), (path, batch)
            stacked = path.startswith("stack")
            assert tuple(steps._cache_leaf_spec(
                tuple(shapes[path].shape), tm, batch, stacked)) == tuple(
                jsteps._cache_leaf_spec(tuple(shapes[path].shape), jm,
                                        batch, stacked))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_spec_matches_reference(mesh_name):
    jm, tm = _meshes(mesh_name)
    for b in (1, 2, 3, 4, 6, 16, 32, 48, 128, 256, 512):
        assert tuple(steps.batch_spec(tm, b)) == tuple(
            jsteps.batch_spec(jm, b)), b
        assert steps.batch_axes(tm) == jsteps.batch_axes(jm)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_batch_shardings_match_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for shape in SHAPES.values():
        ref = jsteps.input_specs(jcfg, shape)
        port = steps.input_specs(cfg, shape)
        assert list(port) == list(ref)
        for k in ref:
            assert tuple(port[k].shape) == tuple(ref[k].shape), k
            assert str(port[k].dtype).split(".")[-1] == str(ref[k].dtype)
            assert port[k].device.type == "meta"
        for mesh_name in ("16x16", "2x16x16", "2x2"):
            jm, tm = _meshes(mesh_name)
            rb = jsteps.batch_shardings(jcfg, shape, jm)
            pb = steps.batch_shardings(cfg, shape, tm)
            assert {k: _spec(v) for k, v in pb.items()} == {
                k: _spec(v) for k, v in rb.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_param_fsdp_applicable_shapes_and_batch_specs(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert applicable_shapes(cfg) == japplicable(jcfg)
    for mesh_name in MESHES:
        jm, tm = _meshes(mesh_name)
        for bpp in (2.0, 1.0, 0.5):
            assert steps.serve_param_fsdp(cfg, tm, bpp) == \
                jsteps.serve_param_fsdp(jcfg, jm, bpp)
    for shape in SHAPES.values():
        ref = jbatch_specs(jcfg, shape)
        port = make_batch_specs(cfg, shape)
        assert list(port) == list(ref)
        for k in ref:
            assert tuple(port[k].shape) == tuple(ref[k].shape)
            assert str(port[k].dtype).split(".")[-1] == str(ref[k].dtype)
            assert port[k].device.type == "meta"


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_cell_shardings_match_reference(arch, mesh_name):
    """``build_cell``'s ``in_shardings`` for every shape, and its
    argument shapes, against the reference's (int4 weights for the
    serving cells: held as int8 on meta)."""
    jm, tm = _meshes(mesh_name)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jopt = jsteps.CellOptions(serve_weight_dtype="int4")
    topt = steps.CellOptions(serve_weight_dtype="int4")
    for shape in SHAPES.values():
        _, jargs, jsh, _ = jsteps.build_cell(jcfg, shape, jm, options=jopt)
        fn, targs, tsh, _ = steps.build_cell(cfg, shape, tm, options=topt)
        assert isinstance(fn, steps.PlacedStep)
        assert len(targs) == len(jargs) == len(tsh) == len(jsh)
        for ja, ta, js, ts in zip(jargs, targs, jsh, tsh):
            jl = _jflat(ja) if isinstance(ja, dict) else {"": ja}
            tl = _tflat(ta) if isinstance(ta, dict) else {"": ta}
            assert set(jl) == set(tl)
            for path in jl:
                assert tuple(tl[path].shape) == tuple(jl[path].shape), path
                want = str(jl[path].dtype)
                got = str(tl[path].dtype).split(".")[-1]
                assert got == {"int4": "int8"}.get(want, want), path
            js_l = _jflat(js) if isinstance(js, dict) else {"": js}
            ts_l = _tflat(ts) if isinstance(ts, dict) else {"": ts}
            assert {p: _spec(s) for p, s in ts_l.items()} == {
                p: _spec(s) for p, s in js_l.items()}


def test_maybe_constrain_resolves_as_the_reference(monkeypatch):
    """The spec the reference hands to ``with_sharding_constraint`` is
    the one the port resolves; the port returns ``x`` itself."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    x = torch.ones(4, 2, 3, 8)
    assert rules.maybe_constrain(x, "batch", None) is x     # no context
    for mesh_name in ("2x2", "2x16x16", "4x1"):
        jm, tm = _meshes(mesh_name)
        for spec in (("batch", None, None), ("batch", None, "model", None),
                     ("data", "pod", "tile", None)):
            with jrules.use_ctx(jrules.ShardCtx(jm)):
                jrules.maybe_constrain(jnp.ones((4, 2, 3, 8)), *spec)
            with rules.use_ctx(rules.ShardCtx(tm)) as ctx:
                assert rules.maybe_constrain(x, *spec) is x
                assert tuple(rules.resolve_spec(ctx, *spec)) == seen[-1]
                assert ctx.batch_spec == jrules.ShardCtx(jm).batch_spec
    assert rules.current_ctx() is None


def test_partition_spec_normalizes_as_jax():
    for entries in [(("data",),), (("pod", "data"), None), (None, "model"),
                    (), (None,)]:
        assert tuple(rules.P(*entries)) == tuple(JP(*entries))
    assert rules.P(("data",)) + (None,) == rules.P("data", None)


def test_meshes():
    pod = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert pod.shape == {"data": 16, "model": 16} and pod.is_meta
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    host = tmesh.make_host_mesh(2, 2, device="cpu")
    assert host.shape == {"data": 2, "model": 2}
    assert [str(d) for d in host.devices.flat] == ["cpu"] * 4
    assert tmesh.make_host_mesh(1, 3, devices=["cpu"]).size == 3


@pytest.mark.parametrize("mesh_name", ["2x2", "1x4", "4x1"])
def test_blocks_read_back_whole(mesh_name):
    _, meta = _meshes(mesh_name)
    mesh = rules.Mesh(np.full(meta.devices.shape, torch.device("cpu"),
                              dtype=object), meta.axis_names)
    x = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    for spec in (rules.P("data", "model"), rules.P(None, ("data", "model")),
                 rules.P("model", None, None), rules.P()):
        st = rules.place(x, spec, mesh)
        assert torch.equal(st.full(), x)
        assert st.block_shape == rules.block_shape(x.shape, spec, mesh)
        assert rules.place(st, spec, mesh) is st
        for c, blk in st.blocks.items():
            sl = tuple(slice(ci * n, (ci + 1) * n)
                       for ci, n in zip(c, st.block_shape))
            assert torch.equal(blk, x[sl])
            assert blk.data_ptr() == x[sl].data_ptr()    # a view, no copy
        assert torch.equal(rules.region(st, (slice(1, 7), slice(2, 11))),
                           x[1:7, 2:11])
        if st.spec[0] is None:
            assert torch.equal(st[3].full(), x[3])

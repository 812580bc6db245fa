"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro/launch/sharding.py``), spec for spec, with no ranks:
both sides take an abstract mesh (``jax.sharding.AbstractMesh`` there,
``repro_torch.launch.AbstractMesh`` here) of the production shapes
(16, 16) and (2, 16, 16) and the host shapes (4, 2) and (2, 2).

Parameters: every leaf of each of the 10 architectures' full configs, the
reference's shapes by ``jax.eval_shape``; a layer's port leaf (one a
layer) must get the reference's spec of the stacked leaf without its
layers entry. Batches: ``pick_batch_axes`` at batch 1, 4, 8 and 256 and
``batch_shardings`` at accum 1 and 4. Caches: ``cache_spec`` of every
family's cache keys. A reference spec is compared as a tuple with an
entry per dimension (a one-axis tuple as the axis name, ``()`` as None).
"""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import get_config as ref_config
from repro.launch import sharding as RS
from repro.models import transformer as RT
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as port_config
from repro_torch.launch import AbstractMesh
from repro_torch.launch import sharding as PS

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
LAYOUTS = ("tp", "ddp")


def _meshes(name):
    shape, axes = MESHES[name]
    return JaxAbstractMesh(shape, axes), AbstractMesh(shape, axes)


def _entry(e):
    if isinstance(e, tuple):
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _norm(spec, ndim):
    """A PartitionSpec as the port's tuple of ``ndim`` entries."""
    spec = tuple(spec)
    return tuple(_entry(e) for e in spec) + (None,) * (ndim - len(spec))


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    cfg = ref_config(arch)
    shapes = jax.eval_shape(lambda k: RT.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    return cfg, jax.tree_util.tree_flatten_with_path(shapes)[0]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference(arch, mesh):
    rcfg, leaves = _ref_leaves(arch)
    pcfg = port_config(arch)
    rmesh, pmesh = _meshes(mesh)
    checked = 0
    for layout in LAYOUTS:
        for path, leaf in leaves:
            want = _norm(RS.param_spec(path, leaf, rcfg, rmesh, layout),
                         leaf.ndim)
            ps = RS._path_str(path)
            group = ps.split("/", 1)[0]
            if group in ("layers", "dense_layers"):
                for i in sorted({0, leaf.shape[0] - 1}):
                    pp = f"{group}/{i}/{ps.split('/', 1)[1]}"
                    got = PS.param_spec(pp, leaf.shape[1:], pcfg, pmesh,
                                        layout)
                    assert got == want[1:], (layout, pp, got, want)
            else:
                got = PS.param_spec(ps, leaf.shape, pcfg, pmesh, layout)
                assert got == want, (layout, ps, got, want)
            checked += 1
    assert checked == 2 * len(leaves)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_rules_match_reference(mesh, layout):
    rmesh, pmesh = _meshes(mesh)
    multi = "pod" in MESHES[mesh][1]
    for batch in (1, 4, 8, 256):
        want = RS.pick_batch_axes(batch, rmesh, multi, layout)
        assert PS.pick_batch_axes(batch, pmesh, multi, layout) == want
        rsh = RS.make_sharder(rmesh, multi_pod=multi, batch=batch,
                              layout=layout)
        psh = PS.make_sharder(pmesh, multi_pod=multi, batch=batch,
                              layout=layout)
        assert (psh.model_axis, psh.fsdp_axis) == (rsh.model_axis,
                                                   rsh.fsdp_axis)
        for accum in (1, 4):
            lead = (accum,) if accum > 1 else ()
            shapes = {"tokens": jax.ShapeDtypeStruct(
                          lead + (batch, 16), "int32"),
                      "patch_embeds": jax.ShapeDtypeStruct(
                          lead + (batch, 4, 8), "float32")}
            ref = RS.batch_shardings(shapes, rsh, rmesh, accum)
            got = PS.batch_shardings({k: v.shape for k, v in shapes.items()},
                                     psh, pmesh, accum)
            for k, v in shapes.items():
                assert got[k] == _norm(ref[k].spec, len(v.shape)), (k, accum)


def _cache_shapes(cfg, B=8, S=64):
    """Each cache key of ``cfg``'s family and its stacked shape ``[L, B,
    ...]``, from the reference's own cache and state initialisers."""
    from repro.models import attention, mamba2, mla, rwkv6
    if cfg.family == "rwkv":
        one = rwkv6.init_rwkv_state(cfg, B)
    elif cfg.family == "hybrid":
        one = {**mamba2.init_mamba_state(cfg, B),
               **attention.init_kv_cache(cfg, B, S)}
    elif cfg.mla:
        one = mla.init_mla_cache(cfg, B, S)
    else:
        one = attention.init_kv_cache(cfg, B, S)
    shapes = jax.eval_shape(lambda: one)
    return {k: (cfg.n_layers,) + tuple(v.shape) for k, v in shapes.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_matches_reference(arch, mesh):
    rcfg, pcfg = ref_config(arch), port_config(arch)
    rmesh, pmesh = _meshes(mesh)
    multi = "pod" in MESHES[mesh][1]
    for layout in LAYOUTS:
        for batch in (8, 1):
            rsh = RS.make_sharder(rmesh, multi_pod=multi, batch=batch,
                                  layout=layout)
            psh = PS.make_sharder(pmesh, multi_pod=multi, batch=batch,
                                  layout=layout)
            for key, shape in _cache_shapes(rcfg, B=batch).items():
                leaf = jax.ShapeDtypeStruct(shape, "float32")
                want = _norm(RS.cache_spec(
                    (jax.tree_util.DictKey("main"), jax.tree_util.DictKey(
                        key)), leaf, rcfg, rsh, rmesh), len(shape))
                got = PS.cache_spec(f"main/{key}", shape, pcfg, psh, pmesh)
                assert got == want, (layout, key, got, want)
                assert PS.local_shape(shape, got, pmesh) == tuple(
                    s // (1 if e is None else PS._axis_size(pmesh, e))
                    for s, e in zip(shape, got))


def test_placements_and_local_shapes():
    """A spec's DTensor placements on a (2, 2) mesh and the shard shapes
    the guards keep even; an axis order against the mesh's raises."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("data", "model")

    assert PS.placements(("data", None, "model"), Mesh) == [Shard(0),
                                                           Shard(2)]
    assert PS.placements((None, ("data", "model")), Mesh) == [Shard(1),
                                                             Shard(1)]
    assert PS.placements((None, None), Mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError):
        PS.placements((("model", "data"),), Mesh)
    pmesh = AbstractMesh((2, 2), ("data", "model"))
    assert PS.local_shape((8, 6, 4), ("data", None, "model"), pmesh) == (
        4, 6, 2)
    with pytest.raises(ValueError):
        PS.local_shape((3,), ("data",), pmesh)

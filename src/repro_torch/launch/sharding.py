"""Sharding rules: parameters, batches, caches; and their DTensor
placements.

Counterpart of ``repro/launch/sharding.py``: DP (+FSDP) over ``data``
(+ ``pod``), TP over ``model``, EP over ``model`` for the MoE's experts,
SP through the :class:`~repro_torch.models.common.Sharder`'s
sequence-sharded residuals. The rules match a leaf by its path and shape
with divisibility guards; anything unmatched is replicated.

A spec is a tuple with one entry per dimension of the tensor: ``None``
(replicated), an axis name, or a tuple of axis names (the dimension split
over those axes, major to minor), the counterpart of ``PartitionSpec``.
:func:`placements` turns a spec into the ``DTensor`` placements of a
``DeviceMesh``. A mesh is a ``DeviceMesh`` with named dimensions or
anything with ``shape`` (name -> size) and ``axis_names``
(:class:`repro_torch.launch.mesh.AbstractMesh`, the counterpart of
``jax.sharding.AbstractMesh``), so the production meshes' rules are
computed without their 256 or 512 ranks.

Layout: the reference stacks a layer's leaves ``[L, ...]``; the port keeps
one leaf a layer (``layers/<i>/...``, ``dense_layers/<i>/...``; see
``convert._unstack_paths``). A port leaf's spec is the reference's spec
of the stacked leaf ``[L, *shape]`` with its leading layers entry
dropped: :func:`param_spec` computes exactly that, with the group's true
``L``, since the ``ddp`` rule's choice of dimension reads it.

Deferred to the training slice (ROADMAP A3): ``opt_state_shardings``.
The reference shards TreeNewton's statistics ``[L, nb, b, b]`` on their
stacked ``L`` over ``data``, which has no counterpart in the port's
``(nb, b, b)`` a layer.
"""
from __future__ import annotations

import re

from repro_torch.models.common import ModelConfig, Sharder


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or an abstract mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names else tuple(mesh.axis_names)


def _axis_size(mesh, axis) -> int:
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        s = 1
        for a in axis:
            s *= shape[a]
        return s
    return shape[axis]


def _div(n, mesh, axis):
    return axis is not None and n % _axis_size(mesh, axis) == 0


def placements(spec, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh`` (a DeviceMesh):
    ``Shard(d)`` on every mesh dimension that tensor dimension ``d``'s
    entry names, ``Replicate()`` elsewhere. A dimension split over several
    axes names them in the mesh's order (DTensor splits over mesh
    dimensions left to right, as ``PartitionSpec`` over a tuple)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dimension {d} "
                             f"out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of each rank's shard of a tensor of ``shape`` under
    ``spec`` (the guards keep every sharded dimension divisible)."""
    out = []
    for size, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = 1 if entry is None else _axis_size(mesh, entry)
        if size % n:
            raise ValueError(f"dimension {size} does not divide over {entry}")
        out.append(size // n)
    return tuple(out)


def make_sharder(mesh, *, multi_pod: bool, batch: int,
                 layout: str = "tp") -> Sharder:
    """layout='tp' : data-parallel over (pod,)data, TP/EP over model.
    layout='ddp': every axis data parallel + ZeRO-3, no TP."""
    batch_axes = pick_batch_axes(batch, mesh, multi_pod, layout)
    if layout == "ddp":
        return Sharder(enabled=True, batch_axes=batch_axes,
                       model_axis=None, fsdp_axis="fsdp-all", mesh=mesh)
    return Sharder(enabled=True, batch_axes=batch_axes, model_axis="model",
                   fsdp_axis="data", mesh=mesh)


def pick_batch_axes(batch: int, mesh, multi_pod: bool,
                    layout: str = "tp") -> tuple:
    """Greedily assign mesh axes to the batch dim while they divide it
    (a batch of 1 ends up replicated)."""
    if layout == "ddp":
        cands = (("pod", "data", "model") if multi_pod
                 else ("data", "model"))
    else:
        cands = ("pod", "data") if multi_pod else ("data",)
    shape = mesh_shape(mesh)
    axes = []
    rem = batch
    for a in cands:
        s = shape[a]
        if rem % s == 0 and rem >= s:
            axes.append(a)
            rem //= s
    return tuple(axes)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
_RULES = [
    # (regex on path, kind)
    (r"moe/(w_in|w_gate|w_out)$", "moe_expert"),
    (r"(embed)$", "embed"),
    (r"(lm_head)$", "lm_head"),
    (r"(w_in|w_gate|wq|wk|wv|wr|wk|wv|wg|ck|w_uq|w_uk|w_uv)$", "d_to_f"),
    (r"(w_out|wo|cv)$", "f_to_d"),
    (r"(router|w_dkv|w_kr|w_dq|w_lora_a|patch_proj|cr)$", "d_only"),
    (r"(shared/w_in|shared/w_gate)$", "d_to_f"),
    (r"(shared/w_out)$", "f_to_d"),
]

#: a layer's leaf in the port's layout: the group and the layer index
_LAYERED = re.compile(r"^(dense_layers|layers)/(\d+)/")


def _group_layers(group: str, cfg: ModelConfig) -> int:
    """The stacked length ``L`` of the reference's group."""
    nd = cfg.moe_first_dense if cfg.family == "moe" else 0
    return nd if group == "dense_layers" else cfg.n_layers - nd


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _stacked_spec(ps: str, shape: tuple, cfg: ModelConfig, mesh,
                  layout: str) -> tuple:
    """The reference's rule on a leaf of path ``ps`` and ``shape`` (a
    stacked leaf's shape has its leading layers dimension)."""
    ndim = len(shape)
    if layout == "ddp":
        # pure ZeRO-3: shard one big dim over ALL mesh axes, no TP
        dall = axis_names(mesh)
        if ndim >= 2:
            for dim in (ndim - 2, ndim - 1):
                if _div(shape[dim], mesh, dall):
                    spec = [None] * ndim
                    spec[dim] = dall
                    return tuple(spec)
        return (None,) * ndim
    d = ("pod", "data") if "pod" in axis_names(mesh) else "data"
    m = "model"

    def guard(spec):
        return tuple(ax if ax is not None and _div(size, mesh, ax) else None
                     for ax, size in zip(spec, shape))

    kind = None
    for rx, k in _RULES:
        if re.search(rx, ps):
            kind = k
            break
    if kind is None or ndim < 2:
        return (None,) * ndim
    lead = (None,) * (ndim - 2)
    if kind == "moe_expert":
        # [L, E, din, dout]: EP over model, FSDP over data on din
        return guard((None,) * (ndim - 3) + (m, d, None))
    if kind == "embed":
        if cfg.family == "audio" and ndim == 3:          # [ncb, V, D]
            return guard((None, m, d))
        return guard((m, d))                             # [V, D]
    if kind == "lm_head":
        if cfg.family == "audio" and ndim == 3:          # [ncb, D, V]
            return guard((None, d, m))
        return guard((d, m))                             # [D, V]
    if kind == "d_to_f":
        return guard(lead + (d, m))
    if kind == "f_to_d":
        return guard(lead + (m, d))
    if kind == "d_only":
        return guard(lead + (d, None))
    raise AssertionError(kind)


def param_spec(path: str, leaf, cfg: ModelConfig, mesh,
               layout: str = "tp") -> tuple:
    """The spec of one of the port's parameter leaves (``leaf`` a tensor
    or a shape). A layer's leaf (``layers/<i>/...``) gets the reference's
    spec of its stacked leaf minus the layers entry; any other leaf the
    reference's spec of the same leaf."""
    shape = _shape(leaf)
    m = _LAYERED.match(path)
    if m is None:
        return _stacked_spec(path, shape, cfg, mesh, layout)
    stacked = (_group_layers(m.group(1), cfg),) + shape
    ps = m.group(1) + "/" + path[m.end():]
    return _stacked_spec(ps, stacked, cfg, mesh, layout)[1:]


def _tree_map(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not (
            tree and all(isinstance(v, int) for v in tree)):
        return [_tree_map(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def param_shardings(shapes, cfg: ModelConfig, mesh, layout: str = "tp"):
    """The pytree of specs of a pytree of parameters (tensors or
    shapes)."""
    return _tree_map(lambda p, l: param_spec(p, l, cfg, mesh, layout),
                     shapes)


# ---------------------------------------------------------------------------
# batches / caches
# ---------------------------------------------------------------------------
def batch_shardings(batch_shapes, sharder: Sharder, mesh, accum: int = 1):
    """Specs of a batch's leaves: the batch dimension (after the
    accumulation dimension when ``accum > 1``) over the batch axes."""
    lead = (None,) if accum > 1 else ()

    def one(path, leaf):
        rest = (None,) * (len(_shape(leaf)) - len(lead) - 1)
        return (*lead, _batch_entry(sharder.batch_axes), *rest)

    return _tree_map(one, batch_shapes)


def _batch_entry(axes):
    """A batch axes tuple as a spec entry (``P(())`` is replicated)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def cache_spec(path: str, leaf, cfg: ModelConfig, sharder: Sharder,
               mesh) -> tuple:
    """Serving-cache leaf ``[L, B, S, ...]``: the batch over the batch
    axes and one inner dim over model (KV heads if divisible, else
    head_dim / latent / state heads), else replicated."""
    key = path.rsplit("/", 1)[-1]
    b = _batch_entry(sharder.batch_axes)
    m = sharder.model_axis          # None under the ddp layout
    shape = _shape(leaf)
    ndim = len(shape)

    def pick(idx_options):
        spec = [None] * ndim
        spec[1] = b
        for i in idx_options:
            if _div(shape[i], mesh, m):
                spec[i] = m
                break
        return tuple(spec)

    if key in ("k", "v"):            # [L, B, S, KV, hd]
        return pick([3, 4])
    if key == "c":                   # [L, B, S, R]
        return pick([3])
    if key == "kr":                  # [L, B, S, dr]
        return pick([3])
    if key == "s":                   # rwkv [L, B, H, N, N]
        return pick([2])
    if key == "ssm":                 # mamba [L, B, H, N, P]
        return pick([2])
    if key == "conv":                # [L, B, 3, C]
        return pick([3])
    if key in ("x_tm", "x_cm"):      # [L, B, D]
        return pick([2])
    return (None, b) + (None,) * (ndim - 2)


def cache_shardings(cache_shapes, cfg: ModelConfig, sharder: Sharder,
                    mesh):
    return _tree_map(lambda p, l: cache_spec(p, l, cfg, sharder, mesh),
                     cache_shapes)

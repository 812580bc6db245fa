"""Carry the solver's state between the JAX package and this port.

For this system the state is the ladder (a ``PrecisionConfig``'s fields),
the refinement policy (a ``RefineConfig``'s fields) and a cached factor:
the leaf-padded lower factor and, optionally, the stack of its
diagonal-tile inverses, or the packed tree factor (``TreeSPD``). They
cross as plain numpy arrays and field values, so neither package imports
the other: a factor computed by ``repro`` (``cholesky_padded`` +
``diag_tri_inv``, converted with ``numpy.asarray``) is solved by
:func:`repro_torch.solve_factored` after :func:`factor_from_numpy`, and a
port factor goes back through :func:`factor_to_numpy`. A reference
``TreeSPD`` (any object with ``diag1``, ``off``, ``off_scale``,
``diag2``, ``level``, ``n1`` and ``n``) becomes the port's through
:func:`treespd_from_reference` and goes back, as a ``TreeSPD`` of numpy
arrays, through :func:`treespd_to_numpy`.

For the model zoo the state is the parameter pytree: the reference's
(nested dicts of arrays, the layers stacked ``[L, ...]``) becomes the
port's (the same dicts, the layers a list) through
:func:`model_params_from_reference`, bit for bit, and back through
:func:`model_params_to_numpy`.

For training it is also the optimizer's state:
:func:`opt_state_from_reference` takes the reference's AdamW state
(moments shaped as the parameters, a count) or TreeNewton state (AdamW's,
and the statistics and factors of each eligible matrix, stacked
``(L, nb, block, block)`` for the layers) and gives the port's (moments
per layer, statistics and factors per path ``layers/<i>/...`` as
``(nb, block, block)``, host integer counts); :func:`opt_state_to_numpy`
goes back, the layers stacked again.

Onto a device mesh: :func:`place_params` places the reference's numpy
parameters, or the port's own, by ``launch.sharding.param_spec``; every
rank holds the whole tensors and keeps its shard of each (no collective),
a ``DTensor``. :func:`place_batch` places a batch by ``batch_shardings``
and :func:`place_caches` the serving caches by ``cache_spec``.

A whole train state (``params``, ``opt``, ``step``) crosses through
:func:`train_state_layout`: the state in the reference's layout (its
names, the layers stacked) without a copy, each stacked leaf a
:class:`~repro_torch.checkpoint.Stacked` view of the per-layer tensors and
the counts host integers. :func:`repro_torch.checkpoint.save` of it
builds each stack on the host layer by layer, in one array, and
:func:`~repro_torch.checkpoint.restore_into` copies a stored state back
into the tensors; :func:`train_state_from_layout` then takes the
restored counts. So the training drivers of both packages read each
other's checkpoints, and no ``ml_dtypes`` is needed for bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import Stacked
from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.refine import RefineConfig
from repro_torch.core.solve import as_tensor
from repro_torch.core.treematrix import TreeSPD
from repro_torch.models.transformer import _check_family


def config_from_fields(levels, leaf=256, quantize=True,
                       storage_rounding=True, engine="blocked"):
    """A port config from the fields of a reference config (for example
    ``dataclasses.asdict(cfg)`` without ``kernel_impl``)."""
    return PrecisionConfig(levels=tuple(levels), leaf=int(leaf),
                           quantize=bool(quantize),
                           storage_rounding=bool(storage_rounding),
                           engine=str(engine))


def refine_config_from_fields(**fields):
    """A port ``RefineConfig`` from the fields of a reference one (for
    example ``dataclasses.asdict(rcfg)``). ``residual_dtype=None`` means
    f32 here, where the reference reads JAX's x64 switch: pass "f64" for a
    reference run under x64."""
    return RefineConfig(**fields)


def factor_from_numpy(l, linvs=None, *, device="cuda"):
    """``(l, linvs)`` as tensors on ``device`` (``linvs`` may be None)."""
    lt = as_tensor(np.asarray(l), device)
    lv = None if linvs is None else as_tensor(np.asarray(linvs), device)
    return lt, lv


def factor_to_numpy(l, linvs=None):
    """``(l, linvs)`` as numpy arrays (``linvs`` may be None)."""
    def host(t):
        return None if t is None else t.detach().to("cpu").numpy()
    return host(l), host(linvs)


def _tensor(x, device):
    """numpy.asarray(x) as a tensor, bit for bit. numpy has no bfloat16 of
    its own: the ml_dtypes array that JAX hands out is carried through its
    16-bit pattern."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return as_tensor(arr.view(np.int16), device).view(torch.bfloat16)
    return as_tensor(arr, device)


def _array(t):
    """A tensor as numpy, bit for bit (bfloat16 as ml_dtypes.bfloat16,
    the type JAX reads, imported only for such a tensor)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def treespd_from_reference(t, *, device="cuda"):
    """A port :class:`~repro_torch.core.treematrix.TreeSPD` from a
    reference one (or from :func:`treespd_to_numpy`'s output): every
    array through ``numpy.asarray``, bit for bit, onto ``device``."""
    if not hasattr(t, "off"):
        return _tensor(t, device)
    return TreeSPD(treespd_from_reference(t.diag1, device=device),
                   _tensor(t.off, device), _tensor(t.off_scale, device),
                   treespd_from_reference(t.diag2, device=device),
                   level=int(t.level), n1=int(t.n1), n=int(t.n))


def treespd_to_numpy(t):
    """The same tree with numpy arrays in place of tensors (a leaf: one
    array)."""
    if not isinstance(t, TreeSPD):
        return _array(t)
    return TreeSPD(treespd_to_numpy(t.diag1), _array(t.off),
                   _array(t.off_scale), treespd_to_numpy(t.diag2),
                   level=t.level, n1=t.n1, n=t.n)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


#: the reference's top-level keys whose leaves are stacked by layer
_STACKED = ("dense_layers", "layers")


def model_params_from_reference(params, cfg, device="cuda"):
    """The port's parameters (:mod:`repro_torch.models.transformer`) from
    a reference pytree of ``repro.models.transformer.init_params``, given
    as nested dicts of arrays (numpy, or anything ``numpy.asarray``
    takes; bf16 crosses through its 16-bit pattern). The stacked
    ``layers`` (and moe's ``dense_layers``) leaves ``[L, ...]`` are split
    into per-layer dicts; a layer's expert stacks ``[E, d, F]`` stay
    stacked and the router stays f32. Every family: rwkv's layers carry
    ``mu`` [5, d], ``mu_c`` [2, d] and ``u`` [H, N]; the hybrid's mamba
    layers ``A_log``, ``D`` and ``dt_bias`` [H], and its ``shared_attn``
    (one layer, not stacked) stays one dict."""
    _check_family(cfg)
    out = {k: _map(lambda a: _tensor(a, device), v)
           for k, v in params.items() if k not in _STACKED}
    for key in _STACKED:
        if key not in params:
            continue
        stacked = _map(lambda a: _tensor(a, device), params[key])
        n = next(iter(_ref_paths(stacked).values())).shape[0]
        out[key] = [_map(lambda t, i=i: t[i], stacked) for i in range(n)]
    return out


def _ref_paths(tree, prefix=""):
    """``{path: leaf}`` of a reference pytree of nested dicts, ``None``
    leaves skipped."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {} if tree is None else {prefix: tree}


def _unstack_paths(flat, device):
    """Reference paths -> the port's: a stacked ``layers/x`` (or
    ``dense_layers/x``) becomes ``layers/<i>/x`` for each of its own
    layers."""
    out = {}
    for path, arr in flat.items():
        t = _tensor(arr, device)
        key, _, rest = path.partition("/")
        if key in _STACKED and rest:
            for i in range(t.shape[0]):
                out[f"{key}/{i}/{rest}"] = t[i]
        else:
            out[path] = t
    return out


def _by_layer(flat):
    """The port's ``{path: tensor}`` under the reference's paths:
    ``({path: tensor}, {path: [tensor of each layer, in order]})``, the
    second for the stacked keys' leaves."""
    out, layered = {}, {}
    for path, t in flat.items():
        parts = path.split("/")
        if parts[0] in _STACKED:
            layered.setdefault("/".join([parts[0]] + parts[2:]), []).append(
                (int(parts[1]), t))
        else:
            out[path] = t
    return out, {p: [t for _, t in sorted(items, key=lambda it: it[0])]
                 for p, items in layered.items()}


def _restack_paths(flat):
    """The port's paths -> the reference's, the layers stacked again, as
    numpy."""
    out, layered = _by_layer(flat)
    return {**{p: _array(t) for p, t in out.items()},
            **{p: _array(torch.stack(ts)) for p, ts in layered.items()}}


def _nest(flat):
    out: dict = {}
    for path, arr in flat.items():
        *keys, last = path.split("/")
        d = out
        for k in keys:
            d = d.setdefault(k, {})
        d[last] = arr
    return out


def model_params_to_numpy(params):
    """The port's parameters as the reference's pytree (nested dicts of
    numpy arrays, the layers stacked ``[L, ...]``; bf16 as
    ``ml_dtypes.bfloat16``), bit for bit."""
    from repro_torch.optim.adamw import leaves
    return _nest(_restack_paths(dict(leaves(params))))


def _adam_from_reference(st, cfg, device):
    def tree(t):
        return model_params_from_reference(t, cfg, device=device)
    return {"m": tree(st["m"]), "v": tree(st["v"]),
            "count": int(np.asarray(st["count"]))}


def opt_state_from_reference(state, params_ref, cfg, device="cuda"):
    """The port's optimizer state from the reference's (``adamw.init`` /
    ``kfac.init`` or a later step of either; arrays as anything
    ``numpy.asarray`` takes). ``params_ref`` is the reference's parameter
    pytree, whose structure the statistics follow; ``cfg`` the model's
    config."""
    if "stats" not in state:
        return _adam_from_reference(state, cfg, device)
    keep = set(_ref_paths(params_ref))

    def mats(tree):
        flat = {p: a for p, a in _ref_paths(tree).items() if p in keep}
        return {p: t.clone() for p, t in
                _unstack_paths(flat, device).items()}
    return {"adam": _adam_from_reference(state["adam"], cfg, device),
            "stats": mats(state["stats"]), "factors": mats(state["factors"]),
            "count": int(np.asarray(state["count"]))}


def opt_state_to_numpy(state):
    """The port's optimizer state in the reference's layout, as numpy:
    AdamW's moments as parameter pytrees (:func:`model_params_to_numpy`),
    TreeNewton's statistics and factors as ``{reference path: (L, nb,
    block, block) array}``, the counts as ints."""
    def adam(st):
        return {"m": model_params_to_numpy(st["m"]),
                "v": model_params_to_numpy(st["v"]), "count": st["count"]}
    if "stats" not in state:
        return adam(state)
    return {"adam": adam(state["adam"]),
            "stats": _restack_paths(state["stats"]),
            "factors": _restack_paths(state["factors"]),
            "count": state["count"]}


def _layout(flat):
    """The port's ``{path: tensor}`` as the reference's nested dicts, the
    layers' leaves as Stacked views in layer order."""
    out, layered = _by_layer(flat)
    return _nest({**out, **{p: Stacked(ts) for p, ts in layered.items()}})


def train_state_layout(state):
    """The port's train state ``{"params", "opt", "step"}`` in the
    reference's layout, sharing the state's tensors: parameters and AdamW
    moments as the reference's parameter pytree, TreeNewton's statistics
    and factors as pytrees of its eligible leaves (``(L, nb, block,
    block)`` stacks), ``step`` and the counts as host integers."""
    from repro_torch.optim.adamw import leaves

    def tree(t):
        return _layout(dict(leaves(t)))

    def adam(st):
        return {"m": tree(st["m"]), "v": tree(st["v"]),
                "count": st["count"]}
    opt = state["opt"]
    if "stats" in opt:
        opt = {"adam": adam(opt["adam"]), "stats": _layout(opt["stats"]),
               "factors": _layout(opt["factors"]), "count": opt["count"]}
    else:
        opt = adam(opt)
    return {"params": tree(state["params"]), "opt": opt,
            "step": state["step"]}


def train_state_from_layout(layout, state):
    """``state`` with the host integers of a restored
    :func:`train_state_layout` (``step`` and the optimizer's counts); its
    tensors were restored in place."""
    state["step"] = layout["step"]
    opt, lo = state["opt"], layout["opt"]
    if "stats" in opt:
        opt["adam"]["count"] = lo["adam"]["count"]
    opt["count"] = lo["count"]
    return state


__all__ = ["config_from_fields", "factor_from_numpy", "factor_to_numpy",
           "model_params_from_reference", "model_params_to_numpy",
           "opt_state_from_reference", "opt_state_to_numpy",
           "refine_config_from_fields", "train_state_from_layout",
           "train_state_layout", "treespd_from_reference",
           "treespd_to_numpy"]


# ---------------------------------------------------------------------------
# onto a device mesh
# ---------------------------------------------------------------------------
def _shard_of(t, spec, mesh):
    """This rank's block of a whole tensor ``t`` under ``spec``: a
    dimension over axes (a, b, ...) is cut into prod(sizes) blocks, the
    rank's block index read major to minor over those axes."""
    from repro_torch.launch.sharding import mesh_shape
    shape = mesh_shape(mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = 0, 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            idx = idx * shape[a] + mesh.get_local_rank(a)
            n *= shape[a]
        w = t.shape[d] // n
        t = t.narrow(d, idx * w, w)
    return t.contiguous()


def _placed(t, spec, mesh):
    """``t`` (a whole tensor or a DTensor) placed by ``spec``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.sharding import placements
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements(spec, mesh))
    return DTensor.from_local(_shard_of(t, spec, mesh), mesh,
                              placements(spec, mesh), run_check=False)


def _tree_placed(tree, spec_of, mesh):
    """Each leaf of ``tree`` placed by ``spec_of(path, leaf)``."""
    from repro_torch.launch.sharding import _tree_map
    return _tree_map(lambda p, t: _placed(t, spec_of(p, t), mesh), tree)


def place_params(params, cfg, mesh, *, layout: str = "tp", device="cuda"):
    """The parameters as DTensors on ``mesh``, each leaf placed by
    ``param_spec``. ``params`` is the port's pytree, or the reference's
    (numpy leaves, layers stacked), which :func:`model_params_from_reference`
    brings to ``device`` first. Every rank calls it with the same
    parameters."""
    from repro_torch.launch.sharding import param_spec
    if not torch.is_tensor(params["embed"]):
        params = model_params_from_reference(params, cfg, device)
    return _tree_placed(
        params, lambda p, t: param_spec(p, t, cfg, mesh, layout), mesh)


def place_batch(batch, sharder, *, accum: int = 1):
    """A batch (``tokens``, and ``patch_embeds`` or ``labels``) as DTensors
    placed by ``batch_shardings``; every rank holds the whole batch."""
    from repro_torch.launch.sharding import batch_shardings
    specs = batch_shardings(batch, sharder, sharder.mesh, accum)
    return {k: _placed(torch.as_tensor(v), specs[k], sharder.mesh)
            for k, v in batch.items()}


def place_caches(caches, cfg, sharder):
    """Serving caches (``[L, B, S, ...]`` leaves, DTensors or whole
    tensors) placed by ``cache_spec``."""
    from repro_torch.launch.sharding import cache_spec
    return _tree_placed(
        caches, lambda p, t: cache_spec(p, t, cfg, sharder, sharder.mesh),
        sharder.mesh)

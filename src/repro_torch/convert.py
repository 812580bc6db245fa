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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.refine import RefineConfig
from repro_torch.core.solve import as_tensor
from repro_torch.core.treematrix import TreeSPD


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


__all__ = ["config_from_fields", "factor_from_numpy", "factor_to_numpy",
           "refine_config_from_fields", "treespd_from_reference",
           "treespd_to_numpy"]

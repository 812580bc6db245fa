"""Carry the solver's state between the JAX package and this port.

For this system the state is the ladder (a ``PrecisionConfig``'s fields),
the refinement policy (a ``RefineConfig``'s fields) and a cached factor:
the leaf-padded lower factor and, optionally, the stack of its
diagonal-tile inverses. They cross as plain numpy arrays and field
values, so neither package imports the other: a factor computed by
``repro`` (``cholesky_padded`` + ``diag_tri_inv``, converted with
``numpy.asarray``) is solved by :func:`repro_torch.solve_factored` after
:func:`factor_from_numpy`, and a port factor goes back through
:func:`factor_to_numpy`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.precision import PrecisionConfig
from repro_torch.core.refine import RefineConfig
from repro_torch.core.solve import as_tensor


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


__all__ = ["config_from_fields", "factor_from_numpy", "factor_to_numpy",
           "refine_config_from_fields"]

"""The port's factor and solve, the slice as a whole, against the JAX
reference on the CPU (leaf 128, n <= 1024).

Each reference factor is computed once per ladder, at the ragged n = 900
(padded to 1024, eight tile columns, so every level of the deeper ladders
occurs), and shared by the tests that need it; the reference's factor
costs most of this file's time. At n = 512 the port's factor is held to
its backward error instead. Tolerances are the reference suite's own:
``_TOL`` of tests/test_blocked.py, keyed by the ladder's coarsest level.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro_torch import convert

torch.set_num_threads(2)

_TOL = {"f16": 5e-3, "bf16": 4e-2, "int8": 4e-2, "f32": 5e-6, "f64": 1e-12}
CONFIGS = [k for k in tc.PAPER_CONFIGS if "f64" not in k]
LEAF = 128


def spd(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, (n, n))
    return (m @ m.T + n * np.eye(n)).astype(dtype)


def _cfgs(name):
    return (dataclasses.replace(rc.PAPER_CONFIGS[name], leaf=LEAF),
            dataclasses.replace(tc.PAPER_CONFIGS[name], leaf=LEAF))


@functools.lru_cache(maxsize=None)
def _reference(name, n):
    """The reference's padded factor and diagonal inverses, as numpy."""
    cr, _ = _cfgs(name)
    lp = rc.cholesky_padded(spd(n, n), cr)
    return np.array(lp), np.array(rc.diag_tri_inv(lp, cr))


@functools.lru_cache(maxsize=None)
def _port(name, n):
    _, ct = _cfgs(name)
    return tc.cholesky_padded(spd(n, n), ct, device="cpu")


@functools.lru_cache(maxsize=None)
def _port_tight(name, n):
    """The port's factor through the ``cholesky`` entry point."""
    return tc.cholesky(spd(n, n), _cfgs(name)[1], device="cpu")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("n", [900])
def test_factor_matches_reference(name, n):
    lr = _reference(name, n)[0][:n, :n].astype(np.float64)
    lt = _port_tight(name, n)
    assert lt.shape == (n, n)
    lt = lt.double().numpy()
    assert np.isfinite(lt).all()          # ragged int8 included
    rel = np.abs(lt - lr).max() / np.abs(lr).max()
    assert rel < _TOL[tc.PAPER_CONFIGS[name].levels[0]], (rel, name)
    assert np.abs(np.triu(lt, 1)).max() == 0.0


@pytest.mark.parametrize("name", CONFIGS)
def test_factor_backward_error(name):
    """At n = 512 (no padding): max|L L^T - A| / max|A| within the
    ladder's _TOL, and the tight factor is the padded one exactly."""
    n = 512
    lt = _port_tight(name, n)
    assert torch.equal(lt, _port(name, n))
    a = spd(n, n).astype(np.float64)
    l = lt.double().numpy()
    rel = np.abs(l @ l.T - a).max() / np.abs(a).max()
    assert rel < _TOL[tc.PAPER_CONFIGS[name].levels[0]], (rel, name)


_RHS = np.random.default_rng(4).standard_normal((900, 4)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference_solve(name):
    """The reference's solve of _RHS with its own factor (what its
    cholesky_solve computes)."""
    cr, _ = _cfgs(name)
    lp, linvs = _reference(name, 900)
    return np.asarray(rc.solve_factored(jnp.asarray(lp), jnp.asarray(_RHS),
                                        cr, linvs=jnp.asarray(linvs)),
                      np.float64)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("nrhs", [1, 4])
def test_solve_matches_reference(name, nrhs):
    """cholesky_solve on the ragged n = 900 with a vector (k = 1) and a
    block (k = 4) right-hand side; the vector is column 0 of the block,
    and the reference's solve is column-wise, so one reference solve
    serves both."""
    n = 900
    ct = _cfgs(name)[1]
    b = _RHS if nrhs > 1 else _RHS[:, 0]
    xr = _reference_solve(name)
    xr = xr if nrhs > 1 else xr[:, 0]
    xt = tc.cholesky_solve(spd(n, n), b, ct, device="cpu")
    assert xt.shape == b.shape
    xt = xt.double().numpy()
    rel = np.abs(xt - xr).max() / np.abs(xr).max()
    assert rel < _TOL[ct.levels[0]], rel
    # the port's residual against the reference's own on the same system:
    # twice it, plus a few f32 ulps for the f32 ladder's rounding noise
    a = spd(n, n).astype(np.float64)
    res = np.abs(a @ xt - b).max() / np.abs(b).max()
    res_ref = np.abs(a @ xr - b).max() / np.abs(b).max()
    assert res <= 2 * res_ref + 8 * np.finfo(np.float32).eps, (res, res_ref)


@pytest.mark.parametrize("name", CONFIGS)
def test_pad_factor_exact(name):
    """pad_factor(cholesky(a)) == cholesky(pad_spd(a)), exactly."""
    n = 900
    ct = _cfgs(name)[1]
    l = _port_tight(name, n)
    a_p, _ = tc.pad_spd(torch.from_numpy(spd(n, n)), LEAF)
    full = tc.cholesky(a_p, ct)
    lp = tc.pad_factor(l, LEAF)
    assert lp.shape == (1024, 1024)
    assert torch.equal(lp, full)
    assert torch.equal(full, _port(name, n))
    assert tc.pad_factor(full, LEAF) is full


def test_f64_ladder_matches_reference():
    n = 256
    a = spd(n, 5, np.float64)
    cr = dataclasses.replace(rc.PAPER_CONFIGS["f32x3_f64"], leaf=LEAF)
    ct = dataclasses.replace(tc.PAPER_CONFIGS["f32x3_f64"], leaf=LEAF)
    b = np.random.default_rng(2).standard_normal((n, 2))
    with jax.enable_x64():
        lr = np.asarray(rc.cholesky(jnp.asarray(a), cr))
        xr = np.asarray(rc.cholesky_solve(jnp.asarray(a), jnp.asarray(b),
                                          cr))
    assert lr.dtype == np.float64
    lt = tc.cholesky(a, ct, device="cpu")
    assert lt.dtype == torch.float64
    rel = np.abs(lt.numpy() - lr).max() / np.abs(lr).max()
    assert rel < _TOL["f32"], rel
    xt = tc.cholesky_solve(a, b, ct, device="cpu").numpy()
    assert np.abs(xt - xr).max() / np.abs(xr).max() < 10 * _TOL["f32"]


@pytest.mark.parametrize("name", ["bf16_f32", "f16x3_f32", "int8_f32"])
def test_reference_factor_solved_by_port(name):
    """A factor made by repro (cholesky_padded + diag_tri_inv) is carried
    over as numpy and solved by the port, and the reverse."""
    n = 900
    cr, ct = _cfgs(name)
    b = _RHS
    lp, linvs = _reference(name, n)
    fields = dataclasses.asdict(cr)
    fields.pop("kernel_impl")
    assert convert.config_from_fields(**fields) == ct
    l_t, linvs_t = convert.factor_from_numpy(lp, linvs, device="cpu")
    xr = _reference_solve(name)
    xt = tc.solve_factored(l_t, b, ct, linvs=linvs_t, device="cpu").numpy()
    np.testing.assert_allclose(xt, xr, rtol=1e-4, atol=1e-5)
    # and the port's factor solved by the reference
    lp_t, linvs_t = convert.factor_to_numpy(
        _port(name, n), tc.diag_tri_inv(_port(name, n), ct))
    xr2 = np.asarray(rc.solve_factored(jnp.asarray(lp_t), jnp.asarray(b),
                                       cr, linvs=jnp.asarray(linvs_t)))
    xt2 = tc.solve_factored(torch.from_numpy(lp_t), b, ct,
                            device="cpu").numpy()
    np.testing.assert_allclose(xr2, xt2, rtol=1e-4, atol=1e-5)


def test_logdet_matches_reference():
    lp = _reference("pure_f32", 900)[0]
    want = float(rc.logdet(jnp.asarray(lp)))
    got = float(tc.logdet(torch.from_numpy(lp)))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_solve_reuses_linvs_bitwise():
    name, n = "bf16_f32", 512
    ct = _cfgs(name)[1]
    b = np.random.default_rng(3).standard_normal((n, 3)).astype(np.float32)
    lp = _port(name, n)
    x1 = tc.cholesky_solve(None, b, ct, l=lp, device="cpu")
    x2 = tc.solve_factored(lp, b, ct, linvs=tc.diag_tri_inv(lp, ct),
                           device="cpu")
    assert torch.equal(x1, x2)

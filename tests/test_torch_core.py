"""The torch port's ladder, quantization and plan against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages; the
reference runs on the CPU. Quantization and plans must agree exactly.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import quantize as rq
import repro_torch.core as tc
from repro_torch.core import quantize as tq

torch.set_num_threads(2)

LADDER_NAMES = ("int8", "f16", "bf16", "f32")


def _block(seed, scale):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((256, 256)) * scale).astype(np.float32)


def _bits(x):
    """f32 bit pattern of a jax array or torch tensor (exact widening)."""
    if torch.is_tensor(x):
        x = x.to(torch.float32).numpy()
    else:
        x = np.asarray(jnp.asarray(x, jnp.float32))
    return np.ascontiguousarray(x).view(np.uint32)


@pytest.mark.parametrize("name", LADDER_NAMES)
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("scale", [1.0, 3e5])
def test_storage_round_bitwise(name, quantize, scale):
    """storage_round agrees bit for bit, including the f16 overflow
    range (scale 3e5 > 65504) with and without per-block scaling."""
    x = _block(7, scale)
    want = rq.storage_round(jnp.asarray(x), name, quantize)
    got = tq.storage_round(torch.from_numpy(x), name, quantize)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", LADDER_NAMES)
@pytest.mark.parametrize("enable", [True, False])
def test_quant_block_bitwise(name, enable):
    x = _block(8, 1e5)
    qr, ar = rq.quant_block(jnp.asarray(x), name, enable)
    qt, at = tq.quant_block(torch.from_numpy(x), name, enable)
    assert qt.dtype == tc.DTYPES[name]
    np.testing.assert_array_equal(_bits(qt), _bits(qr))
    assert float(at) == float(ar)


def test_quant_int8_roundtrip_bitwise():
    x = _block(9, 2.0)
    qr, sr = rq.quant_int8(jnp.asarray(x))
    qt, st = tq.quant_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    assert float(st) == float(sr)
    np.testing.assert_array_equal(
        _bits(tq.dequant_int8(qt, st)), _bits(rq.dequant_int8(qr, sr)))


@pytest.mark.parametrize("name", list(tc.PAPER_CONFIGS))
def test_config_fields_match(name):
    r, t = rc.PAPER_CONFIGS[name], tc.PAPER_CONFIGS[name]
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    for n in (256, 1024, 5000):
        assert r.depth(n) == t.depth(n)
    for lv in range(6):
        assert r.name_at(lv) == t.name_at(lv)
        assert r.needs_quant(lv) == t.needs_quant(lv)


@pytest.mark.parametrize("name", list(tc.PAPER_CONFIGS))
@pytest.mark.parametrize("ntiles", [1, 4, 7, 12])
def test_plan_identical(name, ntiles):
    """levels, store_levels, every panel_meta(p) and every comm_table()
    are identical to the reference's (plans are pure geometry, so the
    f64 ladders need no x64 here)."""
    cr = dataclasses.replace(rc.PAPER_CONFIGS[name], leaf=128)
    ct = dataclasses.replace(tc.PAPER_CONFIGS[name], leaf=128)
    pr, pt = rc.build_plan(ntiles * 128, cr), tc.build_plan(ntiles * 128, ct)
    np.testing.assert_array_equal(pr.levels, pt.levels)
    np.testing.assert_array_equal(pr.store_levels, pt.store_levels)
    for p in range(ntiles):
        assert (dataclasses.astuple(pr.panel_meta(p))
                == dataclasses.astuple(pt.panel_meta(p)))
    for s in (1, 2, 4):
        if ntiles % s == 0:
            assert rc.shard(pr, s).comm_table() == tc.shard(pt, s).comm_table()
    assert pr.describe() == pt.describe()
    assert pr.expected_dot_flops() == pt.expected_dot_flops()


def test_kernel_impl_only_auto():
    tc.PrecisionConfig(kernel_impl="auto")
    with pytest.raises(ValueError):
        tc.PrecisionConfig(kernel_impl="jnp")


def test_pad_spd_matches_reference():
    rng = np.random.default_rng(2)
    m = rng.uniform(-1, 1, (300, 300))
    a = ((m @ m.T + 300 * np.eye(300)) * 64.0).astype(np.float32)
    want, n = rc.pad_spd(jnp.asarray(a), 128)
    got, nt = tc.pad_spd(torch.from_numpy(a), 128)
    assert n == nt == 300 and got.shape == (384, 384)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_import_has_no_jax():
    """repro_torch imports neither jax nor the JAX package."""
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.serve; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; "
            "assert not bad, bad")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_default_device_without_gpu_raises(monkeypatch):
    """With no CUDA device, the default device='cuda' raises rather than
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.eye(128, dtype=np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        tc.cholesky(a)
    with pytest.raises(RuntimeError, match="cuda"):
        tc.cholesky_solve(a, np.ones(128, np.float32))


@pytest.mark.parametrize("engine", ["tree", "auto"])
def test_unported_engines_raise(engine):
    cfg = tc.PrecisionConfig(leaf=128, engine=engine)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tc.cholesky(np.eye(128, dtype=np.float32), cfg, device="cpu")


def test_refine_raises():
    """Refinement is ported: cholesky_solve(refine=) is refine_solve's x,
    bitwise (the test keeps the name of the one that pinned the raise)."""
    rng = np.random.default_rng(3)
    m = rng.standard_normal((128, 128))
    a = (m @ m.T + 128 * np.eye(128)).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    cfg = tc.PrecisionConfig(leaf=128)
    x = tc.cholesky_solve(a, b, cfg, refine=2, device="cpu")
    assert torch.equal(x, tc.refine_solve(a, b, cfg, refine=2,
                                          device="cpu").x)

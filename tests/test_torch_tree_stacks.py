"""The tree engine on a stack of matrices (``core/tree.py`` with (N, n, n)
operands, n above the leaf) against the reference under ``jax.vmap``,
on the CPU.

The reference's leaf must be a multiple of 128, so the stack is
(3, 512, 512) at leaf 128: two levels of the recursion, so each node's
batched GEMM and each leaf's right solve and SYRK on a stack run.
Tolerances are test_torch_tree.py's ``_TOL`` (tests/test_blocked.py's,
keyed by the ladder's coarsest level). Each entry of the stack is also
held bitwise to the port's 2-D factor of that matrix: the stack runs the
same plain versions per matrix. On the card ``chip_smoke.py``'s
``tree_stacks`` line holds the kernels' stack to the same.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.optim import kfac as rkfac
import repro_torch.core as tc
from repro_torch.optim import kfac as tkfac

torch.set_num_threads(2)

_TOL = {"f16": 5e-3, "bf16": 4e-2, "int8": 4e-2, "f32": 5e-6, "f64": 1e-12}
CONFIGS = [k for k in tc.PAPER_CONFIGS if "f64" not in k]
N, n, LEAF = 3, 512, 128


def _stack(seed, count=N, size=n):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, (count, size, size))
    a = (m + m.transpose(0, 2, 1)) / 2 + size * np.eye(size)
    return a.astype(np.float32)


def _cfgs(name):
    return (dataclasses.replace(rc.PAPER_CONFIGS[name], leaf=LEAF,
                                engine="tree"),
            dataclasses.replace(tc.PAPER_CONFIGS[name], leaf=LEAF,
                                engine="tree"))


@pytest.mark.parametrize("name", CONFIGS)
def test_tree_potrf_stack_matches_vmapped_reference(name):
    a = _stack(0)
    rcfg, tcfg = _cfgs(name)
    want = np.asarray(jax.vmap(lambda m: rc.tree_potrf(m, rcfg))(
        jnp.asarray(a)), np.float64)
    got = tc.tree_potrf(torch.from_numpy(a), tcfg)
    assert got.shape == (N, n, n)
    g = got.double().numpy()
    assert np.isfinite(g).all() and np.abs(np.triu(g, 1)).max() == 0.0
    tol = _TOL[tc.PAPER_CONFIGS[name].levels[0]]
    for i in range(N):
        assert np.abs(g[i] - want[i]).max() / np.abs(want[i]).max() < tol
        one = tc.tree_potrf(torch.from_numpy(a[i]), tcfg)
        assert torch.equal(got[i], one), (name, i)


def _stats(rng, count, block):
    m = rng.standard_normal((count, block, 2 * block)).astype(np.float32)
    return np.einsum("bij,bkj->bik", m, m) / (2 * block)


@pytest.mark.parametrize("name", ["bf16_f32", "int8_f32"])
def test_refactor_tree_engine_matches_reference(name):
    """TreeNewton's refactor with engine="tree" at block 256 and leaf 128
    (blocks larger than the leaf: the stack recursion) against the
    reference's vmapped factor, within the ladder's tolerance of each
    block's largest entry."""
    a = _stats(np.random.default_rng(2), 3, 256)
    rcfg, tcfg = _cfgs(name)
    want = np.asarray(rkfac._refactor(jnp.asarray(a), rkfac.TreeNewtonConfig(
        block=256, precision=rcfg)), np.float64)
    got = tkfac._refactor(torch.from_numpy(a), tkfac.TreeNewtonConfig(
        block=256, precision=tcfg)).double().numpy()
    tol = _TOL[tc.PAPER_CONFIGS[name].levels[0]]
    for i in range(3):
        assert np.abs(got[i] - want[i]).max() / np.abs(want[i]).max() < tol

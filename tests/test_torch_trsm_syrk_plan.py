"""The planners of trsm_leaf and syrk_packed (plain Python), and a
plain-torch model of trsm_leaf's k-split against the reference's Pallas
kernel in interpret mode (CPU).

``kernels/trsm.py:plan`` and ``kernels/syrk.py:packed_plan`` choose a grid
and a route from the shape, the types and (syrk_packed) A's layout alone;
their chunks are whole 16-deep k-steps; every M the tree factor gives
trsm_leaf at leaf 256 fills about a wave of the H100's 132 SMs or says
why not. A trsm_leaf k-split adds its chunks' products in chunk order
(``trsm.work_items``); ``trsm.split_model`` computes that order in plain
torch, and here it is held against ``repro.kernels.trsm.trsm_leaf`` at the
tolerance the card test holds the kernel to
(tests/test_torch_kernels.py:test_trsm_leaf_kernel).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import qgemm, syrk, trsm

torch.set_num_threads(2)

#: the tree factor's trsm_leaf rows at n = 16384, leaf 256
_TREE_M = (256, 512, 1024, 2048, 4096, 8192)
_TYPES = {"f32": torch.float32, "f64": torch.float64, "f16": torch.float16,
          "bf16": torch.bfloat16, "int8": torch.int8}


# ---------------------------------------------------------------------------
# trsm_leaf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_trsm_plan_fills_the_card_at_tree_rows(dt):
    for m in _TREE_M:
        p = trsm.plan(m, 256, _TYPES[dt])
        assert p == trsm.plan(m, 256, _TYPES[dt])   # the shape alone
        assert p.route in trsm.ROUTES
        assert p.kc % trsm.SIMT_BK == 0 and p.kc > 0
        assert (p.chunks > 1) == (p.route == "simt_ksplit") == (p.kc < 256)
        items = trsm.work_items(256, p.tile[1], p.kc)
        assert p.ctas == -(-m // p.tile[0]) * len(items)
        assert p.ctas >= trsm.WAVE or p.reason, (m, p)
        assert (p.ctas >= trsm.WAVE) == (not p.reason), (m, p)


@pytest.mark.parametrize("n", [128, 256, 384, 200])
@pytest.mark.parametrize("kc", [16, 32, 64, 128, 1024])
def test_trsm_work_items_cover_the_lower_triangle(n, kc):
    """Each column block [n0, n1) gets chunks covering k in [0, n1) in
    order, heaviest blocks first; nothing above the diagonal block."""
    items = trsm.work_items(n, 64, kc)
    blocks = {}
    for n0, n1, k0, k1 in items:
        assert k1 <= n1 and k0 < k1 and (k0 % kc == 0)
        blocks.setdefault((n0, n1), []).append((k0, k1))
    starts = [n0 for n0, _ in blocks]
    assert starts == sorted(starts, reverse=True)
    assert sorted(blocks) == [(j, min(n, j + 64)) for j in range(0, n, 64)]
    for (n0, n1), ks in blocks.items():
        assert ks[0][0] == 0 and ks[-1][1] == n1
        assert all(a[1] == b[0] for a, b in zip(ks, ks[1:]))


def test_trsm_plan_takes_no_wide_f64_block():
    for m in _TREE_M:
        assert trsm.plan(m, 256, torch.float64).tile == trsm.MID


@pytest.mark.parametrize("m,n", [(256, 256), (1024, 256), (65, 384)])
def test_trsm_split_model_vs_reference(m, n):
    """The chunk-ordered sum of the plan's split against the reference's
    Pallas trsm_leaf (interpret mode) on the same inputs."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import trsm as rtrsm
    p = trsm.plan(m, n, torch.float32)
    assert p.route == "simt_ksplit"
    rng = np.random.default_rng(m + n)
    l = (np.tril(rng.standard_normal((n, n))).astype(np.float32)
         + 4 * np.sqrt(n) * np.eye(n, dtype=np.float32))
    linv = np.tril(np.linalg.inv(l.astype(np.float64))).astype(np.float32)
    b = rng.standard_normal((m, n)).astype(np.float32)
    want = np.asarray(rtrsm.trsm_leaf(jnp.asarray(b), linv=jnp.asarray(linv),
                                      interpret=True))
    got = trsm.split_model(torch.from_numpy(b), torch.from_numpy(linv), p)
    atol = 2 * (n + 1) * 2.0 ** -24 * float((np.abs(b) @ np.abs(linv).T).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    # upper triangle of Linv is not in the model's products
    dirty = torch.from_numpy(linv) + torch.triu(torch.full((n, n), 1e3), 1)
    assert torch.equal(trsm.split_model(torch.from_numpy(b), dirty, p), got)


# ---------------------------------------------------------------------------
# syrk_packed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,k", [(8192, 8192), (512, 256), (500, 513),
                                 (640, 300), (2048, 192)])
@pytest.mark.parametrize("dt", list(_TYPES))
def test_syrk_packed_routes(n, k, dt):
    adt = _TYPES[dt]
    cdt = torch.float64 if adt == torch.float64 else torch.float32
    esz = torch.empty((), dtype=adt).element_size()
    major = qgemm.layout(n, k, k, 1, esz)[0]
    p = syrk.packed_plan(n, k, adt, cdt, major)
    assert p == syrk.packed_plan(n, k, adt, cdt, major)
    if adt in syrk.TC_DTYPES:
        aligned = (k * esz) % 16 == 0
        assert p.route == ("tc" if aligned else "tc_staged")
        assert p.stage == (not aligned) and p.tile == syrk.TC_TILE
        t = -(-n // 256)
        assert p.ctas == t * (t + 1)
    else:
        assert p.route == "simt" and p.async_ == ((k * esz) % 16 == 0)
        b = p.tile[0]
        assert p.tile in ((64, 64), (128, 128))
        assert b == 64 or adt == torch.float32
        t = -(-n // b)
        assert p.ctas == t * (t + 1) // 2


def test_syrk_packed_f32_block_fills_a_wave():
    """128 x 128 blocks where their triangle holds a wave, else 64 x 64;
    an f64 accumulator always 64 x 64."""
    for n in (256, 1024, 1920, 2048, 8192):
        p = syrk.packed_plan(n, n, torch.float32, torch.float32, "k")
        t = -(-n // 128)
        assert p.tile[0] == (128 if t * (t + 1) // 2 >= syrk.WAVE else 64)
        assert syrk.packed_plan(n, n, torch.float32, torch.float64,
                                "k").tile == (64, 64)
    assert syrk.packed_plan(8192, 8192, torch.float32, torch.float32,
                            "k").ctas == 2080

"""panel_update's routes: the pair lists of :func:`repro_torch.kernels.panel.plan`
(geometry, on the CPU), a plain-torch model of the tensor-core route's
arithmetic against the JAX reference's oracle (on the CPU), and the kernel
on each route against the plain version (on a card).

The tensor-core route multiplies the pair name's codes (f16, bf16 or int8)
with exact products and applies the per-row-tile scales after the sum;
the reference multiplies the rounded values themselves. The model below
does the former in plain torch, so the CPU shows, before any card, that
the gate the card cases use (one grid unit of the pair's name times
max|ref|) admits that arithmetic and its other summation order.

The JAX reference is imported through the ``jx`` fixture only, so the
card cases (marker ``gpu``) also run where jax is missing:
``python -m pytest -m gpu tests/test_torch_panel.py``.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core.plan import build_plan
from repro_torch.core.precision import PAPER_CONFIGS, PrecisionConfig
from repro_torch.kernels import ops, panel
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

#: one unit of a name's grid, relative to the tile's scale
#: (tests/test_torch_kernels.py:_GRID)
_GRID = {"int8": 1 / 127, "f16": 2.0 ** -10, "bf16": 2.0 ** -7, "f32": 1e-5,
         "f64": 1e-12}
_CODE_DT = {"f16": torch.float16, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture(scope="module")
def jx():
    """jax.numpy and the reference's oracles (repro.kernels.ref)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref
    return types.SimpleNamespace(jnp=jnp, ref=ref)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# geometry (CPU)
# ---------------------------------------------------------------------------
def _check_plan(cfg, n, p, b=None):
    """Checks of one panel's plan at leaf b (the config's by default: the
    pair names do not depend on b)."""
    meta = build_plan(n, cfg).panel_meta(p)
    b, dtype = b or cfg.leaf, cfg.high_dtype
    nt = len(meta.pair_names)
    pl = panel.plan(meta.pair_names, meta.pair_quants, dtype, b, True)
    names = [s[0] for s in pl.slots]
    assert names == sorted({nm for row in meta.pair_names for nm in row})
    for (nm, quant, code, kind), pairs in zip(pl.slots, pl.tc_pairs):
        assert code == panel.rcode(nm, quant)
        on_tc = (dtype == torch.float32 and nm in panel.TC_NAMES
                 and b in panel.TC_LEAVES)
        ident = nm == "f64" or (nm == "f32" and dtype == torch.float32)
        assert kind == (panel.KIND[nm] if on_tc else
                        panel.KIND["self" if ident else "simt"])
        assert not pairs or on_tc
    seen = {}
    for s, pairs in enumerate(pl.tc_pairs):
        for (i, j) in pairs:
            seen[(i, j)] = seen.get((i, j), 0) + 1
            nm, quant = meta.pair_names[i][j], meta.pair_quants[i][j]
            assert pl.slots[s][:2] == (nm, quant)
            assert panel.route(nm, dtype, b) == "tc"
    nsub = (b // panel.simt_tile(dtype, b)) ** 2
    subs = {}
    for (i, j, s, code, sub) in pl.simt_items:
        nm, quant = meta.pair_names[i][j], meta.pair_quants[i][j]
        assert pl.slots[s][:3] == (nm, quant, code)
        assert panel.route(nm, dtype, b) == "simt"
        if sub == panel.SUB_ALL:
            assert panel.scaled(nm, quant)
            subs.setdefault((i, j), []).extend(range(nsub))
        else:
            assert not panel.scaled(nm, quant)
            subs.setdefault((i, j), []).append(sub)
    for key, got in subs.items():
        assert sorted(got) == list(range(nsub)), key
        seen[key] = seen.get(key, 0) + 1
    lower = {(i, j) for i in range(nt) for j in range(i + 1)}
    assert set(seen) == lower and set(seen.values()) == {1}
    tc = sum(len(p) for p in pl.tc_pairs)
    assert pl.routes == {"tc": tc, "simt": len(lower) - tc}
    return pl


@pytest.mark.parametrize("leaf", [256, 128])
@pytest.mark.parametrize("ladder", sorted(PAPER_CONFIGS))
def test_panel_routes_cover_each_pair_once(ladder, leaf):
    """Every lower pair of a panel is on exactly one route, with the
    plan's name and scaled flag; f16, bf16 and int8 pairs of an f32
    container take the tensor cores at the main path's leaf 256 and the
    tests' 128, and nothing else does. Panels 0, the middle one and the
    last but one of n = 16384."""
    cfg = dataclasses.replace(PAPER_CONFIGS[ladder], leaf=leaf)
    T = 16384 // leaf
    for p in (0, T // 2, T - 2):
        pl = _check_plan(cfg, 16384, p)
        narrow = any(nm in panel.TC_NAMES for nm in cfg.levels)
        if cfg.high_dtype == torch.float32 and narrow and p == 0:
            assert pl.routes["tc"] > 0


@pytest.mark.parametrize("levels", [("int8", "f32"), ("f16", "f32"),
                                    ("f32", "f64")])
def test_panel_routes_other_leaves_take_the_cuda_cores(levels):
    """b = 384, 192 or 64 (the wrapper takes b % 64 == 0): every pair on
    the CUDA cores, counted there; a scaled name (int8, quantized f16) is
    one whole-tile item."""
    cfg = PrecisionConfig(levels=levels, leaf=384)
    for b in (384, 192, 64):
        pl = _check_plan(cfg, 384 * 9, 0, b)
        assert pl.routes["tc"] == 0 and pl.routes["simt"] == 36


def test_panel_plan_copies_l21_where_it_cannot_be_read_in_place():
    """An identity name (f32 in f32) reads L21 in place (no copy) unless
    L21's rows are not 16-byte aligned; the pairs and routes are the
    same either way."""
    meta = build_plan(256 * 5, PAPER_CONFIGS["f16x3_f32"]).panel_meta(0)
    args = (meta.pair_names, meta.pair_quants, torch.float32, 256, True)
    here, copy = panel.plan(*args, True), panel.plan(*args, False)
    kinds = {s[0]: s[3] for s in here.slots}
    assert kinds["f32"] == panel.KIND["self"]
    assert {s[0]: s[3] for s in copy.slots}["f32"] == panel.KIND["simt"]
    assert (here.tc_pairs, here.simt_items, here.routes) == (
        copy.tc_pairs, copy.simt_items, copy.routes)


# ---------------------------------------------------------------------------
# the tensor-core route's arithmetic (CPU)
# ---------------------------------------------------------------------------
def _codes(l21, name, quant, b):
    """The tc route's copy of L21 at a pair name: codes in the name's type
    and one f32 scale per row tile (csrc/panel.cu: tile_codes)."""
    tiles = l21.reshape(-1, b, b)
    if name == "bf16":
        return tiles.to(torch.bfloat16), torch.ones(tiles.shape[0])
    amax = tiles.abs().amax(dim=(1, 2))
    if name == "int8":
        alpha = torch.clamp_min(amax, 1e-30) / 127.0
        q = torch.clamp(torch.round(tiles / alpha[:, None, None]), -127, 127)
        return q.to(torch.int8), alpha
    alpha = (torch.clamp_min(amax / 65504.0, 1.0) if quant
             else torch.ones(tiles.shape[0]))
    return (tiles / alpha[:, None, None]).to(torch.float16), alpha


def _tc_model(linv, a21, c, *, store_names, store_quants, pair_names,
              pair_quants, rounding=True):
    """panel_update with every f16, bf16 and int8 pair done as the tc
    route does it: exact code products summed in f32, scales after,
    C - acc (alpha_i alpha_j), rounded at the pair's name over the whole
    tile. L21 and the f32 pairs come from the plain version."""
    kw = dict(store_names=store_names, store_quants=store_quants,
              pair_names=pair_names, pair_quants=pair_quants,
              rounding=rounding)
    l21, out = tref.panel_update_ref(linv, a21, c, **kw)
    m, b = a21.shape
    nt = m // b
    copies = {}
    lower = torch.ones(b, b, dtype=torch.bool).tril()
    for i in range(nt):
        for j in range(i + 1):
            nm, quant = pair_names[i][j], pair_quants[i][j]
            if nm not in panel.TC_NAMES:
                continue
            if nm not in copies:
                copies[nm] = _codes(l21, nm, quant, b)
            q, alpha = copies[nm]
            # f16 x f16 (22 bits), bf16 x bf16 (16) and int8 x int8
            # products are exact in f32; the sums of b of them are f32
            acc = q[i].to(torch.float32) @ q[j].to(torch.float32).T
            cur = c[i * b:(i + 1) * b, j * b:(j + 1) * b]
            upd = cur - acc * (alpha[i] * alpha[j])
            if rounding:
                upd = tref._round_tiles(upd, nm, quant, b)
            if i == j:
                upd = torch.where(lower, upd, cur)
            out[i * b:(i + 1) * b, j * b:(j + 1) * b] = upd
    return l21, out


def _case(levels, nt, seed, b=128, quantize=True):
    cfg = PrecisionConfig(levels=levels, leaf=b, quantize=quantize)
    meta = build_plan((nt + 1) * b, cfg).panel_meta(0)
    rng = np.random.default_rng(seed)
    linv = np.tril(rng.standard_normal((b, b)).astype(np.float32))
    linv[np.diag_indices(b)] += 3.0
    a21 = rng.standard_normal((nt * b, b)).astype(np.float32)
    c = rng.standard_normal((nt * b, nt * b)).astype(np.float32)
    kw = dict(store_names=meta.store_names, store_quants=meta.store_quants,
              pair_names=meta.pair_names, pair_quants=meta.pair_quants)
    return linv, a21, c, kw


#: (levels, quantize, trailing tiles): quantized f16, plain f16, bf16, int8
_TC_CASES = [(("f16", "f16", "f32"), True, 4), (("f16", "f32"), False, 3),
             (("bf16", "f32"), True, 3), (("int8", "f32"), True, 3)]


@pytest.mark.parametrize("rounding", [True, False])
@pytest.mark.parametrize("levels,quantize,nt", _TC_CASES)
def test_tc_arithmetic_within_the_card_gate(jx, levels, quantize, nt,
                                            rounding):
    """The tc route's arithmetic (codes, exact products, scales after)
    against the reference's panel_update oracle, within one grid unit of
    the coarsest name times max|ref|: the card cases' gate."""
    linv, a21, c, kw = _case(levels, nt, seed=5, quantize=quantize)
    j = jx.jnp.asarray
    l21r, cr = jx.ref.panel_update_ref(j(linv), j(a21), j(c),
                                       rounding=rounding, **kw)
    l21r, cr = np.asarray(l21r), np.asarray(cr)
    l21m, cm = _tc_model(torch.from_numpy(linv), torch.from_numpy(a21),
                         torch.from_numpy(c), rounding=rounding, **kw)
    unit = _GRID[levels[0]]
    np.testing.assert_allclose(l21m.numpy(), l21r, rtol=0,
                               atol=unit * np.abs(l21r).max())
    np.testing.assert_allclose(cm.numpy(), cr, rtol=0,
                               atol=unit * np.abs(cr).max())


def test_tc_codes_rebuild_the_rounded_tiles():
    """codes x scale, in f32, is the plain version's rounded L21 tile,
    bitwise, also for a tile past f16's range."""
    rng = np.random.default_rng(9)
    b = 128
    l21 = torch.from_numpy(rng.standard_normal((3 * b, b)).astype(np.float32))
    l21[b:2 * b] *= 1e5                      # a tile past f16's range
    for nm, quant in (("f16", True), ("f16", False), ("bf16", False),
                      ("int8", True)):
        q, alpha = _codes(l21, nm, quant, b)
        assert q.dtype == _CODE_DT[nm]
        got = (q.to(torch.float32) * alpha[:, None, None]).reshape(-1, b)
        assert torch.equal(got, tref._round_tiles(l21, nm, quant, b)), nm
        assert bool((alpha[1] > 1) == panel.scaled(nm, quant)), nm


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------
def _card_case(card, cfg, m, seed, rounding, dtype=torch.float32, b=None):
    """One call against the plain version at leaf b (the config's by
    default), the pairs by route checked against the plan."""
    b = b or cfg.leaf
    meta = build_plan((m // b + 1) * cfg.leaf, cfg).panel_meta(0)
    kw = dict(store_names=meta.store_names, store_quants=meta.store_quants,
              pair_names=meta.pair_names, pair_quants=meta.pair_quants,
              rounding=rounding)
    g = torch.Generator(device=card).manual_seed(seed)
    linv = torch.randn((b, b), generator=g, device=card, dtype=dtype).tril()
    linv.diagonal().add_(3.0)
    a21 = torch.randn((m, b), generator=g, device=card, dtype=dtype)
    c = torch.randn((m, m), generator=g, device=card, dtype=dtype)
    l21r, cr = tref.panel_update_ref(linv, a21, c, **kw)
    a_k, c_k = a21.clone(), c.clone()
    before = dict(ops.PANEL_ROUTES)
    ops.panel_update(linv, a_k, c_k, **kw)
    routes = {k: ops.PANEL_ROUTES[k] - before[k] for k in before}
    assert routes == panel.plan(meta.pair_names, meta.pair_quants, dtype, b,
                                rounding).routes
    unit = _GRID[cfg.levels[0]]
    torch.testing.assert_close(a_k, l21r, rtol=0,
                               atol=unit * l21r.abs().max().item())
    torch.testing.assert_close(c_k, cr, rtol=0,
                               atol=unit * cr.abs().max().item())
    nt = m // b
    upper = torch.triu(torch.ones(nt, nt, dtype=torch.bool, device=card), 1)
    upper = upper.repeat_interleave(b, 0).repeat_interleave(b, 1)
    assert torch.equal(c_k[upper], c[upper])
    return routes


@pytest.mark.gpu
@pytest.mark.parametrize("rounding", [True, False])
@pytest.mark.parametrize("b", [128, 256])
@pytest.mark.parametrize("ladder", ["f16x3_f32", "f16_plain", "bf16_f32",
                                    "int8_f32", "pure_f32"])
def test_panel_kernel_routes(card, ladder, b, rounding):
    cfg = (dataclasses.replace(PAPER_CONFIGS["f16x3_f32"], quantize=False)
           if ladder == "f16_plain" else PAPER_CONFIGS[ladder])
    cfg = dataclasses.replace(cfg, leaf=b)
    routes = _card_case(card, cfg, 9 * b, 11, rounding)
    assert (routes["tc"] > 0) == (ladder != "pure_f32")


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [("int8", "f32"), ("f16", "f32"),
                                    ("f32",)])
def test_panel_kernel_other_leaf(card, levels):
    """b = 384 and 192 (pair names of a leaf-384 plan): the CUDA cores for every pair, scaled names as
    whole-tile items."""
    cfg = PrecisionConfig(levels=levels, leaf=384)
    for b in (384, 192):
        routes = _card_case(card, cfg, 4 * b, 12, True, b=b)
        assert routes["tc"] == 0


@pytest.mark.gpu
def test_panel_kernel_unaligned_l21(card):
    """L21 rows off the 16-byte grid: the f32 pairs read a copy of L21,
    with the same result as the plain version."""
    cfg = dataclasses.replace(PAPER_CONFIGS["f16x3_f32"], leaf=128)
    b, m = 128, 9 * 128
    meta = build_plan(m + b, cfg).panel_meta(0)
    kw = dict(store_names=meta.store_names, store_quants=meta.store_quants,
              pair_names=meta.pair_names, pair_quants=meta.pair_quants)
    g = torch.Generator(device=card).manual_seed(14)
    linv = torch.randn((b, b), generator=g, device=card).tril()
    linv.diagonal().add_(3.0)
    big = torch.randn((m, b + 1), generator=g, device=card)
    a21 = big[:, 1:]                       # rows 4 bytes off the grid
    c = torch.randn((m, m), generator=g, device=card)
    l21r, cr = tref.panel_update_ref(linv, a21, c, **kw)
    c_k = c.clone()
    ops.panel_update(linv, a21, c_k, **kw)
    unit = _GRID["f16"]
    torch.testing.assert_close(a21, l21r, rtol=0,
                               atol=unit * l21r.abs().max().item())
    torch.testing.assert_close(c_k, cr, rtol=0,
                               atol=unit * cr.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("ladder", ["f32x3_f64", "pure_f64"])
def test_panel_kernel_f64_container(card, ladder):
    routes = _card_case(card, PAPER_CONFIGS[ladder], 4 * 256, 13, True,
                        torch.float64)
    assert routes["tc"] == 0

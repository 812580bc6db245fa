"""Plain PyTorch versions of the ported kernels.

Counterpart of ``repro/kernels/ref.py`` for the kernels of the factor,
solve and refinement path (``qgemm``, ``potrf_leaf``, ``tri_inv_leaf``,
``panel_update``, ``residual_fused``), of the tree engine
(``trsm_leaf``, ``syrk_leaf``, ``syrk_packed``) and of the model zoo's
prefill attention (``flash_attention``). They are what
:mod:`repro_torch.kernels.ops` runs for a tensor on the CPU, and what the
CUDA kernels are held against on the card. Each follows the reference's
arithmetic step for step: the same casts, the same per-tile absmax and the
same order of roundings.

The products with right-hand sides (``qgemm_ref``, ``residual_ref``) and
the left triangular solves (``trsm_ref``) run column by column
(:func:`_matmul_cols`, :func:`_solve_cols`): torch's CPU GEMM picks
another kernel, and so another summation order, below 12 columns, and a
column's refinement trajectory must not depend on how many columns share
its block (``core/refine.py``, the continuous == window contract).
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import DTYPES, NARROW, RMAX


def _acc_dtype(*xs):
    """f32 accumulation unless an operand is f64."""
    if any(x.dtype == torch.float64 for x in xs):
        return torch.float64
    return torch.float32


def _matmul_cols(a, b):
    """``a @ b`` one column of ``b`` at a time, so that each output column
    is the same matrix-vector product whatever ``b``'s width, its column
    position or its strides (``b`` may be (k,) or (k, m))."""
    if b.dim() == 1:
        return a @ b.contiguous()
    return torch.stack([a @ b[:, j].contiguous() for j in range(b.shape[1])],
                       dim=1)


def qgemm_ref(a, b, *, trans_b=False, scale=1.0, c=None, beta=0.0,
              out_dtype=torch.float32):
    """out = scale * (a @ b[T]) + beta * c with wide accumulation.

    int8 operands contract exactly in int32, as the reference does. The
    product runs in f64, where every partial sum of int8 products is an
    exact integer, because integer matmul is not offered on every device.
    """
    bt = b.T if trans_b else b
    if not a.dtype.is_floating_point:
        acc = (a.to(torch.float64) @ bt.to(torch.float64)).to(torch.int32)
        ad = torch.float32
    else:
        ad = _acc_dtype(a, b, *((c,) if c is not None else ()))
        acc = _matmul_cols(a.to(ad), bt.to(ad))
    out = acc.to(ad) * torch.as_tensor(scale, dtype=ad, device=a.device)
    if c is not None:
        out = out + torch.as_tensor(beta, dtype=ad, device=a.device) * c.to(ad)
    return out.to(out_dtype)


def residual_ref(a, x, b):
    """IR residual ``r = b - a @ x`` with f32 accumulation (f64 if any
    operand is f64), returned in ``b.dtype``; ``x``/``b`` are (n,) or
    (n, k)."""
    ad = _acc_dtype(a, x, b)
    acc = _matmul_cols(a.to(ad), x.to(ad))
    return (b.to(ad) - acc).to(b.dtype)


def _compute_dtype(dt):
    """Factorizations need >= f32; narrow dtypes compute in f32."""
    return torch.float32 if dt.itemsize < 4 else dt


def potrf_ref(a):
    """Lower Cholesky factor (upper triangle zeroed). A matrix that is not
    SPD gives NaN on and below the diagonal, as ``jnp.linalg.cholesky``
    does, where ``torch.linalg.cholesky`` would raise."""
    cd = _compute_dtype(a.dtype)
    l, info = torch.linalg.cholesky_ex(a.to(cd))
    failed = torch.full_like(l, float("nan")).tril()
    return torch.where(info != 0, failed, l).to(a.dtype)


def tri_inv_ref(l):
    """Inverse of a lower-triangular matrix."""
    cd = _compute_dtype(l.dtype)
    eye = torch.eye(l.shape[-1], dtype=cd, device=l.device)
    out = torch.linalg.solve_triangular(l.to(cd), eye, upper=False)
    return out.to(l.dtype)


def _solve_cols(l, b, *, trans: bool):
    """``L^-1 B`` (or ``L^-T B``) one column of ``b`` at a time, for the
    same reason as :func:`_matmul_cols`."""
    lt = l.T if trans else l
    return torch.cat([torch.linalg.solve_triangular(
        lt, b[:, j:j + 1].contiguous(), upper=trans)
        for j in range(b.shape[1])], dim=1)


def trsm_ref(b, l, *, side="right", trans=True):
    """Triangular solve against a lower-triangular ``l``:

    side=right, trans=True  : X = B L^{-T}   (the paper's Alg. 2 form)
    side=left,  trans=False : X = L^{-1} B
    side=left,  trans=True  : X = L^{-T} B

    Narrow dtypes solve in f32. The left forms (the tree engine's solve
    sweeps) solve one column at a time.
    """
    cd = _compute_dtype(b.dtype)
    bc, lc = b.to(cd), l.to(cd)
    if side == "right" and trans:
        y = torch.linalg.solve_triangular(lc, bc.T, upper=False)
        return y.T.to(b.dtype)
    if side == "left":
        return _solve_cols(lc, bc, trans=trans).to(b.dtype)
    raise NotImplementedError(f"trsm side={side} trans={trans}")


def syrk_ref(c, a, *, alpha=1.0, beta=1.0, scale=1.0):
    """SYRK: lower(C) <- beta*C + alpha*scale*(A A^T); the strict upper
    triangle keeps C's values. ``scale`` (a float or a 0-d tensor) carries
    the dequantization factor when A is quantized. int8 is widened (through
    bf16, as the reference does: exact for |v| <= 127) and every product
    is summed in f32 (f64 if C or A is f64); a narrow matmul in torch would
    round its result to the narrow type."""
    if not a.dtype.is_floating_point:
        a = a.to(torch.bfloat16)
    ad = _acc_dtype(c, a)
    aw = a.to(ad)
    acc = aw @ aw.T
    dev = c.device
    upd = (torch.as_tensor(beta, dtype=ad, device=dev) * c.to(ad)
           + torch.as_tensor(alpha, dtype=ad, device=dev)
           * torch.as_tensor(scale, dtype=ad, device=dev) * acc)
    n = c.shape[-1]
    lower = torch.ones((n, n), dtype=torch.bool, device=dev).tril()
    return torch.where(lower, upd, c.to(ad)).to(c.dtype)


def _round_tiles(x, name, quant, b):
    """Per-(b, b)-tile ``storage_round`` over an (R, C) block, with the
    reference's cast chain (``repro/kernels/ref.py:_round_tiles``)."""
    dt = DTYPES[name]
    if dt == x.dtype:
        return x
    R, C = x.shape
    t = x.reshape(R // b, b, C // b, b)
    if name == "int8":
        amax = t.abs().amax(dim=(1, 3), keepdim=True).to(torch.float32)
        alpha = torch.clamp_min(amax, 1e-30) / 127.0
        q = torch.clamp(torch.round(t.to(torch.float32) / alpha), -127, 127)
        return (q * alpha).to(x.dtype).reshape(R, C)
    if name in NARROW and quant:
        amax = t.abs().amax(dim=(1, 3), keepdim=True).to(torch.float32)
        alpha = torch.clamp_min(amax / RMAX[name], 1.0)
        q = (t / alpha.to(t.dtype)).to(dt).to(x.dtype)
        return (q * alpha.to(x.dtype)).reshape(R, C)
    return t.to(dt).to(x.dtype).reshape(R, C)


def _name_runs(names, quants):
    """Contiguous (start, end, name, quant) runs of equal dtype name."""
    runs, i = [], 0
    while i < len(names):
        i2 = i
        while i2 < len(names) and names[i2] == names[i]:
            i2 += 1
        runs.append((i, i2, names[i], quants[i]))
        i = i2
    return runs


def _pair_rects(pair_names, nt):
    """Decompose the strict-lower pair-dtype map into constant-dtype
    rectangles ``(r0, r1, c0, c1, name)`` by merging equal row runs
    across adjacent columns, so the trailing update runs as a few large
    GEMMs instead of one per tile pair."""
    rects, open_ = [], {}
    for j in range(nt + 1):
        runs = set()
        if j < nt:
            i = j + 1
            while i < nt:
                nm = pair_names[i][j]
                i2 = i
                while i2 < nt and pair_names[i2][j] == nm:
                    i2 += 1
                runs.add((i, i2, nm))
                i = i2
        for key in list(open_):
            if key not in runs:
                rects.append((key[0], key[1], open_.pop(key), j, key[2]))
        for key in runs:
            open_.setdefault(key, j)
    return rects


def panel_update_ref(linv, a21, c, *, store_names, store_quants,
                     pair_names, pair_quants, rounding=True):
    """Fused panel update: ``L21 = A21 @ L11^-T`` and ``C -= L21 L21^T``
    on lower tiles, with the plan's per-tile roundings.

    The incoming panel and the solved L21 are rounded per tile at their
    storage names; each trailing pair uses L21 rounded at the pair's
    compute name (also when ``rounding`` is off, as in the reference);
    each updated tile is rounded back at that name. A diagonal tile is
    rounded over its full b x b update, whose strict upper part comes
    from ``c``'s stale upper values, and only its lower triangle is kept.
    Returns new ``(l21, c_updated)`` tensors; the inputs are not changed.
    """
    m, b = a21.shape
    nt = m // b
    assert m % b == 0 and c.shape == (m, m), (a21.shape, c.shape)
    ad = _acc_dtype(linv, a21, c)
    linv_t = linv.T.to(ad)

    segs = []
    for (i, i2, nm, q) in _name_runs(store_names, store_quants):
        blk = a21[i * b:i2 * b].to(ad)
        if rounding:
            blk = _round_tiles(blk, nm, q, b)
        li = blk @ linv_t
        if rounding:
            li = _round_tiles(li, nm, q, b)
        segs.append(li)
    l21 = torch.cat(segs, dim=0)

    quant_by = {nm: q for row_n, row_q in zip(pair_names, pair_quants)
                for nm, q in zip(row_n, row_q)}
    lq = {nm: _round_tiles(l21, nm, q, b) for nm, q in quant_by.items()}

    c = c.clone()
    for (r0, r1, c0, c1, nm) in _pair_rects(pair_names, nt):
        u = lq[nm][r0 * b:r1 * b] @ lq[nm][c0 * b:c1 * b].T
        blk = c[r0 * b:r1 * b, c0 * b:c1 * b].to(ad) - u
        if rounding:
            blk = _round_tiles(blk, nm, quant_by[nm], b)
        c[r0 * b:r1 * b, c0 * b:c1 * b] = blk.to(c.dtype)

    lower = torch.ones(b, b, dtype=torch.bool, device=c.device).tril()
    for j in range(nt):
        nm = pair_names[j][j]
        lj = lq[nm][j * b:(j + 1) * b]
        j0 = j * b
        cur = c[j0:j0 + b, j0:j0 + b].to(ad)
        upd = cur - lj @ lj.T
        if rounding:
            upd = _round_tiles(upd, nm, quant_by[nm], b)
        upd = torch.where(lower, upd, cur)
        c[j0:j0 + b, j0:j0 + b] = upd.to(c.dtype)
    return l21.to(a21.dtype), c


# ---------------------------------------------------------------------------
# flash attention (repro/kernels/flash.py)
# ---------------------------------------------------------------------------
FLASH_NEG_INF = -1e30
FLASH_BQ = 256
FLASH_BK = 256


def flash_ref(q, k, v, *, causal=True, bq=FLASH_BQ, bk=FLASH_BK):
    """Causal (or full) GQA attention, q [B, S, H, hd], k/v [B, T, KV, hd]
    with H = KV * G, -> [B, S, H, hd] in q's dtype; query head h reads kv
    head h // G, and repeated K/V are never materialized.

    The Pallas kernel's walk, block by block: q padded to a multiple of
    ``bq = min(bq, S)`` and k/v to one of ``bk = min(bk, T)``; for each
    q block an online softmax over the kv blocks, the blocks strictly past
    the diagonal skipped; ``s = (q * hd**-0.5) k^T`` in f32, masked with
    -1e30, the running max, ``l`` and ``acc`` in f32 and ``p`` kept in f32
    for ``p @ v``; the output ``acc / max(l, 1e-30)``. The causal mask is
    top-left aligned (``q_index >= k_index``, both from 0), also when
    S != T. Unlike the Pallas kernel, the padded keys (index >= T) are
    masked too: there they take part, with score 0, in the rows past T
    when S > T and T is no multiple of ``bk`` (ROADMAP.md section C).
    A full (non-causal) call needs ``T % bk == 0``, as in the reference.
    """
    B, S, H, hd = q.shape
    _, T, KV, _ = k.shape
    if H % KV:
        raise ValueError(f"flash: H = {H} is no multiple of KV = {KV}")
    G = H // KV
    bq, bk = min(bq, S), min(bk, T)
    Sp, Tp = -(-S // bq) * bq, -(-T // bk) * bk
    if not causal and Tp != T:
        raise ValueError("flash: the non-causal path requires T % bk == 0")
    f32 = torch.float32
    qf = q.permute(0, 2, 1, 3).to(f32) * (hd ** -0.5)       # [B, H, S, hd]
    qf = qf.reshape(B, KV, G, S, hd)
    kf = k.permute(0, 2, 1, 3).to(f32)[:, :, None]         # [B, KV, 1, T, hd]
    vf = v.permute(0, 2, 1, 3).to(f32)[:, :, None]
    qf = torch.nn.functional.pad(qf, (0, 0, 0, Sp - S))
    kf = torch.nn.functional.pad(kf, (0, 0, 0, Tp - T))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, Tp - T))
    out = torch.empty((B, KV, G, Sp, hd), dtype=f32, device=q.device)
    iq = torch.arange(bq, device=q.device)[:, None]
    ik = torch.arange(bk, device=q.device)[None, :]
    for qb in range(Sp // bq):
        qs = qf[..., qb * bq:(qb + 1) * bq, :]
        m = torch.full((B, KV, G, bq, 1), FLASH_NEG_INF, dtype=f32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KV, G, bq, hd), dtype=f32, device=q.device)
        for kb in range(Tp // bk):
            if causal and kb * bk > qb * bq + bq - 1:
                break
            ks = kf[..., kb * bk:(kb + 1) * bk, :]
            s = qs @ ks.transpose(-1, -2)                    # [.., bq, bk]
            ki = kb * bk + ik
            valid = ki < T
            if causal:
                valid = valid & (qb * bq + iq >= ki)
            s = torch.where(valid, s, FLASH_NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p @ vf[..., kb * bk:(kb + 1) * bk, :]
            m = m_new
        out[..., qb * bq:(qb + 1) * bq, :] = acc / torch.clamp_min(l, 1e-30)
    out = out[..., :S, :].reshape(B, H, S, hd).permute(0, 2, 1, 3)
    return out.to(q.dtype)


"""Mixed-precision iterative refinement, in torch.

Counterpart of ``repro/core/refine.py``: factor ONCE in the cheap ladder,
then iterate

    r_k = b - A x_k          (residual precision, one residual_fused launch)
    d_k = (L L^T)^{-1} r_k   (the two cheap triangular sweeps)
    x_{k+1} = x_k + d_k      (residual-precision accumulate)

Classic IR converges linearly at a rate of about cond(A) * eps(ladder);
:func:`gmres_refine` runs restarted GMRES right-preconditioned by the same
factor (GMRES-IR) for systems where classic IR stalls.

The reference runs its loops under ``jit`` (``lax.while_loop``,
``fori_loop``); here they are host loops over eager tensor operations on
the operands' device, with one host read per sweep (the early-exit test).
The per-column contract is the reference's: a (n, k) right-hand side has a
per-column convergence mask, residual history, sweep count and (through
``tol``) tolerance, and a converged or stalled column is frozen at its
best iterate while the others keep sweeping.

Column independence: a column's trajectory is bitwise the same whichever
loop drives it (the window loop :func:`_refine_loop` or the slot stepper
:class:`RefineStepper`) and whatever columns share its block. Every step
is column-local and each product is summed in an order that does not
depend on the block's width: the residual and the solves' products
(``kernels/ref.py:_matmul_cols`` on the CPU; ``csrc/residual.cu`` and
``csrc/qgemm.cu`` on the card) and the column norms (:func:`_colnorm`).

``RefineConfig.residual_dtype`` has no global switch behind it: ``None``
means ``"f32"`` (the reference's default with x64 off) and ``"f64"`` asks
for f64 residuals.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.blocked import diag_tri_inv
from repro_torch.core.precision import DTYPES, PrecisionConfig
from repro_torch.core.solve import (as_tensor, cholesky_padded,
                                    solve_factored)
from repro_torch.core.tree import pad_factor
from repro_torch.kernels import ops

_TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Static refinement policy."""

    max_sweeps: int = 5          # classic-IR sweeps / GMRES restarts
    tol: float = 1e-10           # relative-residual early-exit target
    method: str = "ir"           # "ir" | "gmres"
    gmres_restart: int = 16      # Krylov dimension per GMRES cycle
    residual_dtype: str | None = None  # None -> "f32"

    def __post_init__(self):
        assert self.max_sweeps >= 0, self.max_sweeps
        assert self.method in ("ir", "gmres"), self.method
        assert self.gmres_restart >= 1, self.gmres_restart
        if self.residual_dtype is not None:
            assert self.residual_dtype in DTYPES, self.residual_dtype

    def rdtype(self):
        return DTYPES[self.residual_dtype or "f32"]


class RefineResult(NamedTuple):
    """Result of a refinement run.

    ``history[0]`` is the pre-refinement relative residual; ``history[k]``
    the residual after sweep k (``nan`` for sweeps never run — including,
    for multi-RHS, sweeps where that column was already frozen). For a
    vector ``b`` the per-column fields are 0-dim tensors; for an (n, k)
    ``b`` they are (k,) and history is [max_sweeps + 1, k].
    """

    x: torch.Tensor            # refined solution, residual dtype
    residual: torch.Tensor     # final relative residual, scalar | (k,)
    history: torch.Tensor      # [max_sweeps + 1(, k)] relative residuals
    iterations: torch.Tensor   # int32 sweeps actually taken, scalar | (k,)
    converged: torch.Tensor    # bool residual <= tol, scalar | (k,)


def _like(t, dtype, device):
    """``t`` (tensor, numpy array or sequence) as ``dtype`` on ``device``."""
    if torch.is_tensor(t):
        return t.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(t), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# operator-level core (factor-agnostic; the serve engine reuses these)
# ---------------------------------------------------------------------------
def scaled_solve(correct: Callable) -> Callable:
    """Wrap a linear corrector with PER-COLUMN absmax pre-scaling.

    As IR converges the residual shrinks below f16's smallest normal and
    the per-block quantizer (which only scales down) would let it
    underflow; scaling each column of r to O(1) before the solve and back
    after is exact for a linear operator. Per column, because a batch
    stacks unrelated requests whose residuals differ by orders of
    magnitude. A stack (N, n, k) of independent systems (K-FAC's batched
    whitening) scales each system's columns on their own, as the
    reference does for each system under ``jax.vmap``.
    """
    def wrapped(r):
        absmax = (r.abs().amax(dim=-2, keepdim=True) if r.dim() >= 2
                  else r.abs().amax())
        s = torch.clamp_min(absmax, _TINY)
        return correct(r / s) * s

    return wrapped


def _colnorm(v):
    """Per-column 2-norm: 0-dim for a vector, (k,) for an (n, k) block.

    The squares are summed in a fixed pairwise tree over rows (zero rows
    pad n to a power of two, which adds nothing), one elementwise add per
    level, so each column's norm depends on its own n entries alone, on
    every device, whatever the block's width.
    """
    sq = v * v
    n = sq.shape[0]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        sq = torch.cat([sq, sq.new_zeros((p - n,) + tuple(sq.shape[1:]))])
    while sq.shape[0] > 1:
        h = sq.shape[0] // 2
        sq = sq[:h] + sq[h:]
    return torch.sqrt(sq[0])


def _masked_sweep(sweep: Callable, resid: Callable, relnorm: Callable,
                  x, r, rel, bx, brel, its, stall, act):
    """One per-column-masked refinement sweep — the shared inner step of
    the window loop (:func:`_refine_loop`) and the slot stepper
    (:class:`RefineStepper`), so a column's trajectory is identical
    whichever loop drives it. ``act`` masks the sweep: frozen columns
    keep their iterate, their residual columns are zeroed out of the sweep
    input, and their bookkeeping does not advance."""
    rm = r * act.to(r.dtype)                    # mask frozen residuals
    xn = torch.where(act, sweep(x, rm), x)      # frozen columns keep x
    rn = resid(xn)
    reln = torch.where(act, relnorm(rn), rel)
    improved = reln < brel                      # new best this sweep?
    bx = torch.where(act & improved, xn, bx)
    brel = torch.where(act, torch.minimum(reln, brel), brel)
    stall = torch.where(act, torch.where(improved, 0, stall + 1), stall)
    return xn, rn, reln, bx, brel, its + act.to(torch.int32), stall


def _refine_loop(sweep: Callable, resid: Callable, relnorm: Callable, x0,
                 rcfg: RefineConfig, tol=None) -> RefineResult:
    """Shared outer loop: run ``sweep`` until tol / max_sweeps / stall,
    with per-column bookkeeping for multi-RHS blocks.

    ``resid(x)`` forms the residual (carried between iterations, so each
    sweep costs one residual); ``relnorm(r)`` maps it to per-column
    relative norms; ``sweep(x, r)`` applies one correction. Tracks the
    BEST iterate per column; a column exits on convergence or after TWO
    consecutive non-improving sweeps (one flat sweep is a normal transient
    of GMRES-IR restarts and non-normal IR iterations). ``tol`` may be a
    per-column array; it defaults to ``rcfg.tol``.
    """
    r0 = resid(x0)
    rel0 = relnorm(r0)
    dev = rel0.device
    tol = _like(rcfg.tol if tol is None else tol, rel0.dtype, dev)
    hist = torch.full((rcfg.max_sweeps + 1,) + tuple(rel0.shape),
                      float("nan"), dtype=rel0.dtype, device=dev)
    hist[0] = rel0
    zero = torch.zeros(rel0.shape, dtype=torch.int32, device=dev)
    x, r, rel, bx, brel, its, stall = x0, r0, rel0, x0, rel0, zero, zero
    for i in range(rcfg.max_sweeps):
        act = (brel > tol) & (stall < 2)
        if not bool(act.any()):
            break
        x, r, rel, bx, brel, its, stall = _masked_sweep(
            sweep, resid, relnorm, x, r, rel, bx, brel, its, stall, act)
        hist[i + 1] = torch.where(act, rel, float("nan"))
    return RefineResult(bx, brel, hist, its, brel <= tol)


# ---------------------------------------------------------------------------
# re-entrant slot-block refinement (continuous batching)
# ---------------------------------------------------------------------------
class SlotState(NamedTuple):
    """State of a :class:`RefineStepper` slot block.

    One RHS column per slot; ``(n, S)`` tensors hold the block, ``(S,)``
    tensors the per-slot bookkeeping. Empty slots are all-zero with
    ``occ=False``, ``bnorm=1``: algebraically inert.
    """

    x: torch.Tensor       # (n, S) current iterate (residual dtype)
    r: torch.Tensor       # (n, S) carried residual b - A x
    b: torch.Tensor       # (n, S) right-hand sides
    bx: torch.Tensor      # (n, S) best iterate seen per slot
    rel: torch.Tensor     # (S,) latest relative residual
    brel: torch.Tensor    # (S,) best relative residual
    bnorm: torch.Tensor   # (S,) ||b|| denominators (1 for empty slots)
    tol: torch.Tensor     # (S,) per-slot tolerance
    occ: torch.Tensor     # (S,) bool: slot holds a live column
    its: torch.Tensor     # (S,) int32 sweeps taken
    stall: torch.Tensor   # (S,) int32 consecutive non-improving sweeps


def _set_cols(t, idx, vals):
    """A copy of ``t`` with ``t[:, idx]`` (or ``t[idx]``) set to ``vals``."""
    t = t.clone()
    if t.dim() == 2:
        t[:, idx] = vals
    else:
        t[idx] = vals
    return t


class RefineStepper:
    """Re-entrant, slot-addressed refinement loop — the continuous-batching
    core.

    Runs the SAME per-column-masked sweep as :func:`_refine_loop` but
    yields to the host between sweeps, so a serving loop can retire
    finished columns mid-flight and join new right-hand sides into free
    slots. Classic IR is column-local, so a column's trajectory here is
    bitwise the one it has in a window, whatever its co-tenants; GMRES-IR
    (a joint Krylov space) is not, and the scheduler windows it.

    ``correct(r)`` applies the cheap factor (already per-column scaled);
    ``resid(x, b)`` forms ``b - A x`` in the residual precision for the
    whole block. The block lives on ``device``; the host-side helpers move
    only ``(S,)`` vectors.
    """

    def __init__(self, correct: Callable, resid: Callable, *, n: int,
                 slots: int, rcfg: RefineConfig, device="cuda"):
        assert slots >= 1, slots
        self.n, self.slots, self.rcfg = n, slots, rcfg
        self.rdtype = rcfg.rdtype()
        self.device = torch.device(device)
        self._correct, self._resid = correct, resid

    # -- state constructors -------------------------------------------------
    def init(self) -> SlotState:
        n, s, dt, dev = self.n, self.slots, self.rdtype, self.device
        z = torch.zeros((n, s), dtype=dt, device=dev)
        zs = torch.zeros((s,), dtype=dt, device=dev)
        zi = torch.zeros((s,), dtype=torch.int32, device=dev)
        return SlotState(x=z, r=z, b=z, bx=z, rel=zs, brel=zs,
                         bnorm=torch.ones((s,), dtype=dt, device=dev),
                         tol=zs, occ=torch.zeros((s,), dtype=torch.bool,
                                                 device=dev),
                         its=zi, stall=zi)

    def join(self, state: SlotState, idx, b_cols, x0_cols,
             tols) -> SlotState:
        """Insert columns into free slots ``idx`` mid-flight. ``b_cols`` /
        ``x0_cols`` are the (n, len(idx)) right-hand sides and initial
        iterates (the unscaled base solve, as the window path's ``x0``),
        ``tols`` the per-column tolerances. The block residual is
        recomputed once; live columns' residuals come out bitwise as they
        were, so a join never perturbs an in-flight column."""
        dt, dev = self.rdtype, self.device
        ja = torch.as_tensor(list(idx), dtype=torch.long, device=dev)
        b_cols = _like(b_cols, dt, dev)
        x0_cols = _like(x0_cols, dt, dev)
        new = torch.zeros((self.slots,), dtype=torch.bool, device=dev)
        new[ja] = True
        x = _set_cols(state.x, ja, x0_cols)
        b = _set_cols(state.b, ja, b_cols)
        bnorm = _set_cols(state.bnorm, ja,
                          torch.clamp_min(_colnorm(b_cols), _TINY).to(dt))
        r = self._resid(x, b)
        rel = torch.where(new, (_colnorm(r) / bnorm).to(dt), state.rel)
        return SlotState(
            x=x, r=r, b=b, bx=_set_cols(state.bx, ja, x0_cols),
            rel=rel, brel=torch.where(new, rel, state.brel), bnorm=bnorm,
            tol=_set_cols(state.tol, ja, _like(tols, dt, dev)),
            occ=state.occ | new, its=_set_cols(state.its, ja, 0),
            stall=_set_cols(state.stall, ja, 0))

    # -- the sweep ----------------------------------------------------------
    def _active(self, state: SlotState):
        return (state.occ & (state.brel > state.tol) & (state.stall < 2)
                & (state.its < self.rcfg.max_sweeps))

    def step(self, state: SlotState):
        """One masked sweep over the block; returns ``(state, act)`` where
        ``act`` is the numpy mask of slots the sweep advanced."""
        act = self._active(state)
        dt = self.rdtype

        def resid(x):
            return self._resid(x, state.b)

        def relnorm(r):
            return (_colnorm(r) / state.bnorm).to(dt)

        def sweep(x, rm):
            return x + self._correct(rm).to(dt)

        xn, rn, reln, bx, brel, its, stall = _masked_sweep(
            sweep, resid, relnorm, state.x, state.r, state.rel, state.bx,
            state.brel, state.its, state.stall, act)
        return (SlotState(x=xn, r=rn, b=state.b, bx=bx, rel=reln, brel=brel,
                          bnorm=state.bnorm, tol=state.tol, occ=state.occ,
                          its=its, stall=stall),
                act.cpu().numpy())

    # -- host-side bookkeeping ----------------------------------------------
    def active_mask(self, state: SlotState):
        """Numpy mask of slots that would advance on the next sweep."""
        return self._active(state).cpu().numpy()

    def done_mask(self, state: SlotState):
        """Numpy mask of occupied slots that are finished (converged,
        stalled twice, or out of sweeps) and ready to retire."""
        return state.occ.cpu().numpy() & ~self.active_mask(state)

    def retire(self, state: SlotState, idx):
        """Free slots ``idx``; returns ``(state, results)``, ``results[i]``
        being ``(x, relres, sweeps, converged)`` of slot ``idx[i]``: the
        BEST iterate seen, as the window loop returns it. The freed slots
        are zeroed so they stay inert."""
        dt, dev = self.rdtype, self.device
        ja = torch.as_tensor(list(idx), dtype=torch.long, device=dev)
        xs = state.bx[:, ja]                     # one device gather
        brel = state.brel[ja].cpu().numpy()
        its = state.its[ja].cpu().numpy()
        conv = brel <= state.tol[ja].cpu().numpy()
        results = [(xs[:, i], float(brel[i]), int(its[i]), bool(conv[i]))
                   for i in range(len(ja))]
        state = SlotState(
            x=_set_cols(state.x, ja, 0), r=_set_cols(state.r, ja, 0),
            b=_set_cols(state.b, ja, 0), bx=_set_cols(state.bx, ja, 0),
            rel=_set_cols(state.rel, ja, 0),
            brel=_set_cols(state.brel, ja, 0),
            bnorm=_set_cols(state.bnorm, ja, 1),
            tol=_set_cols(state.tol, ja, 0),
            occ=_set_cols(state.occ, ja, False),
            its=_set_cols(state.its, ja, 0),
            stall=_set_cols(state.stall, ja, 0))
        return state, results


def refine_operator(matvec: Callable, correct: Callable, b, x0,
                    rcfg: RefineConfig, *, resid: Callable | None = None,
                    tol=None) -> RefineResult:
    """Classic IR on an abstract operator (``b``, ``x0``: tensors).

    ``matvec(x)`` applies A in the residual precision; ``correct(r)`` the
    cheap approximate inverse. ``resid`` overrides ``b - matvec(x)``
    (:func:`iterative_refine` passes the fused residual kernel). Returns
    the best iterate seen, per column.
    """
    rdtype = rcfg.rdtype()
    b = b.to(rdtype)
    x0 = x0.to(rdtype)
    if resid is None:
        def resid(x):
            return b - matvec(x)
    bnorm = torch.clamp_min(_colnorm(b), _TINY)

    def relnorm(r):
        return (_colnorm(r) / bnorm).to(rdtype)

    def sweep(x, r):
        return x + correct(r).to(rdtype)

    return _refine_loop(sweep, resid, relnorm, x0, rcfg, tol)


def refine_steps(matvec: Callable, correct: Callable, b, x, sweeps: int):
    """Fixed-sweep classic IR (no norms, no early exit)."""
    for _ in range(sweeps):
        x = x + correct(b - matvec(x)).to(x.dtype)
    return x


def gmres_operator(matvec: Callable, correct: Callable, b, x0,
                   rcfg: RefineConfig, *, resid: Callable | None = None,
                   tol=None) -> RefineResult:
    """Restarted GMRES right-preconditioned by ``correct`` (GMRES-IR).

    Each restart runs an ``rcfg.gmres_restart``-dimensional Arnoldi
    process on ``A M^{-1}`` (modified Gram-Schmidt), solves the small
    least-squares problem and applies ``x += M^{-1} V y``; the outer loop
    is :func:`_refine_loop`, shared with classic IR. The Krylov space is
    joint across RHS columns (the flattened block); only the outer
    bookkeeping is per column. The least-squares step takes the
    pseudo-inverse (SVD, relative cutoff eps * (m + 1)), as the
    reference's ``lstsq`` does.
    """
    rdtype = rcfg.rdtype()
    m = rcfg.gmres_restart
    b = b.to(rdtype)
    x0 = x0.to(rdtype)
    if resid is None:
        def resid(x):
            return b - matvec(x)
    shape = b.shape
    n = b.numel()            # multi-RHS flattens: A (x) I_k
    dev = b.device
    bnorm = torch.clamp_min(_colnorm(b), _TINY)

    def opvec(v):            # v flat, in the preconditioned (u) space
        return matvec(correct(v.reshape(shape)).to(rdtype)).reshape(-1)

    def cycle(r_flat):
        beta = torch.linalg.vector_norm(r_flat)
        vs = torch.zeros((m + 1, n), dtype=rdtype, device=dev)
        vs[0] = r_flat / torch.clamp_min(beta, _TINY)
        hess = torch.zeros((m + 1, m), dtype=rdtype, device=dev)
        for j in range(m):
            w = opvec(vs[j])
            # rows past j are still zero: their projections vanish
            for k in range(j + 1):
                hk = torch.dot(vs[k], w)
                w = w - hk * vs[k]
                hess[k, j] = hk
            hj1 = torch.linalg.vector_norm(w)
            hess[j + 1, j] = hj1
            vs[j + 1] = torch.where(hj1 > _TINY,
                                    w / torch.clamp_min(hj1, _TINY), 0.0)
        e1 = torch.zeros((m + 1,), dtype=rdtype, device=dev)
        e1[0] = beta
        y = torch.linalg.pinv(hess) @ e1
        return (vs[:m].T @ y).reshape(shape)   # u-space correction

    def relnorm(r):
        return (_colnorm(r) / bnorm).to(rdtype)

    def sweep(x, r):
        return x + correct(cycle(r.reshape(-1))).to(rdtype)

    return _refine_loop(sweep, resid, relnorm, x0, rcfg, tol)


# ---------------------------------------------------------------------------
# matrix-level entry points
# ---------------------------------------------------------------------------
def _as_refine_config(refine) -> RefineConfig:
    if isinstance(refine, RefineConfig):
        return refine
    if isinstance(refine, int):
        return RefineConfig(max_sweeps=refine)
    if refine is None:
        return RefineConfig()
    raise TypeError(f"refine must be int | RefineConfig | None: {refine!r}")


def iterative_refine(a, b, cfg: PrecisionConfig | None = None,
                     refine: int | RefineConfig | None = None, *,
                     l=None, col_tol=None, linvs=None,
                     device="cuda") -> RefineResult:
    """Factor once in ``cfg``'s ladder (unless ``l`` is given), refine to
    ``refine.tol``.

    Dispatches on ``refine.method``: classic IR or GMRES-IR. Every sweep's
    residual ``b - A x`` goes through :func:`repro_torch.kernels.ops
    .residual` (the CUDA kernel on the card, f64 included). ``col_tol``
    gives an (n, k) ``b`` per-column tolerances; ``linvs`` reuses cached
    diagonal-tile inverses across every sweep's two triangular solves.
    Numpy inputs go to ``device``; tensors stay where they are.
    """
    cfg = cfg or PrecisionConfig()
    rcfg = _as_refine_config(refine)
    rdtype = rcfg.rdtype()
    assert a is not None, "refinement forms residuals b - A x: pass A"
    a = as_tensor(a, device)
    b = as_tensor(b, device)
    if l is None:
        l = cholesky_padded(a, cfg)   # solves consume the padded form
    else:
        l = as_tensor(l, device)
    if linvs is None and cfg.engine == "blocked":
        # every sweep runs two triangular passes against the same factor:
        # invert the diagonal leaves once here instead of per sweep
        l = pad_factor(l, cfg.leaf)
        linvs = diag_tri_inv(l, cfg)
    a_r = a.to(rdtype)
    b_r = b.to(rdtype)

    def matvec(x):
        return a_r @ x

    def resid(x):
        return ops.residual(a_r, x, b_r)

    def base_solve(r):
        return solve_factored(l, r.to(l.dtype), cfg,
                              linvs=linvs).to(rdtype)

    correct = scaled_solve(base_solve)
    # the initial solve is unscaled so refine=0 reproduces cholesky_solve
    x0 = base_solve(b_r)
    run = gmres_operator if rcfg.method == "gmres" else refine_operator
    return run(matvec, correct, b_r, x0, rcfg, resid=resid, tol=col_tol)


def gmres_refine(a, b, cfg: PrecisionConfig | None = None,
                 refine: int | RefineConfig | None = None, *,
                 l=None, col_tol=None, linvs=None,
                 device="cuda") -> RefineResult:
    """GMRES-IR convenience wrapper (``method`` forced to ``"gmres"``)."""
    rcfg = dataclasses.replace(_as_refine_config(refine), method="gmres")
    return iterative_refine(a, b, cfg, rcfg, l=l, col_tol=col_tol,
                            linvs=linvs, device=device)

"""Dtype-flow analysis of ATen graphs: value precision in f32 programs.

Counterpart of ``repro/audit/dtypeflow.py``. On the CPU, ``kernels.ops``
runs the plain versions (:mod:`repro_torch.kernels.ref`), which keep every
tensor in its f32/f64 container and apply the ladder's precision as
VALUE-level rounding: ``storage_round`` and ``_round_tiles`` cast through
the narrow dtype (``x.to(f16).to(f32)``) or, for int8, round against a
per-block scale. A dtype census of such a graph sees only f32 products.
This walker recovers the effective precision by propagating a precision
tag along def-use chains of the functional ATen graph that
:func:`trace_graph` records:

* ``_to_copy`` (or ``copy``) to a strictly narrower float dtype tags the
  value with that dtype (a rounding event); converting back up keeps the
  tag.
* ``round`` (the ``torch.round`` of int8 quantization,
  ``core/quantize.py``) tags int8.
* pure data movement (slice, ``slice_scatter``, select, view/reshape,
  transpose/permute, ``cat``, clone, copy, alias, expand, ``where``,
  ``tril``...) passes tags through; joining several keeps the coarsest
  (an untagged operand counts as its own dtype).
* ``mul``/``div``/``maximum``/``minimum``/``clamp`` against a smaller
  broadcast operand (a quantization scale or a clip bound) keeps the big
  operand's tag: this keeps the per-block scale multiply from washing the
  tag out.
* everything else gives a wide (container-precision) value.

Products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``matmul``, ``mv``,
``dot``) are dot sites, 2 M N K FLOPs each; the product's effective
precision is the coarsest of its operands' *compute* tags.

**Storage against compute.** A rounding whose value is written into the
function's result (the factor's working buffer) is a storage rounding: it
sets how the factor is stored. A product that reads such a stored value
without rounding it again runs at the container's precision; a product
whose operand was rounded and not stored first runs at that rounding's
precision. This is the plan's accounting
(``PrecisionPlan.panel_dot_flops``: a TRSM at its tile's storage name, on
the A21 tile rounded for it; a trailing pair at its compute name, on L21
rounded at that name, or on the stored L21 where the name is the
container's). The walker finds the stored values by walking back from the
graph's outputs through data movement, widening converts and scale ops,
down to the rounding events. Round events are counted either way; only
the products read compute tags. A walker that lets storage tags reach the
products (the reference's, ``repro/audit/dtypeflow.py``) reports the
f32 trailing pairs of a ladder whose L21 is stored narrower than some of
its pairs compute (f16x3_f32 and int8x3_f32 from 5 leaf tiles on) at the
narrow name (ROADMAP C).

:func:`trace_graph` records the graph with ``make_fx`` over
``torch.func.functionalize`` (the machinery under ``torch.export``'s
non-strict mode, without its export checks: the same functional ATen ops
at about a fifth of the tracing time). The engine's in-place working
buffer becomes explicit def-use (``slice_scatter``, ``copy``).
"""
from __future__ import annotations

import dataclasses
import operator

import torch

from repro_torch.core.dtypes import BYTES

#: precision tags the walker tracks (ladder names)
_TAGGABLE = ("int8", "f8e4m3", "f8e5m2", "f16", "bf16", "f32", "f64")

_TORCH_TO_LADDER = {torch.int8: "int8", torch.float16: "f16",
                    torch.bfloat16: "bf16", torch.float32: "f32",
                    torch.float64: "f64",
                    torch.float8_e4m3fn: "f8e4m3",
                    torch.float8_e5m2: "f8e5m2"}

#: ops that move data without changing values: tags pass through; the
#: operands whose values reach the result are listed by _value_inputs
_MOVEMENT = {
    "slice", "slice_copy", "slice_scatter", "select", "select_copy",
    "select_scatter", "view", "view_copy", "_unsafe_view", "reshape",
    "permute", "permute_copy", "transpose", "transpose_copy", "t", "t_copy",
    "numpy_T", "cat", "stack", "clone", "copy", "alias", "alias_copy",
    "expand", "expand_copy", "squeeze", "squeeze_copy", "unsqueeze",
    "unsqueeze_copy", "where", "tril", "triu", "lift_fresh_copy", "detach",
    "detach_copy", "contiguous", "as_strided", "as_strided_copy",
    "diagonal", "diagonal_copy", "split", "split_with_sizes",
    "split_with_sizes_copy", "unbind", "unbind_copy", "index_select",
    "diag_embed", "repeat", "flatten", "unflatten", "_reshape_alias",
    "_reshape_copy", "constant_pad_nd",
}
#: elementwise ops where a broadcast small operand must not wash out the
#: big operand's tag
_SCALE_OPS = {"mul", "div", "maximum", "minimum", "clamp", "clamp_min",
              "clamp_max"}
#: ops that make a tensor from literals (with ``get_attr`` constants):
#: converting a constant is not a rounding of data
_FACTORIES = {"full", "ones", "zeros", "empty", "scalar_tensor", "arange",
              "eye", "full_like", "ones_like", "zeros_like", "empty_like",
              "lift_fresh_copy", "tensor"}
#: product ops and the (lhs, rhs) argument positions of their factors
_DOTS = {"mm": (0, 1), "matmul": (0, 1), "bmm": (0, 1), "mv": (0, 1),
         "dot": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2),
         "addmv": (1, 2)}


def ladder_name(dtype) -> str:
    """Ladder name of a torch dtype (the container alphabet)."""
    return _TORCH_TO_LADDER.get(dtype, str(dtype).replace("torch.", ""))


def _width(name: str) -> int:
    return BYTES.get(name, 8)


def coarsest(a: str, b: str) -> str:
    """The lower-precision of two ladder names (byte width, int8 lowest)."""
    if a == b:
        return a
    wa, wb = _width(a), _width(b)
    if wa != wb:
        return a if wa < wb else b
    # same width (f16 vs bf16): neither is finer; pick deterministically
    return min(a, b)


@dataclasses.dataclass
class DotSite:
    """One product with the effective precisions of its operands."""

    lhs_name: str           # effective (compute) precision of the lhs
    rhs_name: str
    eff_name: str           # coarsest of the two = the GEMM's precision
    flops: float
    out_shape: tuple


@dataclasses.dataclass
class RoundEvent:
    """One value-rounding event (convert-to-narrower or int8 round)."""

    name: str               # target precision
    elems: int              # elements rounded
    prev: str | None        # grid the value was on before (double-round)
    stored: bool            # the rounded value is written into the result


@dataclasses.dataclass
class FlowResult:
    dots: list
    rounds: list
    promotions: list        # (src_name, dst_name, elems) widening converts

    def dot_flops_by_name(self) -> dict:
        out: dict[str, float] = {}
        for d in self.dots:
            out[d.eff_name] = out.get(d.eff_name, 0.0) + d.flops
        return out

    def round_elems_by_name(self) -> dict:
        out: dict[str, int] = {}
        for r in self.rounds:
            out[r.name] = out.get(r.name, 0) + r.elems
        return out

    def double_rounds(self) -> list:
        """Incommensurate narrow->narrow re-rounds (f16<->bf16): a value
        already on one 16-bit grid re-rounded onto the other loses bits
        both ways; no ladder in PAPER_CONFIGS produces this chain."""
        return [r for r in self.rounds
                if r.prev and {r.prev, r.name} == {"f16", "bf16"}]


def _op(node) -> str:
    """The op's name without its overload (``aten.mm.default`` -> mm)."""
    if node.op != "call_function":
        return ""
    if node.target is operator.getitem:
        return "getitem"
    packet = getattr(node.target, "_opname", None)
    if packet is None:
        packet = getattr(getattr(node.target, "overloadpacket", None),
                         "__name__", str(node.target))
    return packet


def _val(node):
    return node.meta.get("val") if hasattr(node, "meta") else None


def _is_tensor_node(x) -> bool:
    return hasattr(x, "meta") and torch.is_tensor(_val(x))


def _numel(node) -> int:
    v = _val(node)
    return int(v.numel()) if torch.is_tensor(v) else 0


def _dtype(node):
    v = _val(node)
    return v.dtype if torch.is_tensor(v) else None


def _floating(node) -> bool:
    dt = _dtype(node)
    return dt is not None and dt.is_floating_point


def _tensor_args(node) -> list:
    out = []
    for a in list(node.args) + list(node.kwargs.values()):
        if isinstance(a, (list, tuple)):
            out.extend(x for x in a if _is_tensor_node(x))
        elif _is_tensor_node(a):
            out.append(a)
    return out


def _value_inputs(node, op: str) -> list:
    """The operands whose values reach a movement op's result."""
    if op == "copy":                    # copy(dst, src): src's values
        return [node.args[1]] if _is_tensor_node(node.args[1]) else []
    if op == "where":                   # where(cond, a, b)
        return [a for a in node.args[1:3] if _is_tensor_node(a)]
    if op in ("index_select",):
        return [node.args[0]]
    return _tensor_args(node)


def _convert(node, op: str):
    """``(source node, destination dtype)`` of an op that converts its
    values' dtype, else None: every ``_to_copy``, and a ``copy`` into a
    tensor of another dtype."""
    if op == "_to_copy" and _is_tensor_node(node.args[0]):
        return node.args[0], node.kwargs.get("dtype") or _dtype(node)
    if (op == "copy" and _is_tensor_node(node.args[1])
            and _dtype(node.args[1]) != _dtype(node)):
        return node.args[1], _dtype(node)
    return None


def _dot_flops(node, op: str) -> float:
    """2 M N K: twice the output's elements times the contracted length
    (the first factor's last dimension)."""
    a = _val(node.args[_DOTS[op][0]])
    return 2.0 * float(_val(node).numel()) * float(a.shape[-1])


def _stored_nodes(graph) -> set:
    """Nodes whose values are written into the graph's result: walk back
    from the outputs through data movement, widening (or same-width)
    converts and scale ops, and stop at rounding events (which are
    stored) and at every other computation."""
    stored: set = set()
    work = [a for node in graph.nodes if node.op == "output"
            for a in _flatten_nodes(node.args)]
    while work:
        v = work.pop()
        if v in stored or not _is_tensor_node(v):
            continue
        stored.add(v)
        op = _op(v)
        conv = _convert(v, op)
        if conv is not None:
            src, dst = conv
            if not _narrowing(src, dst):
                work.append(src)
        elif op in _MOVEMENT:
            work.extend(_value_inputs(v, op))
        elif op in _SCALE_OPS:
            big = _big_operand(v)
            if big is not None:
                work.append(big)
    return stored


def _constant_nodes(graph) -> set:
    """Nodes whose values come from literals alone: tensor constants,
    factory ops, and data movement, converts and elementwise ops of
    constants only."""
    const: set = set()
    for node in graph.nodes:
        if node.op == "get_attr":
            const.add(node)
        elif node.op == "call_function":
            op = _op(node)
            ins = _tensor_args(node)
            if op in _FACTORIES and all(a in const for a in ins):
                const.add(node)
            elif ins and all(a in const for a in ins) and op not in _DOTS:
                const.add(node)
    return const


def _flatten_nodes(args) -> list:
    out = []
    for a in args if isinstance(args, (list, tuple)) else (args,):
        if isinstance(a, (list, tuple)):
            out.extend(_flatten_nodes(a))
        elif hasattr(a, "meta"):
            out.append(a)
    return out


def _narrowing(src, dst) -> bool:
    """A float -> strictly narrower float (or float -> int8) convert."""
    sd = _dtype(src)
    if sd is None or not sd.is_floating_point or dst is None:
        return False
    name = ladder_name(dst)
    if name == "int8":
        return True
    return (dst.is_floating_point and name in _TAGGABLE
            and _width(name) < _width(ladder_name(sd)))


def _big_operand(node):
    """The one tensor operand of a scale op with strictly the most
    elements (None when there is no such operand)."""
    sized = [(_numel(a), k, a) for k, a in enumerate(node.args)
             if _is_tensor_node(a)]
    if not sized:
        return None
    mx = max(e for e, _, _ in sized)
    big = [a for e, _, a in sized if e == mx]
    return big[0] if len(big) == 1 else None


class _Walker:
    def __init__(self, graph):
        self.graph = graph
        self.res = FlowResult([], [], [])
        self.stored = _stored_nodes(graph)
        self.const = _constant_nodes(graph)
        self.gtag: dict = {}        # node -> grid tag (value precision)
        self.ctag: dict = {}        # node -> compute tag (products read)

    def name_of(self, node, tags) -> str:
        t = tags.get(node)
        return t if t is not None else ladder_name(_dtype(node))

    def _set(self, node, gtag, ctag):
        if gtag is not None:
            self.gtag[node] = gtag
        if ctag is not None and node not in self.stored:
            self.ctag[node] = ctag

    def walk(self) -> FlowResult:
        for node in self.graph.nodes:
            if node.op != "call_function" or not _is_tensor_node(node):
                continue
            op = _op(node)
            conv = _convert(node, op)
            if conv is not None:
                self._convert(node, *conv)
            elif op == "round":
                src = self.name_of(node.args[0], self.gtag)
                self.res.rounds.append(RoundEvent(
                    "int8", _numel(node),
                    src if _width(src) <= 2 else None, node in self.stored))
                self._set(node, "int8", "int8")
            elif op in _DOTS:
                i, j = _DOTS[op]
                ln = self.name_of(node.args[i], self.ctag)
                rn = self.name_of(node.args[j], self.ctag)
                self.res.dots.append(DotSite(
                    ln, rn, coarsest(ln, rn), _dot_flops(node, op),
                    tuple(_val(node).shape)))
            elif op in _MOVEMENT:
                self._join(node, _value_inputs(node, op))
            elif op in _SCALE_OPS:
                big = _big_operand(node)
                if big is not None:
                    self._set(node, self.gtag.get(big), self.ctag.get(big))
            # everything else: a fresh wide value, no tag
        return self.res

    def _join(self, node, inputs):
        ins = [a for a in inputs if _floating(a)]
        if not ins or not _floating(node):
            return
        for tags, slot in ((self.gtag, "g"), (self.ctag, "c")):
            if not any(a in tags for a in ins):
                continue
            t = self.name_of(ins[0], tags)
            for a in ins[1:]:
                t = coarsest(t, self.name_of(a, tags))
            if t != ladder_name(_dtype(node)):
                self._set(node, t if slot == "g" else None,
                          t if slot == "c" else None)

    def _convert(self, node, src_v, dst_dtype):
        if src_v in self.const:
            return                  # a literal's dtype, not a rounding
        src_dt = _dtype(src_v)
        container = ladder_name(src_dt)
        src = self.name_of(src_v, self.gtag)
        csrc = self.name_of(src_v, self.ctag)
        dst = ladder_name(dst_dtype)
        elems = _numel(node)
        stored = node in self.stored
        floats = (src_dt.is_floating_point and dst in _TAGGABLE
                  and dst != "int8")
        if floats and _width(dst) < _width(container):
            # precision-losing float convert: a rounding event
            prev = src if _width(src) <= 2 and src != dst else None
            self.res.rounds.append(RoundEvent(dst, elems, prev, stored))
            self._set(node, dst, dst)
        elif dst == "int8" and src_dt.is_floating_point:
            # float -> int8 container cast. The rounding happened at the
            # round op; a cast of an int8-tagged value is the quantizer's
            # container change, not a second round.
            if src != "int8":
                self.res.rounds.append(RoundEvent("int8", elems, None,
                                                  stored))
            self._set(node, "int8", "int8")
        elif floats and _width(dst) > _width(container):
            # widening float convert: the value keeps its tag
            self.res.promotions.append((container, dst, elems))
            self._set(node,
                      src if src in _TAGGABLE and _width(src) < _width(dst)
                      else None,
                      csrc if csrc in _TAGGABLE
                      and _width(csrc) < _width(dst) else None)
        else:
            # int8 container widening back to float, same-width converts:
            # the tag rides along
            self._set(node,
                      src if src in _TAGGABLE and _width(src) < _width(dst)
                      else None,
                      csrc if csrc in _TAGGABLE
                      and _width(csrc) < _width(dst) else None)


def trace_graph(fn, *args, mode: str = "fake"):
    """The functional ATen graph of ``fn(*args)`` (a ``torch.fx``
    ``GraphModule``). ``args`` are CPU tensors, so ``kernels.ops`` runs the
    plain versions. ``mode="fake"`` runs nothing (shapes and dtypes only);
    ``"real"`` runs ``fn`` on the given values, for code whose control
    flow reads them (the refinement loop's convergence test)."""
    from torch.func import functionalize
    from torch.fx.experimental.proxy_tensor import make_fx
    # a "real" trace burns in the branches the values take
    return make_fx(functionalize(fn, remove="mutations_and_views"),
                   tracing_mode=mode,
                   _error_on_data_dependent_ops=mode != "real")(*args)


def analyze(gm) -> FlowResult:
    """Walk a traced ``GraphModule`` (or its graph) and return the flow
    census."""
    return _Walker(getattr(gm, "graph", gm)).walk()


def trace(fn, *args, mode: str = "fake", **kwargs) -> FlowResult:
    """:func:`trace_graph` and :func:`analyze` in one step; ``kwargs`` go
    to ``fn``."""
    return analyze(trace_graph(lambda *a: fn(*a, **kwargs), *args,
                               mode=mode))

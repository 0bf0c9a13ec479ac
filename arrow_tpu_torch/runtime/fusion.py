"""Fusion of a ComputePipeline's graph into generated CUDA kernels.

Counterpart of the JAX package's ``_compile_graph``
(``arrow_tpu/runtime/pipeline.py:98``), which traces the recorded graph into
one cached XLA program that XLA fuses into one pass over the data.  Here
:func:`plan` splits the recorded nodes, in recording order, into maximal
*fused groups* and *boundary nodes*, once for each graph signature (cached in
an ``lru_cache``):

- a node is fusible when its op and input dtypes are in :data:`RULES` and
  its output row i depends only on row i of its inputs, every row operand of
  the group's length (a scalar operand, a host value or row 0 of a device
  array, is read once);
- a boundary node (``sum``, ``broadcast``, ``take``, ``put``, length changes,
  any op or dtype the table does not cover) runs through ``execute()``;
- a group writes only the values that a live handle holds or that a later
  step reads; the others stay in registers.

Each group becomes one ``__global__`` function of a CUDA C++ source
generated for the plan: one thread a row, so a warp covers 32 consecutive
rows, one bitmap word, and takes :data:`WORDS_PER_WARP` consecutive words,
whose rows it loads before it computes any (one load of each operand in
flight a thread left the 2-op chain at 63% of its bound on the H100, four
at 82%).  Validity bits and BOOL values are read as
``(word[row >> 5] >> (row & 31)) & 1``; every packed output is written by
``__ballot_sync`` and stored by lane 0.  Rows at or past the length write 0
values and 0 bits (the zero tail).  The row count and the capacity are
kernel arguments, so one build serves every length; validity buffers are
pointers that may be null, so one build serves every pattern of present and
absent validity, which the launch resolves as the eager ops do (an output
whose validity is one input's is that input's buffer, unwritten).

Bound: the bytes of the row operands read and of the outputs written, over
the card's memory rate; the registers hold every intermediate.

The source is built by ``compute/kernels/_build.build_generated`` with nvcc
for sm_90a, without FMA contraction (``-fmad=false``: the eager ops round a
product and a sum apart), and loaded with ctypes.  The plain version of a
group is the eager replay of its nodes; the CPU runs it, and
``compute.kernels.plain_versions()`` selects it on the card.  On the card a
group always launches its kernel, and a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
from typing import Callable, Dict, Optional, Sequence

import torch

from .. import dtypes as dt
from ..compute.kernels import _build

_A = dt.ArrowType

KERNEL = _build.register_kernel(_build.Kernel(
    "fused_pipeline", "arrow_tpu_torch/runtime/fusion.py",
    "arrow_tpu/runtime/pipeline.py:98 _compile_graph (XLA fusion, no pallas_call)"))

THREADS = 256
#: consecutive bitmap words (32 rows each) a warp takes: its lanes load all
#: of them before computing any, so each thread has that many loads of each
#: operand in flight
WORDS_PER_WARP = 4
#: operand and output pointers of one group at most (a kernel's parameters
#: hold them; a longer run of fusible nodes becomes more than one group)
MAX_POINTERS = 128
MAX_SCALARS = 64

_CTYPE = {
    _A.BOOL: "bool", _A.UINT8: "int8_t", _A.INT8: "int8_t", _A.UINT16: "int16_t",
    _A.INT16: "int16_t", _A.UINT32: "int32_t", _A.INT32: "int32_t", _A.DATE32: "int32_t",
    _A.UINT64: "int64_t", _A.INT64: "int64_t", _A.FLOAT32: "float", _A.FLOAT64: "double",
}
_FLOATS = {_A.FLOAT32, _A.FLOAT64}
_INTS = {_A.UINT8, _A.UINT16, _A.UINT32, _A.UINT64, _A.INT8, _A.INT16, _A.INT32, _A.INT64}
_NUMERIC = _FLOATS | _INTS | {_A.DATE32}
_SIGNED_NUM = _FLOATS | {_A.INT8, _A.INT16, _A.INT32, _A.INT64}

# ---------------------------------------------------------------------------
# the row functions, __host__ __device__ (the tests build them with g++)
# ---------------------------------------------------------------------------

PRELUDE = r"""
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <math.h>
#ifdef __CUDACC__
#define ATPU_HD __host__ __device__ __forceinline__
#else
#define ATPU_HD inline
#endif
namespace atpu {
template <class S> using U = typename std::make_unsigned<S>::type;
// the unsigned type integer arithmetic wraps in: at least 32 bits, so that
// no operand is promoted to a signed int
template <class S> using T = typename std::conditional<(sizeof(S) < 4), uint32_t, U<S>>::type;
template <class D, class S> ATPU_HD D bits_as(S s) { D d; memcpy(&d, &s, sizeof(D)); return d; }
template <class S> ATPU_HD S from_bits(int64_t b) { S s; memcpy(&s, &b, sizeof(S)); return s; }
ATPU_HD bool bit(const int32_t* w, int64_t row) { return ((uint32_t)w[row >> 5] >> (row & 31)) & 1u; }
template <class S> ATPU_HD U<S> u(S a) { return (U<S>)a; }
template <bool US, class S> ATPU_HD int64_t widen(S a) { return US ? (int64_t)(U<S>)a : (int64_t)a; }
template <class S> ATPU_HD S smin() { return (S)((U<S>)1 << (8 * sizeof(S) - 1)); }
template <class S> ATPU_HD S wadd(S a, S b) { return (S)(T<S>)((T<S>)(U<S>)a + (T<S>)(U<S>)b); }
template <class S> ATPU_HD S wsub(S a, S b) { return (S)(T<S>)((T<S>)(U<S>)a - (T<S>)(U<S>)b); }
template <class S> ATPU_HD S wmul(S a, S b) { return (S)(T<S>)((T<S>)(U<S>)a * (T<S>)(U<S>)b); }
template <class S> ATPU_HD S wneg(S a) { return (S)(T<S>)((T<S>)0 - (T<S>)(U<S>)a); }
// WGSL division: x / 0 == x, INT_MIN / -1 == INT_MIN, x % 0 == 0, INT_MIN % -1 == 0
template <class S> ATPU_HD S sdiv(S a, S b) {
  return (b == 0 || (a == smin<S>() && b == (S)-1)) ? a : (S)(a / b);
}
template <class S> ATPU_HD S srem(S a, S b) {
  return (b == 0 || (a == smin<S>() && b == (S)-1)) ? (S)0 : (S)(a % b);
}
template <class S> ATPU_HD S udiv(S a, S b) { return b == 0 ? a : (S)(u(a) / u(b)); }
template <class S> ATPU_HD S urem(S a, S b) { return b == 0 ? (S)0 : (S)(u(a) % u(b)); }
template <class S> ATPU_HD S iabs(S a) { return a < 0 ? wneg(a) : a; }
// WGSL integer power: wrapping multiplies; a negative exponent's closed form
template <class S> ATPU_HD S ipow(S x, S p) {
  if (p < 0) return x == 0 ? (S)1 : ((x == 1 || x == (S)-1) ? ((p & 1) ? x : (S)1) : (S)0);
  T<S> r = 1, b = (T<S>)(U<S>)x;
  for (U<S> e = (U<S>)p; e != 0; e >>= 1) {
    if (e & 1) r = (T<S>)(r * b);
    b = (T<S>)(b * b);
  }
  return (S)r;
}
// shifts by amount & 31 (& 63 at 64 bits), through the 64-bit Arrow value
template <bool US, class S> ATPU_HD S shl(S a, int32_t amount) {
  const uint32_t k = (uint32_t)amount & (sizeof(S) == 8 ? 63u : 31u);
  if (sizeof(S) == 8) return (S)((uint64_t)a << k);
  return (S)((uint64_t)widen<US>(a) << k);
}
template <bool US, class S> ATPU_HD S shr(S a, int32_t amount) {
  const uint32_t k = (uint32_t)amount & (sizeof(S) == 8 ? 63u : 31u);
  if (sizeof(S) == 8) return US ? (S)((uint64_t)a >> k) : (S)((int64_t)a >> k);
  return (S)(widen<US>(a) >> k);
}
// float -> integer: NaN -> 0, clip to the 32-bit bounds of the target's
// signedness, truncate, wrap to the target's width
template <class D, bool SIGNED> ATPU_HD D f2i(double x) {
  if (x != x) x = 0.0;
  const double lo = SIGNED ? -2147483648.0 : 0.0, hi = SIGNED ? 2147483647.0 : 4294967295.0;
  x = x < lo ? lo : (x > hi ? hi : x);
  return (D)(int64_t)x;
}
ATPU_HD bool sbit(float x) { return bits_as<int32_t>(x) < 0; }
ATPU_HD bool sbit(double x) { return bits_as<int64_t>(x) < 0; }
// XLA's minimum and maximum: NaN propagates, -0 orders below +0
template <class F> ATPU_HD F fmin_(F a, F b) {
  if (a == b) return sbit(a) ? a : b;
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}
template <class F> ATPU_HD F fmax_(F a, F b) {
  if (a == b) return sbit(a) ? b : a;
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
ATPU_HD float pow_(float a, float b) { return powf(a, b); }
ATPU_HD double pow_(double a, double b) { return pow(a, b); }
ATPU_HD float fabs_(float a) { return fabsf(a); }
ATPU_HD double fabs_(double a) { return fabs(a); }
template <class F> ATPU_HD F cbrt_(F x) {
  return (F)((0 < x) - (x < 0)) * pow_(fabs_(x), (F)(1.0 / 3.0));
}
}  // namespace atpu
"""

# ---------------------------------------------------------------------------
# the table of fusible ops
# ---------------------------------------------------------------------------


def _fn(t: dt.ArrowType, name: str) -> str:
    """A libm function of float type `t` (``sinf`` for float32)."""
    return name + ("f" if t is _A.FLOAT32 else "")


def _us(t: dt.ArrowType) -> str:
    return "true" if dt.is_unsigned(t) else "false"


def _arith(op):
    def emit(x, y, t, params):
        if dt.is_float(t):
            return {"add": f"({x} + {y})", "sub": f"({x} - {y})", "mul": f"({x} * {y})",
                    "div": f"({x} / {y})", "rem": f"{_fn(t, 'fmod')}({x}, {y})"}[op]
        if op in ("div", "rem"):
            return f"atpu::{'u' if dt.is_unsigned(t) else 's'}{op}({x}, {y})"
        return f"atpu::w{op}({x}, {y})"

    return emit


_CMP_OPS = {"eq": "==", "gt": ">", "gteq": ">=", "lt": "<", "lteq": "<="}


def _compare(op):
    def emit(x, y, t, params):
        if dt.is_unsigned(t):
            x, y = f"atpu::u({x})", f"atpu::u({y})"
        return f"({x} {_CMP_OPS[op]} {y})"

    return emit


def _minmax(op):
    def emit(x, y, t, params):
        if dt.is_float(t):
            return f"atpu::f{op}_({x}, {y})"
        cx, cy = (f"atpu::u({x})", f"atpu::u({y})") if dt.is_unsigned(t) else (x, y)
        return f"({cx} {'<=' if op == 'min' else '>='} {cy} ? {x} : {y})"

    return emit


def _logical(op):
    def emit(x, y, t, params):
        if t is _A.BOOL:
            return {"and": f"({x} && {y})", "or": f"({x} || {y})", "xor": f"({x} != {y})"}[op]
        sym = {"and": "&", "or": "|", "xor": "^"}[op]
        return f"({_CTYPE[t]})({x} {sym} {y})"

    return emit


def _cast(x, t, params):
    d = params["to"]
    cd = _CTYPE[d]
    if t is _A.BOOL:
        return f"({cd})({x} ? 1 : 0)"
    if dt.is_float(t) and dt.is_integer(d):
        return f"atpu::f2i<{cd}, {'true' if dt.is_signed(d) else 'false'}>((double){x})"
    if dt.is_float(t):
        return f"({cd}){x}"
    if t is _A.UINT64:
        return f"({cd})(uint64_t){x}"
    return f"({cd})atpu::widen<{_us(t)}>({x})"


def _bitcast(x, t, params):
    d = params["to"]
    return x if _CTYPE[d] == _CTYPE[t] else f"atpu::bits_as<{_CTYPE[d]}>({x})"


def _trig(op):
    def emit(x, t, params):
        if not dt.is_float(t):
            x, t = f"(float)atpu::widen<{_us(t)}>({x})", _A.FLOAT32
        if op == "sinh":  # through float64, rounded once (as the eager op)
            return f"({_CTYPE[t]})sinh((double){x})"
        return f"{_fn(t, op)}({x})"

    return emit


def _math(op):
    def emit(x, t, params):
        if op == "abs":
            return f"{_fn(t, 'fabs')}({x})" if dt.is_float(t) else f"atpu::iabs({x})"
        if op == "cbrt":
            return f"atpu::cbrt_({x})"
        return f"{_fn(t, op)}({x})"

    return emit


@dataclasses.dataclass(frozen=True)
class Rule:
    """A fusible op: the position of each operand ("row": row i; "scalar":
    one value for every row), whether it takes the operands' dtypes and
    params, its row expression and its output dtype."""

    positions: tuple
    accepts: Callable[..., bool]
    emit: Callable[..., str]
    out_dtype: Callable[..., dt.ArrowType] = lambda t, params: t
    merge: bool = False  # the merge's 4-way validity


def _same(allowed):
    return lambda ts, params: ts[0] in allowed and all(t is ts[0] for t in ts)


def _binary(emit):
    return lambda args, ts, params: emit(args[0], args[1], ts[0], params)


def _unary(emit):
    return lambda args, ts, params: emit(args[0], ts[0], params)


def _rules() -> Dict[str, Rule]:
    rules = {}
    row2, scalar2 = ("row", "row"), ("row", "scalar")
    for op in ("add", "sub", "mul", "div", "rem"):
        rules[op] = Rule(row2, _same(_NUMERIC), _binary(_arith(op)))
        rules[f"{op}_scalar"] = Rule(scalar2, _same(_NUMERIC), _binary(_arith(op)))
    rules["neg"] = Rule(("row",), _same(_SIGNED_NUM), _unary(
        lambda x, t, p: f"(-{x})" if dt.is_float(t) else f"atpu::wneg({x})"))
    for op in _CMP_OPS:
        for name, pos in ((op, row2), (f"{op}_scalar", scalar2)):
            rules[name] = Rule(pos, _same(_NUMERIC), _binary(_compare(op)), lambda t, p: _A.BOOL)
    for op in ("min", "max"):
        rules[op] = Rule(row2, _same(_NUMERIC), _binary(_minmax(op)))
    for op in ("and", "or", "xor"):
        rules[f"bitwise_{op}"] = Rule(row2, _same(_INTS | {_A.BOOL}), _binary(_logical(op)))
    rules["bitwise_not"] = Rule(("row",), _same(_INTS | {_A.BOOL}), _unary(
        lambda x, t, p: f"(!{x})" if t is _A.BOOL else f"({_CTYPE[t]})~{x}"))
    for op in ("shl", "shr"):
        rules[f"bitwise_{op}"] = Rule(
            row2, lambda ts, p: ts[0] in _INTS and ts[1] is _A.UINT32,
            lambda args, ts, p, op=op: f"atpu::{op}<{_us(ts[0])}>({args[0]}, {args[1]})")
    rules["cast"] = Rule(("row",), lambda ts, p: ts[0] in _NUMERIC | {_A.BOOL} and p["to"] in _NUMERIC,
                         _unary(_cast), lambda t, p: p["to"])
    rules["bitcast"] = Rule(("row",), lambda ts, p: ts[0] in _NUMERIC and p["to"] in _NUMERIC
                            and dt.bit_width(ts[0]) == dt.bit_width(p["to"]),
                            _unary(_bitcast), lambda t, p: p["to"])
    rules["merge"] = Rule(("row", "row", "row"),
                          lambda ts, p: ts[0] in _NUMERIC | {_A.BOOL} and ts[1] is ts[0] and ts[2] is _A.BOOL,
                          lambda args, ts, p: f"({args[2]} ? {args[0]} : {args[1]})", merge=True)
    rules["power"] = Rule(row2, _same({_A.FLOAT32, _A.FLOAT64, _A.INT32, _A.INT64}), _binary(
        lambda x, y, t, p: f"atpu::pow_({x}, {y})" if dt.is_float(t) else f"atpu::ipow({x}, {y})"))
    rules["math_abs"] = Rule(("row",), _same(_SIGNED_NUM), _unary(_math("abs")))
    for op in ("sqrt", "cbrt", "exp", "exp2", "log", "log2"):
        rules[f"math_{op}"] = Rule(("row",), _same(_FLOATS), _unary(_math(op)))
    trig_in = _FLOATS | {_A.UINT8, _A.UINT16, _A.INT8, _A.INT16}
    for op in ("sin", "cos", "acos", "sinh"):
        rules[f"trig_{op}"] = Rule(("row",), _same(trig_in), _unary(_trig(op)),
                                   lambda t, p: t if dt.is_float(t) else _A.FLOAT32)
    return rules


#: op name -> Rule, for every op the generator fuses
RULES: Dict[str, Rule] = _rules()

# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Operand:
    """A buffer a group reads: the data of a row operand ("data"), row 0 of
    a scalar operand on the device ("first"), a host scalar passed by value
    ("value"), or a row operand's validity ("validity")."""

    ref: tuple  # ("input", input index) | ("node", slot id)
    plane: str
    dtype: dt.ArrowType


@dataclasses.dataclass(frozen=True)
class Output:
    """A value a group writes: its data and, unless it resolves to none or
    to one operand's buffer, its validity (see :func:`resolve_validity`)."""

    oid: int
    dtype: dt.ArrowType
    validity: tuple  # the validity's symbol


@dataclasses.dataclass(frozen=True)
class Group:
    index: int
    nodes: tuple  # node indices, in recording order
    operands: tuple  # Operands read through pointers (the row operand first)
    scalars: tuple  # Operands passed by value
    outputs: tuple  # Outputs
    reads: frozenset  # slot ids of earlier steps that the group reads

    @property
    def symbol(self) -> str:
        return f"atpu_fused_g{self.index}"


@dataclasses.dataclass(frozen=True)
class Boundary:
    node: int
    reads: frozenset


@dataclasses.dataclass(frozen=True)
class Plan:
    steps: tuple  # Group | Boundary, in order
    source: str  # the CUDA source of every group ("" when there is none)
    host_source: str  # the same row code as plain C++ loops (for the tests)

    @property
    def groups(self) -> tuple:
        return tuple(s for s in self.steps if isinstance(s, Group))


def _emit_validity(sym, code: "_GroupCode", names) -> tuple:
    """C names (present, valid) of a validity symbol, emitting its code into
    `code` once.  A symbol is ("src", ref): a memory operand's validity
    buffer (a null pointer when absent); ("and", syms): the AND of the
    present ones; ("merge", a, b, m, mask): the merge's 4-way composition.
    An absent validity's valid bit is true."""
    if sym in names:
        return names[sym]
    if sym[0] == "src":
        i = code.ptr(Operand(sym[1], "validity", _A.BOOL))
        p, q = f"p{len(names)}", f"q{len(names)}"
        code.uniform.append(f"const bool {p} = a.in[{i}] != nullptr;")
        code.loads.append(("bool", q, f"{p} ? atpu::bit((const int32_t*)a.in[{i}], r) : true"))
    elif sym[0] == "and":
        parts = [_emit_validity(s, code, names) for s in sym[1]]
        p, q = f"p{len(names)}", f"q{len(names)}"
        code.lines.append(f"const bool {p} = {' || '.join(x for x, _ in parts)};")
        code.lines.append(f"const bool {q} = {' && '.join(y for _, y in parts)};")
    else:  # merge
        (pa, qa), (pb, qb) = (_emit_validity(s, code, names) for s in sym[1:3])
        pm, qm = _emit_validity(sym[4], code, names)
        p, q, m = f"p{len(names)}", f"q{len(names)}", sym[3]
        code.lines.append(f"const bool {p}m = {pa} || {pb};")
        code.lines.append(f"const bool {q}m = ({pa} && {qa} && {m}) || ({pb} && {qb} && !{m});")
        code.lines.append(f"const bool {p} = {p}m || {pm};")
        code.lines.append(f"const bool {q} = {p}m ? ({q}m && {qm}) : {qm};")
    names[sym] = (p, q)
    return p, q


def _and(syms) -> tuple:
    flat = []
    for s in syms:
        for part in (s[1] if s[0] == "and" else (s,)):
            if part not in flat:
                flat.append(part)
    return flat[0] if len(flat) == 1 else ("and", tuple(flat))


def resolve_validity(sym, present: Callable[[tuple], bool]):
    """What the eager ops give for a validity symbol, given which memory
    operands have a validity buffer: None (no buffer), ("alias", ref) (that
    operand's buffer itself) or "computed" (a new buffer)."""
    if sym[0] == "src":
        return ("alias", sym[1]) if present(sym[1]) else None
    if sym[0] == "and":
        parts = [r for r in (resolve_validity(s, present) for s in sym[1]) if r is not None]
        return (parts[0] if len(parts) == 1 else "computed") if parts else None
    if resolve_validity(sym[1], present) is None and resolve_validity(sym[2], present) is None:
        return resolve_validity(sym[4], present)
    return "computed"


class _GroupCode:
    """The row code of one group, built node by node: `uniform` statements
    (the same for every row: scalars, which validity buffers are present),
    `loads` (ctype, name, expression of row r) and `lines` computing the
    values from them."""

    def __init__(self, index, meta, length_class):
        self.index, self.meta, self.length_class = index, meta, length_class
        self.nodes, self.operands, self.scalars = [], [], []
        self.uniform, self.loads, self.lines = [], [], []
        self.values = {}  # slot id -> (C name, dtype, validity symbol)
        self.reads = set()
        self.pointer_budget = 0  # operand pointers, and two for each node's output

    def ptr(self, op: Operand) -> int:
        if op not in self.operands:
            self.operands.append(op)
        return self.operands.index(op)

    def fits(self, node) -> bool:
        new = sum(2 for ref in node.inputs if ref[0] == "input" or ref[1] not in self.values)
        scal = sum(1 for ref in node.inputs if self.meta[ref][2] == "host")
        return (self.pointer_budget + new + 2 <= MAX_POINTERS
                and len(self.scalars) + scal <= MAX_SCALARS)

    def operand(self, ref, position):
        """(C name, dtype, validity symbol) of an operand."""
        if ref[0] == "node" and ref[1] in self.values:
            return self.values[ref[1]]
        dtype, _, kind = self.meta[ref]
        if ref[0] == "node":
            self.reads.add(ref[1])
        ct = _CTYPE[dtype]
        if kind == "host":
            op = Operand(ref, "value", dtype)
            if op not in self.scalars:
                self.scalars.append(op)
                j = len(self.scalars) - 1
                self.uniform.append(f"const {ct} s{j} = atpu::from_bits<{ct}>(a.s[{j}]);")
            return f"s{self.scalars.index(op)}", dtype, None
        plane = "data" if position == "row" else "first"
        op = Operand(ref, plane, dtype)
        fresh = op not in self.operands
        i = self.ptr(op)
        name = f"x{i}"
        if fresh:
            self.pointer_budget += 2
            if plane == "first":
                self.uniform.append(f"const {ct} {name} = ((const {ct}*)a.in[{i}])[0];")
            elif dtype is _A.BOOL:
                self.loads.append(("bool", name, f"atpu::bit((const int32_t*)a.in[{i}], r)"))
            else:
                self.loads.append((ct, name, f"((const {ct}*)a.in[{i}])[r]"))
        return name, dtype, ("src", ref)

    def add(self, node_index, node) -> None:
        rule = RULES[node.op]
        params = dict(node.params)
        args = [self.operand(ref, pos) for ref, pos in zip(node.inputs, rule.positions)]
        names, dtypes = [a[0] for a in args], [a[1] for a in args]
        out_dtype = rule.out_dtype(dtypes[0], params)
        oid = node.out_ids[0]
        name = f"v{oid}"
        self.lines.append(f"const {_CTYPE[out_dtype]} {name} = {rule.emit(names, dtypes, params)};")
        if rule.merge:
            validity = ("merge", args[0][2], args[1][2], names[2], args[2][2])
        else:
            validity = _and([a[2] for a, pos in zip(args, rule.positions) if pos == "row"])
        self.values[oid] = (name, out_dtype, validity)
        self.nodes.append(node_index)
        self.pointer_budget += 2

    def finish(self, outputs: Sequence[int]):
        """The Group, its CUDA text and its host text, writing `outputs`."""
        names: dict = {}
        dev, host = [], []
        outs = []
        for oid in outputs:
            name, dtype, validity = self.values[oid]
            outs.append(Output(oid, dtype, validity))
            k = 2 * (len(outs) - 1)
            ct = _CTYPE[dtype]
            if dtype is _A.BOOL:
                dev.append(_ballot(f"live && {name}", k))
                host.append(f"if (live && {name}) ((int32_t*)a.out[{k}])[row >> 5] |= (int32_t)(1u << (row & 31));")
            else:
                dev.append(f"if (in) (({ct}*)a.out[{k}])[row] = live ? {name} : ({ct})0;")
                host.append(f"(({ct}*)a.out[{k}])[row] = live ? {name} : ({ct})0;")
            _, q = _emit_validity(validity, self, names)
            dev.append(f"if (a.out[{k + 1}] != nullptr) {{ {_ballot(f'live && {q}', k + 1)} }}")
            host.append(f"if (a.out[{k + 1}] != nullptr && live && {q}) "
                        f"((int32_t*)a.out[{k + 1}])[row >> 5] |= (int32_t)(1u << (row & 31));")
        group = Group(self.index, tuple(self.nodes), tuple(self.operands), tuple(self.scalars),
                      tuple(outs), frozenset(self.reads))
        return group, _kernel_text(group, self, dev), _host_text(group, self, host)


_ERROR_STRING = (
    'extern "C" const char* atpu_fused_error_string(int e) '
    "{ return cudaGetErrorString((cudaError_t)e); }\n")


def _ballot(pred: str, k: int) -> str:
    return (f"const unsigned w{k} = __ballot_sync(0xffffffffu, {pred}); "
            f"if ((threadIdx.x & 31) == 0) ((int32_t*)a.out[{k}])[row >> 5] = (int32_t)w{k};")


def _args_struct(g: Group) -> str:
    ni, no, ns = len(g.operands), 2 * len(g.outputs), max(1, len(g.scalars))
    return (f"struct {g.symbol}_args {{ const void* in[{ni}]; void* out[{no}]; int64_t s[{ns}]; }};\n"
            f"static void {g.symbol}_fill({g.symbol}_args& a, const void* const* in, void* const* out, "
            f"const int64_t* s) {{\n"
            f"  for (int i = 0; i < {ni}; ++i) a.in[i] = in[i];\n"
            f"  for (int i = 0; i < {no}; ++i) a.out[i] = out[i];\n"
            f"  for (int i = 0; i < {len(g.scalars)}; ++i) a.s[i] = s[i];\n}}\n")


def _kernel_text(g: Group, code: _GroupCode, stores) -> str:
    """The group's kernel: a warp takes WORDS_PER_WARP consecutive bitmap
    words (32 rows each, one a lane), loads every row operand of all of
    them first (so that enough loads are in flight to cover the memory's
    latency), then computes and stores word by word."""
    arrays = "\n  ".join(f"{ct} {name}_[{WORDS_PER_WARP}];" for ct, name, _ in code.loads)
    loads = "\n    ".join(f"{name}_[j] = {expr};" for _, name, expr in code.loads)
    takes = [f"const {ct} {name} = {name}_[j];" for ct, name, _ in code.loads]
    body = "\n    ".join([*takes, *code.lines, *stores])
    uniform = "\n  ".join(code.uniform)
    w = WORDS_PER_WARP
    return (
        _args_struct(g)
        + f"__global__ void __launch_bounds__({THREADS}) {g.symbol}_kernel({g.symbol}_args a, "
          f"int64_t length, int64_t cap) {{\n"
        f"  const int64_t words = (cap + 31) / 32;\n"
        f"  const int64_t first = ((int64_t)blockIdx.x * {THREADS} + threadIdx.x) / 32 * {w};\n"
        f"  if (first >= words) return;  // whole warps leave\n"
        f"  const int lane = threadIdx.x & 31;\n"
        f"  {uniform}\n"
        f"  {arrays}\n"
        f"#pragma unroll\n"
        f"  for (int j = 0; j < {w}; ++j) {{\n"
        f"    const int64_t row = (first + j) * 32 + lane;\n"
        f"    const int64_t r = row < cap ? row : 0;  // rows past the capacity read row 0\n"
        f"    {loads}\n  }}\n"
        f"#pragma unroll\n"
        f"  for (int j = 0; j < {w}; ++j) {{\n"
        f"    if (first + j >= words) break;  // the same for the whole warp\n"
        f"    const int64_t row = (first + j) * 32 + lane;\n"
        f"    const bool in = row < cap, live = row < length;\n"
        f"    {body}\n  }}\n}}\n"
        f'extern "C" int {g.symbol}(const void* const* in, void* const* out, const int64_t* s, '
        f"int64_t length, int64_t cap, void* stream) {{\n"
        f"  {g.symbol}_args a;\n  {g.symbol}_fill(a, in, out, s);\n"
        f"  const int64_t threads = ((cap + 31) / 32 + {w - 1}) / {w} * 32;\n"
        f"  if (threads > 0)\n"
        f"    {g.symbol}_kernel<<<(unsigned)((threads + {THREADS - 1}) / {THREADS}), {THREADS}, 0, "
        f"(cudaStream_t)stream>>>(a, length, cap);\n"
        f"  return (int)cudaGetLastError();\n}}\n")


def _host_text(g: Group, code: _GroupCode, stores) -> str:
    loads = [f"const {ct} {name} = {expr};" for ct, name, expr in code.loads]
    body = "\n    ".join([*loads, *code.lines, *stores])
    uniform = "\n  ".join(code.uniform)
    return (
        _args_struct(g)
        + f'extern "C" void {g.symbol}(const void* const* in, void* const* out, const int64_t* s, '
          f"int64_t length, int64_t cap) {{\n"
        f"  {g.symbol}_args a;\n  {g.symbol}_fill(a, in, out, s);\n"
        f"  {uniform}\n"
        f"  for (int64_t row = 0; row < cap; ++row) {{\n"
        f"    const int64_t r = row;\n    const bool live = row < length;\n"
        f"    {body}\n  }}\n}}\n")


@dataclasses.dataclass(frozen=True)
class SigNode:
    op: str
    inputs: tuple  # ("node", slot id) | ("input", input index)
    params: tuple  # sorted (key, value) pairs
    out_ids: tuple
    out_meta: tuple  # ((dtype, length class), ...)


def _fusible(node: SigNode, meta) -> bool:
    rule = RULES.get(node.op)
    if rule is None or len(node.inputs) != len(rule.positions) or len(node.out_ids) != 1:
        return False
    rows = [meta[ref] for ref, pos in zip(node.inputs, rule.positions) if pos == "row"]
    if any(kind != "array" for _, _, kind in rows) or len({lc for _, lc, _ in rows}) != 1:
        return False
    try:
        return bool(rule.accepts([meta[ref][0] for ref in node.inputs], dict(node.params)))
    except KeyError:  # a param the rule needs is missing
        return False


@functools.lru_cache(maxsize=None)
def plan(signature: tuple) -> Plan:
    """The plan of a graph signature (nodes, inputs, live slot ids).

    ``inputs`` holds each graph input's (dtype, kind, length class): kind
    "array", "host" (a 0-d host scalar) or "device" (a 0-d device scalar);
    lengths appear as classes (equal lengths, equal classes), so one plan
    serves every length."""
    nodes, inputs, live_ids = signature
    meta = {("input", i): (d, lc, kind) for i, (d, kind, lc) in enumerate(inputs)}
    for node in nodes:
        for oid, (d, lc) in zip(node.out_ids, node.out_meta):
            meta[("node", oid)] = (d, lc, "array")
    segments = []  # _GroupCode | Boundary (its reads filled below)
    cur: Optional[_GroupCode] = None
    for i, node in enumerate(nodes):
        if not _fusible(node, meta):
            cur = None
            segments.append(i)
            continue
        rule = RULES[node.op]
        lc = meta[next(ref for ref, pos in zip(node.inputs, rule.positions) if pos == "row")][1]
        scalar_inside = any(pos == "scalar" and ref[0] == "node" and ref[1] in cur.values
                            for ref, pos in zip(node.inputs, rule.positions)) if cur else False
        if cur is None or cur.length_class != lc or scalar_inside or not cur.fits(node):
            cur = _GroupCode(sum(isinstance(s, _GroupCode) for s in segments), meta, lc)
            segments.append(cur)
        cur.add(i, node)
    # a group writes what a live handle holds or a later step reads
    reads_after: list = [set() for _ in segments]
    later: set = set(live_ids)
    for k in range(len(segments) - 1, -1, -1):
        reads_after[k] = set(later)
        s = segments[k]
        if isinstance(s, _GroupCode):
            later |= s.reads
        else:
            later |= {ref[1] for ref in nodes[s].inputs if ref[0] == "node"}
    steps, dev, host = [], [], []
    for s, after in zip(segments, reads_after):
        if not isinstance(s, _GroupCode):
            steps.append(Boundary(s, frozenset(ref[1] for ref in nodes[s].inputs if ref[0] == "node")))
            continue
        outputs = [oid for oid in s.values if oid in after]
        if not outputs:
            continue  # nothing of it is used
        group, dev_text, host_text = s.finish(outputs)
        steps.append(group)
        dev.append(dev_text)
        host.append(host_text)
    source = "" if not dev else PRELUDE + "\n".join(dev) + _ERROR_STRING
    host_source = "" if not host else PRELUDE + "\n".join(host)
    return Plan(tuple(steps), source, host_source)


# ---------------------------------------------------------------------------
# running a plan
# ---------------------------------------------------------------------------


def _scalar_bits(t: torch.Tensor) -> int:
    """The 64-bit pattern of a 0-d host scalar (its bytes, little-endian)."""
    return int.from_bytes(t.reshape(1).numpy().tobytes().ljust(8, b"\0"), "little", signed=True)


def _rows(t: torch.Tensor, dtype: dt.ArrowType) -> int:
    return t.shape[0] * 32 if dtype is _A.BOOL else t.shape[0]


def launch_arguments(group: Group, value: Callable[[tuple], "object"], host: bool = False):
    """The buffers of one run of a group: (operand pointers, output
    pointers, outputs by slot id as AVs, scalar bits, length, capacity).
    `value(ref)` gives an operand's AV; an output validity that resolves to
    none or to an operand's buffer has a null pointer (see
    :func:`resolve_validity`).  Raises where the operands do not have the
    shapes that the eager ops need."""
    from ..ops.kernel import AV

    first = value(group.operands[0].ref)
    length, cap = first.length, _rows(first.data, group.operands[0].dtype)
    words = (cap + 31) // 32
    ptrs = []
    for op in group.operands:
        av = value(op.ref)
        t = av.validity if op.plane == "validity" else av.data
        if t is None:
            ptrs.append(0)
            continue
        bitmap = op.plane == "validity" or (op.plane == "data" and op.dtype is _A.BOOL)
        if not t.is_contiguous() or t.device != first.data.device:
            raise ValueError(f"fused group {group.index}: an operand is not contiguous on {first.data.device}")
        if op.plane == "data" and not bitmap and t.shape[0] != cap:
            raise ValueError(f"fused group {group.index}: an operand of {t.shape[0]} rows, {cap} expected")
        if bitmap and t.shape[0] < words:
            raise ValueError(f"fused group {group.index}: a bitmap of {t.shape[0]} words, {words} expected")
        if op.plane == "first" and t.numel() == 0:
            raise ValueError(f"fused group {group.index}: an empty scalar operand")
        ptrs.append(t.data_ptr())
    scalars = [_scalar_bits(value(op.ref).data) for op in group.scalars]

    def present(ref):
        return value(ref).validity is not None

    device = first.data.device
    new = torch.zeros if host else torch.empty  # the host code ORs bits into its words
    out_ptrs, results = [], {}
    for out in group.outputs:
        if out.dtype is _A.BOOL:
            data = new(words, dtype=torch.int32, device=device)
        else:
            data = new(cap, dtype=dt.info(out.dtype).torch, device=device)
        v = resolve_validity(out.validity, present)
        if v == "computed":
            validity = new(words, dtype=torch.int32, device=device)
            out_ptrs += [data.data_ptr(), validity.data_ptr()]
        else:
            validity = None if v is None else value(v[1]).validity
            out_ptrs += [data.data_ptr(), 0]
        results[out.oid] = AV(data, validity, length, out.dtype)
    return ptrs, out_ptrs, results, scalars, length, cap


_LIBRARIES: Dict[str, tuple] = {}  # source name -> (CDLL, {group symbol: C function})


def source_name(source: str) -> str:
    return "fused_" + hashlib.sha256(source.encode()).hexdigest()[:16]


def _load(p: Plan, lib) -> tuple:
    P, I64 = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)
    fns = {}
    for g in p.groups:
        fn = getattr(lib, g.symbol)
        fn.argtypes = [P, P, I64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[g.symbol] = fn
    lib.atpu_fused_error_string.argtypes = [ctypes.c_int]
    lib.atpu_fused_error_string.restype = ctypes.c_char_p
    return lib, fns


def prepare(plans: Sequence[Plan]) -> None:
    """Build and load the kernels of the plans that are not loaded yet, one
    nvcc process for each source, all started together."""
    todo = {}
    for p in plans:
        if p.source and source_name(p.source) not in _LIBRARIES:
            todo[source_name(p.source)] = p
    libs = _build.build_generated([p.source for p in todo.values()])
    for (name, p), lib in zip(todo.items(), libs):
        _LIBRARIES[name] = _load(p, lib)


def _c_arrays(ptrs, out_ptrs, scalars):
    return ((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_void_p * len(out_ptrs))(*out_ptrs),
            (ctypes.c_int64 * max(1, len(scalars)))(*scalars))


def run_group_cuda(p: Plan, group: Group, value) -> dict:
    """Launch a group's generated kernel on the current stream; returns its
    outputs by slot id."""
    name = source_name(p.source)
    if name not in _LIBRARIES:
        prepare([p])
    lib, fns = _LIBRARIES[name]
    ptrs, out_ptrs, results, scalars, length, cap = launch_arguments(group, value)
    stream = torch.cuda.current_stream(results[group.outputs[0].oid].data.device).cuda_stream
    err = fns[group.symbol](*_c_arrays(ptrs, out_ptrs, scalars), length, cap, stream)
    if err != 0:
        raise RuntimeError(f"fused_pipeline {group.symbol}: CUDA error {err}: "
                           f"{lib.atpu_fused_error_string(err).decode()}")
    if cap > 0:
        KERNEL.launches += 1
    return results


def run_group_host(lib, group: Group, value) -> dict:
    """Run a group's host code (``Plan.host_source`` built with a C++
    compiler) on CPU tensors; returns its outputs by slot id."""
    ptrs, out_ptrs, results, scalars, length, cap = launch_arguments(group, value, host=True)
    fn = getattr(lib, group.symbol)
    P, I64 = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [P, P, I64, ctypes.c_int64, ctypes.c_int64]
    fn.restype = None
    fn(*_c_arrays(ptrs, out_ptrs, scalars), length, cap)
    return results


def run_group_plain(nodes, group: Group, value) -> dict:
    """The plain version of a group: its nodes replayed eagerly; returns
    the outputs by slot id."""
    from ..ops.kernel import execute

    env: dict = {}
    for i in group.nodes:
        node = nodes[i]
        avs = [env[ref[1]] if ref[0] == "node" and ref[1] in env else value(ref) for ref in node.inputs]
        env[node.out_ids[0]] = execute(node.op, avs, dict(node.params))[0]
    return {out.oid: env[out.oid] for out in group.outputs}

"""gtscript-like frontend: parse decorated Python functions into Stencil IR.

Mirrors the paper's GT4Py surface syntax (§III-A, §IV-B):

    @gtstencil
    def smagorinsky_diffusion(vort: Field, delpc: Field, dt: Param):
        with computation(PARALLEL), interval(...):
            vort = dt * (delpc ** 2.0 + vort ** 2.0) ** 0.5

    @gtstencil
    def flux_edge(flux: Field, velocity: Field, cosa: Field, sina: Field,
                  dt2: Param):
        with computation(PARALLEL), interval(...):
            flux = dt2 * (velocity - velocity * cosa) / sina
            with horizontal(region[:, j_start]):
                flux = dt2 * velocity

Semantics follow GT4Py: writes always target offset (0,0,0); reads may be
offset (``q[-1, 0, 0]``); a bare name reads offset zero.  In FORWARD
computations a read of a written field at ``[0, 0, -1]`` observes the value
computed at the level above (loop-carried); symmetrically ``[0, 0, 1]`` in
BACKWARD.  New names introduced by assignment become *temporaries* whose
allocation the backend decides (paper §IV-A item 4).
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Any, Callable

from . import ir
from ..errors import SourceLocation
from .ir import (
    Assign,
    BinOp,
    Computation,
    Const,
    Direction,
    Expr,
    FieldAccess,
    Interval,
    Max,
    Min,
    ParamRef,
    Pow,
    Region,
    Stencil,
    UnaryOp,
    Where,
)

# Sentinels usable in signatures and bodies -------------------------------
class _FieldSentinel(str):
    """``Field`` annotation sentinel; ``Field[interface]`` marks a
    K-interface (nk+1 level) field — vertical staggering à la GT4Py/Devito
    staggered dimensions."""

    def __getitem__(self, item):
        return f"Field[{item}]"


Field = _FieldSentinel("Field")
Param = "Param"
interface = "interface"

PARALLEL = ir.PARALLEL
FORWARD = ir.FORWARD
BACKWARD = ir.BACKWARD

# end-relative index symbols for horizontal regions (paper's i_start etc.)
i_start = 0
j_start = 0
i_end = -1
j_end = -1

_FUNCS: dict[str, Callable[..., Expr]] = {
    "sqrt": ir.sqrt,
    "exp": ir.exp,
    "log": ir.log,
    "abs": ir.absolute,
    "sign": ir.sign,
    "floor": ir.floor,
    "min": ir.minimum,
    "max": ir.maximum,
    "where": ir.where,
    "eq": ir.eq,
}

_BINOPS = {
    ast.Add: "+",
    ast.Sub: "-",
    ast.Mult: "*",
    ast.Div: "/",
}

_CMPOPS = {
    ast.Lt: "<",
    ast.LtE: "<=",
    ast.Gt: ">",
    ast.GtE: ">=",
    ast.Eq: "==",
    ast.NotEq: "!=",
}


class StencilSyntaxError(SyntaxError):
    pass


class _Parser(ast.NodeVisitor):
    def __init__(self, name: str, fields: list[str], params: list[str],
                 consts: dict[str, Any],
                 src_file: str | None = None, line_base: int = 0):
        self.name = name
        self.fields = list(fields)
        self.params = list(params)
        self.consts = consts
        # source-location capture: AST line numbers are relative to the
        # dedented source snippet; ``line_base`` re-anchors them to the file
        self.src_file = src_file
        self.line_base = line_base
        self.temps: list[str] = []
        self.computations: list[Computation] = []
        # current context
        self._direction: Direction | None = None
        self._interval: Interval = Interval()
        self._region: Region | None = None
        self._stmts: list[Assign] = []

    # -- expressions ---------------------------------------------------------
    def expr(self, node: ast.expr) -> Expr:
        if isinstance(node, ast.Constant):
            return Const(node.value)
        if isinstance(node, ast.Name):
            nm = node.id
            if nm in self.fields or nm in self.temps:
                return FieldAccess(nm)
            if nm in self.params:
                return ParamRef(nm)
            if nm in self.consts:
                return Const(self.consts[nm])
            raise StencilSyntaxError(f"{self.name}: unknown name {nm!r}")
        if isinstance(node, ast.Subscript):
            if not isinstance(node.value, ast.Name):
                raise StencilSyntaxError("only field[...] subscripts allowed")
            nm = node.value.id
            if nm not in self.fields and nm not in self.temps:
                raise StencilSyntaxError(f"subscript on non-field {nm!r}")
            off = self._offset(node.slice)
            return FieldAccess(nm, off)
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.Pow):
                return Pow(self.expr(node.left), self.expr(node.right))
            op = _BINOPS.get(type(node.op))
            if op is None:
                raise StencilSyntaxError(f"unsupported operator {node.op}")
            return BinOp(op, self.expr(node.left), self.expr(node.right))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                inner = self.expr(node.operand)
                if isinstance(inner, Const):
                    return Const(-inner.value)
                return UnaryOp("neg", inner)
            raise StencilSyntaxError("unsupported unary op")
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise StencilSyntaxError("chained comparisons unsupported")
            op = _CMPOPS.get(type(node.ops[0]))
            return BinOp(op, self.expr(node.left), self.expr(node.comparators[0]))
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name):
                raise StencilSyntaxError("only builtin stencil funcs callable")
            if node.func.id == "index_search":
                return self._parse_index_search(node)
            if node.func.id == "at_found":
                return self._parse_at_found(node)
            fn = _FUNCS.get(node.func.id)
            if fn is None:
                raise StencilSyntaxError(f"unknown function {node.func.id!r}")
            return fn(*[self.expr(a) for a in node.args])
        if isinstance(node, ast.IfExp):
            return Where(self.expr(node.test), self.expr(node.body),
                         self.expr(node.orelse))
        raise StencilSyntaxError(f"unsupported expression {ast.dump(node)}")

    def _field_name(self, node: ast.expr, what: str) -> str:
        if not (isinstance(node, ast.Name)
                and (node.id in self.fields or node.id in self.temps)):
            raise StencilSyntaxError(f"{what} must be a bare field name")
        return node.id

    def _parse_index_search(self, node: ast.Call) -> Expr:
        """``index_search(coord, target, body[, lo, hi])`` — the bounded
        sequential-iteration construct: a monotone K-level search over the
        ``coord`` column, lowered by every backend to a real loop."""
        args = node.args
        if not 3 <= len(args) <= 5:
            raise StencilSyntaxError(
                "index_search(coord, target, body[, lo, hi])")
        coord = self._field_name(args[0], "index_search coordinate")
        target = self.expr(args[1])
        body = self.expr(args[2])
        lo = self._static_int(args[3]) if len(args) > 3 else None
        hi = self._static_int(args[4]) if len(args) > 4 else None
        return ir.index_search(coord, target, body, lo, hi)

    def _parse_at_found(self, node: ast.Call) -> Expr:
        """``at_found(field[, dk])`` — read ``field`` at the level the
        enclosing ``index_search`` selected, plus static offset ``dk``."""
        args = node.args
        if not 1 <= len(args) <= 2:
            raise StencilSyntaxError("at_found(field[, dk])")
        name = self._field_name(args[0], "at_found field")
        dk = self._static_int(args[1]) if len(args) > 1 else 0
        return ir.at_found(name, dk)

    def _offset(self, node: ast.expr) -> tuple[int, int, int]:
        if isinstance(node, ast.Tuple):
            elts = node.elts
        else:
            elts = [node]
        if len(elts) != 3:
            raise StencilSyntaxError("field offsets must be [di, dj, dk]")
        out = []
        for e in elts:
            v = self._static_int(e)
            out.append(v)
        return tuple(out)  # type: ignore[return-value]

    def _static_int(self, e: ast.expr) -> int:
        if isinstance(e, ast.Constant) and isinstance(e.value, int):
            return e.value
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
            return -self._static_int(e.operand)
        if isinstance(e, ast.Name) and e.id in self.consts:
            return int(self.consts[e.id])
        raise StencilSyntaxError("offsets must be static integers")

    # -- statements ------------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        ctx_items = node.items
        new_dir: Direction | None = None
        new_interval: Interval | None = None
        new_region: Region | None = None
        for item in ctx_items:
            call = item.context_expr
            if not isinstance(call, ast.Call) or not isinstance(call.func, ast.Name):
                raise StencilSyntaxError("with-items must be computation()/interval()/horizontal()")
            fname = call.func.id
            if fname == "computation":
                arg = call.args[0]
                if not isinstance(arg, ast.Name):
                    raise StencilSyntaxError("computation(PARALLEL|FORWARD|BACKWARD)")
                new_dir = {"PARALLEL": ir.PARALLEL, "FORWARD": ir.FORWARD,
                           "BACKWARD": ir.BACKWARD}[arg.id]
            elif fname == "interval":
                new_interval = self._parse_interval(call)
            elif fname == "horizontal":
                new_region = self._parse_region(call.args[0])
            else:
                raise StencilSyntaxError(f"unknown with-item {fname!r}")

        saved = (self._direction, self._interval, self._region)
        if new_dir is not None:
            # starting a new computation block: flush previous
            self._flush()
            self._direction = new_dir
        if new_interval is not None:
            self._interval = new_interval
        if new_region is not None:
            self._region = new_region
        for stmt in node.body:
            self.visit(stmt)
        if new_dir is not None:
            self._flush()
        (self._direction, self._interval, self._region) = saved

    def _parse_interval(self, call: ast.Call) -> Interval:
        args = call.args
        if len(args) == 1 and isinstance(args[0], ast.Constant) and args[0].value is Ellipsis:
            return ir.interval()
        vals: list[int | None] = []
        for a in args:
            if isinstance(a, ast.Constant) and a.value is None:
                vals.append(None)
            else:
                vals.append(self._static_int(a))
        return ir.interval(*vals)

    def _parse_region(self, node: ast.expr) -> Region:
        # expects region[i_spec, j_spec]
        if not (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                and node.value.id == "region"):
            raise StencilSyntaxError("horizontal(region[...]) expected")
        sl = node.slice
        if not isinstance(sl, ast.Tuple) or len(sl.elts) != 2:
            raise StencilSyntaxError("region[i, j] takes two specs")

        def spec(e: ast.expr):
            if isinstance(e, ast.Slice):
                lo = None if e.lower is None else self._static_int(e.lower)
                hi = None if e.upper is None else self._static_int(e.upper)
                if lo is None and hi is None:
                    return None
                return slice(lo, hi)
            return self._static_int(e)

        return ir.region(spec(sl.elts[0]), spec(sl.elts[1]))

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._direction is None:
            raise StencilSyntaxError("assignment outside computation block")
        if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
            raise StencilSyntaxError("single bare-name assignment targets only")
        tgt = node.targets[0].id
        value = self.expr(node.value)
        if tgt not in self.fields and tgt not in self.temps:
            self.temps.append(tgt)
        self._stmts.append(Assign(tgt, value, self._interval, self._region,
                                  loc=self._loc(node)))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if not isinstance(node.target, ast.Name):
            raise StencilSyntaxError("augmented assignment to bare names only")
        op = _BINOPS.get(type(node.op))
        tgt = node.target.id
        cur = FieldAccess(tgt)
        value = BinOp(op, cur, self.expr(node.value))
        if tgt not in self.fields and tgt not in self.temps:
            raise StencilSyntaxError("augmented assignment to undefined name")
        self._stmts.append(Assign(tgt, value, self._interval, self._region,
                                  loc=self._loc(node)))

    def _loc(self, node: ast.stmt) -> SourceLocation | None:
        if self.src_file is None:
            return None
        return SourceLocation(self.src_file, self.line_base + node.lineno)

    def visit_Expr(self, node: ast.Expr) -> None:
        if isinstance(node.value, ast.Constant):  # docstring
            return
        raise StencilSyntaxError("expression statements unsupported")

    def generic_visit(self, node):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.With, ast.Expr)):
            super().generic_visit(node)
        elif isinstance(node, (ast.FunctionDef, ast.Module)):
            for stmt in ast.iter_child_nodes(node):
                if isinstance(stmt, (ast.With, ast.Assign, ast.AugAssign, ast.Expr)):
                    self.visit(stmt)
                elif isinstance(stmt, (ast.arguments, ast.arg, ast.Name, ast.Load,
                                       ast.Store, ast.Constant)):
                    continue
        else:
            raise StencilSyntaxError(f"unsupported statement {type(node).__name__}")

    def _flush(self) -> None:
        if self._stmts and self._direction is not None:
            self.computations.append(
                Computation(self._direction, tuple(self._stmts)))
        self._stmts = []


def gtstencil(fn: Callable | None = None, *, name: str | None = None):
    """Decorator parsing a Python function into a :class:`Stencil`."""

    def build(f: Callable) -> Stencil:
        src = textwrap.dedent(inspect.getsource(f))
        try:
            src_file = inspect.getsourcefile(f)
            line_base = inspect.getsourcelines(f)[1] - 1
        except (OSError, TypeError):  # pragma: no cover - exotic callables
            src_file, line_base = None, 0
        tree = ast.parse(src)
        fdef = tree.body[0]
        assert isinstance(fdef, ast.FunctionDef)
        fields: list[str] = []
        params: list[str] = []
        iface: list[str] = []
        for a in fdef.args.args:
            ann = a.annotation
            if isinstance(ann, ast.Subscript):
                # Field[interface] — a K-interface (nk+1 level) field
                base = ann.value.id if isinstance(ann.value, ast.Name) else None
                sub = ann.slice
                sub_id = sub.id if isinstance(sub, ast.Name) else (
                    sub.value if isinstance(sub, ast.Constant) else None)
                if base != "Field" or sub_id != "interface":
                    raise StencilSyntaxError(
                        f"{fdef.name}: unsupported annotation on {a.arg!r}; "
                        "only Field[interface] is subscriptable")
                fields.append(a.arg)
                iface.append(a.arg)
                continue
            ann_id = ann.id if isinstance(ann, ast.Name) else (
                ann.value if isinstance(ann, ast.Constant) else None)
            if ann_id in ("Field", None):
                fields.append(a.arg)
            else:
                params.append(a.arg)
        consts = {}
        closure = inspect.getclosurevars(f)
        for scope in (closure.globals, closure.nonlocals):
            for k, v in scope.items():
                if isinstance(v, (int, float, bool)):
                    consts[k] = v
        p = _Parser(name or fdef.name, fields, params, consts,
                    src_file=src_file, line_base=line_base)
        for stmt in fdef.body:
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
                continue  # docstring
            p.visit(stmt)
        p._flush()
        # outputs = fields written + temporaries that escape (none escape: all
        # temporaries are internal; the caller names outputs via written fields)
        written = []
        for c in p.computations:
            for w in c.written():
                if w in fields and w not in written:
                    written.append(w)
        return Stencil(
            name=name or fdef.name,
            computations=tuple(p.computations),
            fields=tuple(fields),
            outputs=tuple(written),
            params=tuple(params),
            interface_fields=tuple(iface),
        )

    if fn is not None:
        return build(fn)
    return build


# names importable for use inside stencil bodies (they are parsed, not run,
# but having real bindings keeps linters and tests honest)
computation = ir.Direction  # placeholder binding
horizontal = None
region = None
index_search = ir.index_search
at_found = ir.at_found

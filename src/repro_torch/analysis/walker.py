"""AST walker: one pass over a module, one :class:`ModuleInfo` out.

The walker extracts everything the NAV rules need — NavP boundary calls
(``hop``/``publish``/``relay``), resource constructions and their
lifetimes, ``Stage(...)`` uses, node declarations, nondeterminism sources,
suppression comments — so each rule in :mod:`repro_torch.analysis.rules` is a
pure function over this model instead of its own tree traversal.

Scope model: every ``def`` (and the module body itself, as the pseudo-
function ``<module>`` — example scripts hop and publish at top level) gets
a :class:`FunctionInfo` with *lexical* event positions. Rules reason in
line order within one scope; loop back-edges are deliberately ignored
(documented in ``docs/analysis.md`` § Limitations).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

# comment grammar:  # navlint: disable=NAV101,NAV202   (this line)
#                   # navlint: disable-file=NAV104     (whole file)
_SUPPRESS_RE = re.compile(
    r"#\s*navlint:\s*(disable(?:-file)?)\s*(?:=\s*([A-Z0-9,\s]+))?"
)

# call names that move or snapshot live state — the migration boundaries
_BOUNDARY_HOP = {"hop", "hop_stream"}
_BOUNDARY_PUBLISH = {"publish", "publish_ref"}
_BOUNDARY_SVC_PREFIXES = ("svc/hop", "svc/relay", "svc/publish")

_CLOSE_METHODS = {"close", "join", "shutdown", "terminate", "release", "stop"}
_MUTATING_METHODS = {
    "update", "setdefault", "pop", "popitem", "clear",
    "append", "extend", "insert", "remove",
}

_LOCK_NAMES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_THREAD_NAMES = {"Thread", "ThreadPoolExecutor", "ProcessPoolExecutor", "Popen"}


@dataclass
class Resource:
    """A migration-hostile value created in this scope."""

    name: str  # bound local name ("" when the with-item has no `as`)
    kind: str  # file | socket | lock | thread | generator
    line: int
    desc: str  # human label of the constructor, e.g. "open(...)"
    with_span: tuple[int, int] | None = None  # (lineno, end_lineno) of `with`
    closed_at: int | None = None  # earliest close/join/del in this scope


@dataclass
class Boundary:
    """A call that migrates or snapshots live state."""

    line: int
    kind: str  # "hop" | "publish"
    desc: str  # rendered call name, e.g. "dhp.hop(...)"
    arg_names: set[str] = field(default_factory=set)  # Names inside the args


@dataclass
class NondetCall:
    line: int
    desc: str  # e.g. "time.time()"


@dataclass
class StageUse:
    """One ``Stage(...)`` construction."""

    line: int
    dest_literal: str | None
    fn_expr: ast.expr | None
    fn_ref: str | None  # literal fn_ref= value, if any
    in_function: str  # qualname of enclosing scope


@dataclass
class FunctionInfo:
    name: str
    qualname: str
    line: int
    nested: bool  # defined inside another function (a closure)
    is_module: bool = False
    boundaries: list[Boundary] = field(default_factory=list)
    resources: list[Resource] = field(default_factory=list)
    nondet: list[NondetCall] = field(default_factory=list)
    uses: dict[str, list[int]] = field(default_factory=dict)  # Name loads
    rebinds: dict[str, list[int]] = field(default_factory=dict)
    mutations: dict[str, list[tuple[int, str]]] = field(default_factory=dict)
    has_yield: bool = False


@dataclass
class ModuleInfo:
    path: Path
    is_script: bool  # not importable by a worker (no package __init__.py)
    suppressions: dict[int, set[str]]  # line -> codes ("*" = all)
    file_suppressions: set[str]
    module_aliases: set[str]  # names bound by `import x [as y]`
    imported_names: set[str]  # names bound by `from x import y`
    functions: list[FunctionInfo]
    stage_uses: list[StageUse]
    registered_fn_names: set[str]  # register_stage(..., fn) targets
    declared_nodes: set[str]
    declarations_complete: bool  # False when any add_node arg was dynamic
    generator_fn_names: dict[str, int]  # top-level defs containing yield -> def line

    def function_named(self, name: str) -> FunctionInfo | None:
        """Best-match lookup: top-level def first, then any nested def."""
        nested_hit = None
        for fn in self.functions:
            if fn.name != name or fn.is_module:
                continue
            if not fn.nested:
                return fn
            nested_hit = nested_hit or fn
        return nested_hit


def _call_name(node: ast.Call) -> tuple[str | None, str | None]:
    """(base, attr) for ``base.attr(...)``; (None, name) for ``name(...)``."""
    f = node.func
    if isinstance(f, ast.Name):
        return None, f.id
    if isinstance(f, ast.Attribute):
        base = f.value.id if isinstance(f.value, ast.Name) else None
        return base, f.attr
    return None, None


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted rendering of a call target for messages."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    if isinstance(node, ast.Call):
        return f"{_dotted(node.func)}(...)"
    return "<expr>"


def _str_arg(node: ast.Call, index: int, *kw: str) -> str | None:
    """Literal string at positional ``index`` or any of keywords ``kw``."""
    if len(node.args) > index and isinstance(node.args[index], ast.Constant):
        v = node.args[index].value
        if isinstance(v, str):
            return v
    for k in node.keywords:
        if k.arg in kw and isinstance(k.value, ast.Constant) and isinstance(k.value.value, str):
            return k.value.value
    return None


def _names_in(nodes) -> set[str]:
    out: set[str] = set()
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Name):
                out.add(sub.id)
    return out


def classify_boundary(node: ast.Call) -> tuple[str, str] | None:
    """(kind, desc) when ``node`` is a migration boundary, else None."""
    base, attr = _call_name(node)
    if attr in _BOUNDARY_HOP:
        return "hop", f"{_dotted(node.func)}(...)"
    if attr in _BOUNDARY_PUBLISH:
        return "publish", f"{_dotted(node.func)}(...)"
    if attr == "call":
        for arg in node.args[:2]:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if arg.value.startswith(_BOUNDARY_SVC_PREFIXES):
                    kind = "publish" if "publish" in arg.value else "hop"
                    return kind, f'{_dotted(node.func)}("{arg.value}", ...)'
    return None


def classify_resource(node: ast.Call, mod: "ModuleInfo") -> tuple[str, str] | None:
    """(kind, desc) when ``node`` constructs a migration-hostile resource."""
    base, attr = _call_name(node)
    desc = f"{_dotted(node.func)}(...)"
    if base is None and attr == "open":
        return "file", desc
    if base in {"os", "io", "gzip", "bz2", "lzma"} and attr in {"open", "fdopen"}:
        return "file", desc
    if base == "tempfile" and attr in {"NamedTemporaryFile", "TemporaryFile"}:
        return "file", desc
    if base == "socket" and attr in {"socket", "create_connection", "socketpair"}:
        return "socket", desc
    if base == "wire" and attr == "connect":  # the fabric's own sockets
        return "socket", desc
    if attr in _LOCK_NAMES and (base in {"threading", "multiprocessing"}
                                or (base is None and attr in mod.imported_names)):
        return "lock", desc
    if attr in _THREAD_NAMES and (
        base in {"threading", "concurrent", "futures", "subprocess", "multiprocessing"}
        or (base is None and attr in mod.imported_names)
    ):
        return "thread", desc
    if base is None and attr == "iter":
        return "generator", desc
    if base is None and attr in mod.generator_fn_names:
        def_line = mod.generator_fn_names[attr]
        return "generator", f"{attr}(...) [generator function, line {def_line}]"
    return None


def classify_nondet(node: ast.Call) -> str | None:
    """Message when ``node`` is a nondeterminism source, else None.

    Deliberately excludes ``time.monotonic``/``perf_counter`` (measurement,
    not state) and ``uuid`` (infra naming). Seeded constructions —
    ``default_rng(seed)``, ``random.Random(seed)`` — pass.
    """
    base, attr = _call_name(node)
    if base == "time" and attr in {"time", "time_ns"}:
        return f"time.{attr}() is wall-clock — resumed runs see a different value"
    if attr in {"now", "utcnow", "today"} and base in {"datetime", "date"}:
        return f"{base}.{attr}() is wall-clock — resumed runs see a different value"
    if base == "random" and attr in {
        "random", "randint", "randrange", "choice", "choices", "shuffle",
        "sample", "uniform", "gauss", "normalvariate", "getrandbits", "betavariate",
    }:
        return f"random.{attr}() draws from the unseeded global RNG"
    if base == "random" and attr == "Random" and not node.args:
        return "random.Random() with no seed is entropy-seeded"
    if base == "random" and attr == "SystemRandom":
        return "random.SystemRandom is OS entropy — never reproducible"
    if attr == "default_rng" and not node.args and not node.keywords:
        return "default_rng() with no seed is entropy-seeded"
    if base == "os" and attr == "urandom":
        return "os.urandom() is OS entropy — never reproducible"
    if base == "secrets":
        return f"secrets.{attr}() is OS entropy — never reproducible"
    return None


_NP_RANDOM_LEGACY = {
    "random", "rand", "randn", "randint", "choice", "shuffle", "permutation",
    "uniform", "normal", "standard_normal", "poisson", "exponential", "beta",
}


def _classify_np_random(node: ast.Call) -> str | None:
    """np.random.<legacy fn>() — the unseeded numpy global RNG."""
    f = node.func
    if not isinstance(f, ast.Attribute) or f.attr not in _NP_RANDOM_LEGACY:
        return None
    v = f.value
    if (isinstance(v, ast.Attribute) and v.attr == "random"
            and isinstance(v.value, ast.Name) and v.value.id in {"np", "numpy"}):
        return f"np.random.{f.attr}() draws from numpy's global RNG"
    return None


def _scan_suppressions(source: str) -> tuple[dict[int, set[str]], set[str]]:
    per_line: dict[int, set[str]] = {}
    per_file: set[str] = set()
    for i, line in enumerate(source.splitlines(), 1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        codes = (
            {c.strip() for c in m.group(2).split(",") if c.strip()}
            if m.group(2) else {"*"}
        )
        if m.group(1) == "disable-file":
            per_file |= codes
        else:
            per_line.setdefault(i, set()).update(codes)
    return per_line, per_file


class _Collector(ast.NodeVisitor):
    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.stack: list[FunctionInfo] = []

    # -- scopes -------------------------------------------------------------

    def _enter(self, fi: FunctionInfo, node: ast.AST) -> None:
        self.mod.functions.append(fi)
        self.stack.append(fi)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_def(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_def(node)

    def _visit_def(self, node) -> None:
        parent = self.stack[-1]
        qual = (f"{parent.qualname}.<locals>.{node.name}"
                if not parent.is_module else node.name)
        fi = FunctionInfo(
            name=node.name, qualname=qual, line=node.lineno,
            nested=not parent.is_module,
        )
        self._enter(fi, node)

    # -- imports ------------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.mod.module_aliases.add(alias.asname or alias.name.split(".")[0])

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for alias in node.names:
            self.mod.imported_names.add(alias.asname or alias.name)

    # -- statements feeding rule state --------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        fi = self.stack[-1]
        targets: list[ast.expr] = []
        for t in node.targets:
            targets.extend(t.elts if isinstance(t, ast.Tuple) else [t])
        for t in targets:
            if isinstance(t, ast.Name):
                fi.rebinds.setdefault(t.id, []).append(node.lineno)
                if isinstance(node.value, ast.Call):
                    kind = classify_resource(node.value, self.mod)
                    if kind:
                        fi.resources.append(Resource(
                            name=t.id, kind=kind[0], line=node.lineno, desc=kind[1],
                        ))
                elif isinstance(node.value, ast.GeneratorExp):
                    fi.resources.append(Resource(
                        name=t.id, kind="generator", line=node.lineno,
                        desc="generator expression",
                    ))
            elif isinstance(t, (ast.Subscript, ast.Attribute)):
                v = t.value
                if isinstance(v, ast.Name):
                    fi.mutations.setdefault(v.id, []).append(
                        (node.lineno, f"{_dotted(t)} = ...")
                    )
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        fi = self.stack[-1]
        t = node.target
        if isinstance(t, ast.Name):
            fi.rebinds.setdefault(t.id, []).append(node.lineno)
        elif isinstance(t, (ast.Subscript, ast.Attribute)) and isinstance(t.value, ast.Name):
            fi.mutations.setdefault(t.value.id, []).append(
                (node.lineno, f"{_dotted(t)} op= ...")
            )
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        fi = self.stack[-1]
        for t in node.targets:
            if isinstance(t, ast.Name):
                self._mark_closed(fi, t.id, node.lineno)
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        fi = self.stack[-1]
        for item in node.items:
            if isinstance(item.context_expr, ast.Call):
                kind = classify_resource(item.context_expr, self.mod)
                if kind:
                    name = (item.optional_vars.id
                            if isinstance(item.optional_vars, ast.Name) else "")
                    fi.resources.append(Resource(
                        name=name, kind=kind[0], line=node.lineno, desc=kind[1],
                        with_span=(node.lineno, node.end_lineno or node.lineno),
                    ))
        self.generic_visit(node)

    def _mark_closed(self, fi: FunctionInfo, name: str, line: int) -> None:
        for res in fi.resources:
            if res.name == name and res.with_span is None:
                if res.closed_at is None or line < res.closed_at:
                    res.closed_at = line

    # -- calls ---------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        fi = self.stack[-1]
        base, attr = _call_name(node)

        # Stage(...) constructions
        if attr == "Stage":
            fn_expr = None
            if len(node.args) > 1:
                fn_expr = node.args[1]
            else:
                for k in node.keywords:
                    if k.arg == "fn":
                        fn_expr = k.value
            self.mod.stage_uses.append(StageUse(
                line=node.lineno,
                dest_literal=_str_arg(node, 0, "dest"),
                fn_expr=fn_expr,
                fn_ref=_str_arg(node, 99, "fn_ref"),
                in_function=fi.qualname,
            ))

        # register_stage(name, fn)
        if attr == "register_stage":
            fn_arg = node.args[1] if len(node.args) > 1 else None
            for k in node.keywords:
                if k.arg == "fn":
                    fn_arg = k.value
            if isinstance(fn_arg, ast.Name):
                self.mod.registered_fn_names.add(fn_arg.id)

        # node declarations
        if attr in {"add_node", "add_remote_node"}:
            lit = _str_arg(node, 0, "name")
            if lit is None:
                self.mod.declarations_complete = False
            else:
                self.mod.declared_nodes.add(lit)

        # migration boundaries
        b = classify_boundary(node)
        if b is not None:
            fi.boundaries.append(Boundary(
                line=node.lineno, kind=b[0], desc=b[1],
                arg_names=_names_in(node.args) | _names_in([k.value for k in node.keywords]),
            ))

        # resource closes (f.close(), t.join(), ...)
        if attr in _CLOSE_METHODS and base is not None:
            self._mark_closed(fi, base, node.lineno)

        # mutating method calls (state.update(...), xs.append(...))
        if attr in _MUTATING_METHODS and base is not None:
            fi.mutations.setdefault(base, []).append(
                (node.lineno, f"{base}.{attr}(...)")
            )

        # nondeterminism sources
        msg = classify_nondet(node) or _classify_np_random(node)
        if msg is not None:
            fi.nondet.append(NondetCall(line=node.lineno, desc=msg))

        self.generic_visit(node)

    # -- name uses -----------------------------------------------------------

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load):
            self.stack[-1].uses.setdefault(node.id, []).append(node.lineno)

    def visit_Yield(self, node: ast.Yield) -> None:
        self.stack[-1].has_yield = True
        self.generic_visit(node)

    def visit_YieldFrom(self, node: ast.YieldFrom) -> None:
        self.stack[-1].has_yield = True
        self.generic_visit(node)


def parse_module(path: str | Path, source: str | None = None) -> ModuleInfo:
    """Parse one Python file into the rule-facing model."""
    path = Path(path)
    if source is None:
        source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    per_line, per_file = _scan_suppressions(source)
    mod = ModuleInfo(
        path=path,
        is_script=not (path.parent / "__init__.py").exists(),
        suppressions=per_line,
        file_suppressions=per_file,
        module_aliases=set(),
        imported_names=set(),
        functions=[],
        stage_uses=[],
        registered_fn_names=set(),
        declared_nodes=set(),
        declarations_complete=True,
        generator_fn_names={},
    )
    # pre-pass: top-level generator functions, so calls to them classify as
    # generator resources during the main pass
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                if isinstance(sub, (ast.Yield, ast.YieldFrom)):
                    mod.generator_fn_names[node.name] = node.lineno
                    break
    module_fi = FunctionInfo(
        name="<module>", qualname="<module>", line=1, nested=False, is_module=True,
    )
    mod.functions.append(module_fi)
    collector = _Collector(mod)
    collector.stack.append(module_fi)
    collector.visit(tree)
    return mod

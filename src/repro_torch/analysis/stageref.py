"""Static stage-ref resolver: the AST mirror of ``itinerary.stage_ref``.

``server.resolve_stage`` accepts exactly two spellings — a
``register_stage``'d name or an importable ``pkg.mod:qualname`` — and the
runtime classifier :func:`repro_torch.core.itinerary.ref_obstacle` is the single
source of what is importable. This module applies the same obstacle rules
to a ``Stage(...)`` call's ``fn`` argument *before* any process exists:
what navlint flags here is exactly what would surface at runtime as a
``StageResolutionError`` or a silent localize-and-run-driver-side.
"""

from __future__ import annotations

import ast

from repro_torch.core.itinerary import ref_obstacle
from repro_torch.analysis.walker import ModuleInfo


def classify_stage_fn(fn_expr: ast.expr, mod: ModuleInfo) -> tuple[str, str] | None:
    """(code, message) when ``fn_expr`` is not worker-addressable, else None.

    Conservative by design: expressions whose provenance the single-file
    view cannot establish (imported names, attributes of unknown objects,
    factory-call results) are assumed addressable — navlint never guesses
    a violation.
    """
    # Stage(dest, lambda s: ..., ...)
    if isinstance(fn_expr, ast.Lambda):
        return "NAV101", (
            "Stage.fn is a lambda — "
            f"{ref_obstacle('m', '<lambda>')}; svc/run_stage cannot resolve "
            "it in a worker, so the tour will silently fetch the state and "
            "run driver-side. Use a module-level function (or register_stage "
            "+ fn_ref)."
        )

    # Stage(dest, functools.partial(fn, ...), ...) / partial(fn, ...)
    if isinstance(fn_expr, ast.Call):
        f = fn_expr.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None
        )
        if name == "partial":
            return "NAV103", (
                "Stage.fn is a functools.partial — "
                f"{ref_obstacle(None, None, partial=True)}. Wrap it in a "
                "module-level function or register_stage it under a name."
            )
        return None  # factory call: provenance unknown, assume addressable

    # Stage(dest, some_name, ...)
    if isinstance(fn_expr, ast.Name):
        fn_info = mod.function_named(fn_expr.id)
        if fn_info is None:
            return None  # imported or dynamic — assume addressable
        if fn_info.nested:
            return "NAV102", (
                f"Stage.fn `{fn_expr.id}` is a nested function (defined at "
                f"line {fn_info.line}) — "
                f"{ref_obstacle('m', 'outer.<locals>.f')}. Move it to module "
                "level."
            )
        if mod.is_script:
            return "NAV104", (
                f"Stage.fn `{fn_expr.id}` is defined in a script "
                f"(no package __init__.py next to {mod.path.name}) — "
                f"{ref_obstacle('__main__', fn_expr.id)}. Move it into an "
                "importable package module to ship the computation instead "
                "of the data, or suppress if driver-side localization is "
                "intended."
            )
        return None

    # Stage(dest, obj.method, ...)
    if isinstance(fn_expr, ast.Attribute):
        base = fn_expr.value
        if isinstance(base, ast.Name):
            if base.id in mod.module_aliases:
                return None  # module-qualified function: importable
            known_local = any(
                base.id in fn.rebinds for fn in mod.functions
            )
            if base.id == "self" or known_local:
                return "NAV103", (
                    f"Stage.fn `{base.id}.{fn_expr.attr}` looks like a bound "
                    f"method — {ref_obstacle(None, None, bound=True)}. Use a "
                    "module-level function taking the state, or register_stage."
                )
        return None

    return None

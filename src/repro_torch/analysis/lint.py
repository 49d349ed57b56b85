"""Pass 2 — AST repo lint for the serving/DES source discipline.

Rule IDs are stable:

======  ====================================================================
AST101  raise-before-mutate — in a transactional allocator/backend method,
        no write to ``self`` state may lexically precede an ``OutOfPages``
        raise (or a ``_check_feasible`` guard call) that would abort the
        method with the mutation already applied.  Mutations inside
        branches that terminate (return/raise/continue/break) or inside
        rolled-back ``try`` bodies whose handlers re-raise are exempt.
AST102  reserve-before-commit — ``decode_step`` must call
        ``_reserve_step`` before any decode-state commit/advance call
        (the step protocol: reserve pages first, mutate states after).
AST103  wall-clock ban — no ``time.time``/``perf_counter``/``monotonic``/
        ``sleep`` inside DES/cluster/engine code; the virtual timeline is
        the only clock (``serving/clock.py``'s WallClock is the one
        allowlisted adapter).
AST104  tracer discipline — no conditional guarding a ``tracer.`` call;
        hot loops call the tracer unconditionally and NULL_TRACER makes
        the disabled path a no-op method call, not a branch.
AST105  host-commit purity — the batched host-commit path
        (``core/chunked.py``, ``core/diffusion.py``) is numpy-only: no
        ``torch`` (nor ``jax``/``jnp``) import or use (a device op per tick
        in the commit loop is a hidden dispatch + transfer).
======  ====================================================================
"""

from __future__ import annotations

import ast
import os

from repro_torch.analysis.findings import Finding

# Scopes, relative to the repo root.
DES_SCOPE = ("src/repro_torch/serving/", "src/repro_torch/cluster/")
TRANSACTIONAL_SCOPE = ("src/repro_torch/serving/kv_pool.py",
                       "src/repro_torch/serving/backends.py")
HOST_COMMIT_SCOPE = ("src/repro_torch/core/chunked.py",
                     "src/repro_torch/core/diffusion.py")

TRANSACTIONAL_EXCEPTIONS = {"OutOfPages"}
GUARD_CALLS = {"_check_feasible"}
# self-methods that mutate allocator state when called
MUTATING_HELPERS = {"_pop_page_on", "_deref", "_spill_node", "_drop_node",
                    "_mark_dirty"}
MUTATOR_METHODS = {"append", "pop", "remove", "add", "clear", "update",
                   "extend", "insert", "discard", "popleft", "setdefault"}
WALLCLOCK_NAMES = {"time", "perf_counter", "monotonic", "sleep",
                   "process_time"}
DEVICE_MODULES = {"torch", "jax"}     # AST105: what the host path may not use
DECODE_COMMIT_CALLS = {"batch_apply_step", "apply_step", "commit",
                       "advance", "_step_slide_batched", "_step_ar_paged",
                       "_step_block_pinned"}


def repo_root() -> str:
    return os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        "..", "..", ".."))


def _files_in(root: str, scope) -> list:
    out = []
    for rel in scope:
        path = os.path.join(root, rel)
        if os.path.isfile(path):
            out.append(rel)
        elif os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if name.endswith(".py"):
                    out.append(os.path.join(rel, name))
    return out


def _parse(root: str, rel: str):
    with open(os.path.join(root, rel)) as f:
        return ast.parse(f.read(), filename=rel)


# ---------------------------------------------------------------------------
# AST101 — raise-before-mutate
# ---------------------------------------------------------------------------

def _rooted_at_self(node) -> bool:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return isinstance(node, ast.Name) and node.id == "self"


def _stmt_mutates_self(stmt) -> bool:
    """Does this statement (sub-AST, excluding nested defs) write ``self``
    state — assignment/deletion of a self attribute/subscript, a mutator
    method call on self state, or a known mutating self-helper call?"""
    for node in ast.walk(stmt):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                if any(isinstance(e, (ast.Attribute, ast.Subscript))
                       and _rooted_at_self(e) for e in elts):
                    return True
        elif isinstance(node, ast.Delete):
            if any(_rooted_at_self(t) for t in node.targets):
                return True
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            f = node.func
            if f.attr in MUTATOR_METHODS and _rooted_at_self(f.value):
                return True
            if f.attr in MUTATING_HELPERS and _rooted_at_self(f.value):
                return True
    return False


def _raise_points(stmt):
    """(kind, lineno) raise points directly in this statement: a literal
    ``raise OutOfPages`` or a guard call that raises on infeasibility."""
    out = []
    if isinstance(stmt, ast.Raise) and stmt.exc is not None:
        exc = stmt.exc
        name = None
        if isinstance(exc, ast.Call):
            exc = exc.func
        if isinstance(exc, ast.Name):
            name = exc.id
        elif isinstance(exc, ast.Attribute):
            name = exc.attr
        if name in TRANSACTIONAL_EXCEPTIONS:
            out.append((f"raise {name}", stmt.lineno))
    for node in ast.walk(stmt):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in GUARD_CALLS:
            out.append((f"{node.func.attr}() guard", node.lineno))
    return out


def _terminates(body) -> bool:
    return bool(body) and isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _flow(body, mutated: bool, rel: str, method: str, findings: list,
          exempt: bool = False) -> bool:
    """Walk a statement list tracking whether a self-state mutation has
    happened on the fall-through path; emit AST101 when a raise point is
    reached with the flag set.  Returns the flag at block exit."""
    for stmt in body:
        for what, lineno in ([] if exempt else _raise_points(stmt)):
            if mutated:
                findings.append(Finding(
                    "AST101", f"{rel}:{lineno}",
                    f"{method}: state was mutated before the {what} at "
                    f"line {lineno} — a failed feasibility check would "
                    f"leave the mutation applied (raise-before-mutate)"))
        if isinstance(stmt, ast.If):
            m_body = _flow(stmt.body, mutated, rel, method, findings,
                           exempt)
            m_else = _flow(stmt.orelse, mutated, rel, method, findings,
                           exempt)
            if not _terminates(stmt.body):
                mutated = mutated or m_body
            if not _terminates(stmt.orelse):
                mutated = mutated or m_else
        elif isinstance(stmt, (ast.For, ast.While)):
            # two passes: a raise on iteration N can follow a mutation
            # from iteration N-1
            m = _flow(stmt.body, mutated, rel, method, findings, exempt)
            if m and not mutated:
                _flow(stmt.body, True, rel, method, findings, exempt)
            mutated = mutated or m
            mutated = _flow(stmt.orelse, mutated, rel, method, findings,
                            exempt)
        elif isinstance(stmt, ast.Try):
            m_try = _flow(stmt.body, mutated, rel, method, findings,
                          exempt)
            for h in stmt.handlers:
                # handler = the rollback path; its re-raise is the
                # transactional exit, not a violation
                _flow(h.body, m_try, rel, method, findings, exempt=True)
            mutated = _flow(stmt.finalbody, m_try, rel, method, findings,
                            exempt)
        elif isinstance(stmt, ast.With):
            mutated = _flow(stmt.body, mutated, rel, method, findings,
                            exempt)
        else:
            if _stmt_mutates_self(stmt):
                mutated = True
    return mutated


def check_raise_before_mutate(root: str | None = None,
                              scope=TRANSACTIONAL_SCOPE) -> list:
    root = root or repo_root()
    findings: list = []
    for rel in _files_in(root, scope):
        tree = _parse(root, rel)
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for fn in cls.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    _flow(fn.body, False, rel,
                          f"{cls.name}.{fn.name}", findings)
    return findings


# ---------------------------------------------------------------------------
# AST102 — reserve-before-commit in decode_step
# ---------------------------------------------------------------------------

def check_reserve_before_commit(root: str | None = None,
                                scope=TRANSACTIONAL_SCOPE) -> list:
    root = root or repo_root()
    findings: list = []
    for rel in _files_in(root, scope):
        tree = _parse(root, rel)
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef) \
                    or fn.name != "decode_step":
                continue
            reserve_line = None
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, (ast.Attribute,
                                                   ast.Name)):
                    name = node.func.attr \
                        if isinstance(node.func, ast.Attribute) \
                        else node.func.id
                    if name == "_reserve_step":
                        reserve_line = min(reserve_line or node.lineno,
                                           node.lineno)
            if reserve_line is None:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, (ast.Attribute,
                                                   ast.Name)):
                    name = node.func.attr \
                        if isinstance(node.func, ast.Attribute) \
                        else node.func.id
                    if name in DECODE_COMMIT_CALLS \
                            and node.lineno < reserve_line:
                        findings.append(Finding(
                            "AST102", f"{rel}:{node.lineno}",
                            f"decode_step calls {name}() at line "
                            f"{node.lineno} before _reserve_step (line "
                            f"{reserve_line}) — an OutOfPages reservation "
                            f"failure would leave decode state mutated"))
    return findings


# ---------------------------------------------------------------------------
# AST103 — wall-clock ban in DES code
# ---------------------------------------------------------------------------

def check_wallclock(root: str | None = None, scope=DES_SCOPE) -> list:
    root = root or repo_root()
    findings: list = []
    for rel in _files_in(root, scope):
        tree = _parse(root, rel)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) \
                    and node.attr in WALLCLOCK_NAMES \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "time":
                findings.append(Finding(
                    "AST103", f"{rel}:{node.lineno}",
                    f"wall clock time.{node.attr} at line {node.lineno} — "
                    f"DES/cluster/engine code must use the virtual clock "
                    f"(serving.clock) so simulated timelines stay "
                    f"deterministic"))
            elif isinstance(node, ast.ImportFrom) and node.module == \
                    "time" and any(a.name in WALLCLOCK_NAMES
                                   for a in node.names):
                names = [a.name for a in node.names
                         if a.name in WALLCLOCK_NAMES]
                findings.append(Finding(
                    "AST103", f"{rel}:{node.lineno}",
                    f"imports {names} from time at line {node.lineno} — "
                    f"DES code must not read the wall clock"))
    return findings


# ---------------------------------------------------------------------------
# AST104 — tracer conditionals
# ---------------------------------------------------------------------------

def _mentions_tracer(node) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == "tracer":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "tracer":
            return True
    return False


def _tracer_call_line(body) -> int | None:
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value,
                                   (ast.Attribute, ast.Name)) \
                    and _mentions_tracer(node.func.value):
                return node.lineno
    return None


def check_tracer_guards(root: str | None = None, scope=DES_SCOPE) -> list:
    root = root or repo_root()
    findings: list = []
    for rel in _files_in(root, scope):
        tree = _parse(root, rel)
        for node in ast.walk(tree):
            if not isinstance(node, ast.If) \
                    or not _mentions_tracer(node.test):
                continue
            line = _tracer_call_line(node.body) \
                or _tracer_call_line(node.orelse)
            if line is not None:
                findings.append(Finding(
                    "AST104", f"{rel}:{node.lineno}",
                    f"tracer call at line {line} guarded by a conditional "
                    f"on the tracer (line {node.lineno}) — call the "
                    f"tracer unconditionally; NULL_TRACER makes the "
                    f"disabled path a no-op (serving.telemetry)"))
    return findings


# ---------------------------------------------------------------------------
# AST105 — host-commit purity (numpy only)
# ---------------------------------------------------------------------------

def check_host_commit_purity(root: str | None = None,
                             scope=HOST_COMMIT_SCOPE) -> list:
    root = root or repo_root()
    findings: list = []
    for rel in _files_in(root, scope):
        tree = _parse(root, rel)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) \
                    else [node.module or ""]
                bad = [m for m in mods
                       if m.split(".")[0] in DEVICE_MODULES]
                if bad:
                    findings.append(Finding(
                        "AST105", f"{rel}:{node.lineno}",
                        f"imports {bad} at line {node.lineno} — the "
                        f"batched host-commit path is numpy-only (a "
                        f"device op per tick is a hidden dispatch)"))
            elif isinstance(node, ast.Name) and node.id in \
                    DEVICE_MODULES | {"jnp"}:
                findings.append(Finding(
                    "AST105", f"{rel}:{node.lineno}",
                    f"uses {node.id} at line {node.lineno} — no device "
                    f"ops inside the batched host-commit path"))
    return findings


# ---------------------------------------------------------------------------

def run_all(root: str | None = None) -> list:
    """Every Pass-2 rule at its default scope."""
    root = root or repo_root()
    out = []
    out += check_raise_before_mutate(root)
    out += check_reserve_before_commit(root)
    out += check_wallclock(root)
    out += check_tracer_guards(root)
    out += check_host_commit_purity(root)
    return out

"""Progress-safety static analyzer for the port's engine (stdlib ``ast``):
the JAX package's ``analysis/progress_lint.py``, rule for rule, over
``src/repro_torch``.

``python -m repro_torch.analysis.progress_lint [--strict] [paths...]``
walks ``src/repro_torch`` and enforces the progress rules the papers
state but a test suite can only catch probabilistically:

* **PL001 — blocking call in a continuation.**  The Continuations paper
  (Schuchart et al.) forbids blocking MPI calls inside continuation
  callbacks: a callback runs on a progress/executor thread, so blocking
  there stalls the very machinery that would complete the thing being
  waited on.  Any callable handed to ``attach``/``attach_counter``/
  ``then``/``node``/``subscribe``/``register_subsystem``/``async_start``
  is treated as a continuation entry point; the rule flags
  ``wait*()``/``.result()``/``.join()``/``.acquire()``/``time.sleep``/
  ``block_until_ready``/``synchronize``/``run_until_idle`` reachable
  from it through intra-module calls (``self.helper()`` chains
  included).  ``synchronize`` is the port's ``block_until_ready``: CUDA's
  ``torch.cuda.synchronize()`` and an ``Event``'s or ``Stream``'s park the
  calling thread until the card has drained.

* **PL002 — persistent-handle lifecycle.**  Handles built by ``*_init``
  factories walk the MPI persistent-request machine declared once in
  ``repro_torch.core.debug`` (``LIFECYCLE_TRANSITIONS``); where call order is
  visible in a straight-line function body the rule flags double-start,
  start-after-invalidate-without-rebuild, wait-without-start and
  use-after-close.  The runtime half of the same machine lives in
  ``repro_torch.core.debug.HandleTracker`` (``REPRO_DEBUG=1``).

* **PL003 — lock-order cycles.**  Lexically nested ``with x._lock:``
  acquisitions across the whole tree form an order graph; a cycle means
  two call paths disagree about acquisition order — a deadlock waiting
  for its interleaving.  (Cross-function nesting is the runtime
  ``OrderedLock``'s job.)

* **PL004 — donated carry reused.**  A buffer passed in a donated
  position of a ``jax.jit(..., donate_argnums=...)``/``_jit_smap``
  program is dead after the call (XLA aliases it); referencing it again
  in the enclosing builder reads freed memory.  The port has no donating
  program; the rule keeps the JAX forms so that both lints give the same
  findings over the JAX tree.

Deliberate exceptions live in the port's ``progress_lint_allowlist.py``;
every
entry carries a justification string and matches by rule + path +
enclosing symbol, so findings survive line churn.  The module imports
nothing beyond the stdlib (the lifecycle table is loaded from the
port's ``core/debug.py`` by file path), so it needs neither JAX nor
PyTorch.  ``.item()`` and ``.tolist()`` count as blocking too: on a CUDA
tensor they wait for the card (on a CPU tensor they return at once, and
neither tree reads one in a continuation: they add no finding).
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import importlib.util
import os
import sys

RULES = {
    "PL001": "blocking call reachable from a continuation callback",
    "PL002": "persistent-handle lifecycle violation",
    "PL003": "inconsistent lock acquisition order (cycle)",
    "PL004": "donated carry referenced after a donating call",
}

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG_ROOT = os.path.dirname(_HERE)               # .../src/repro_torch
_SRC_ROOT = os.path.dirname(_PKG_ROOT)           # .../src


def _load_by_path(modname: str, path: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lifecycle_tables():
    """The declared handle state machine, shared with the runtime
    checker — loaded by file path so the linter never imports the
    package (and its JAX dependency)."""
    mod = _load_by_path("_repro_torch_lint_debug_tables",
                        os.path.join(_PKG_ROOT, "core", "debug.py"))
    return mod.LIFECYCLE_TRANSITIONS, mod.LIFECYCLE_VIOLATIONS


TRANSITIONS, VIOLATIONS = _lifecycle_tables()
IDLE, ACTIVE, STALE, CLOSED = "idle", "active", "stale", "closed"


@dataclasses.dataclass
class Finding:
    rule: str
    path: str          # repo-relative (posix separators)
    line: int
    qual: str          # enclosing Class.method / function
    message: str
    allowed: bool = False
    why: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}"


# ---------------------------------------------------------------------------
# Module model
# ---------------------------------------------------------------------------

class ModuleIndex:
    """Top-level functions, classes (with bases) and methods of one file."""

    def __init__(self, path: str, relpath: str, tree: ast.Module):
        self.path = path
        self.relpath = relpath
        self.tree = tree
        self.functions: dict[str, ast.FunctionDef] = {}
        self.classes: dict[str, dict[str, ast.FunctionDef]] = {}
        self.bases: dict[str, list[str]] = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                methods = {}
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        methods[sub.name] = sub
                self.classes[node.name] = methods
                self.bases[node.name] = [b.id for b in node.bases
                                         if isinstance(b, ast.Name)]

    def method(self, cls: str | None, name: str):
        """Resolve ``self.name`` in class ``cls`` (single-module MRO)."""
        seen = set()
        while cls is not None and cls not in seen:
            seen.add(cls)
            node = self.classes.get(cls, {}).get(name)
            if node is not None:
                return cls, node
            parents = self.bases.get(cls, [])
            cls = parents[0] if parents else None
        return None, None

    def iter_functions(self):
        """Yield (class_name_or_None, qualname, node) for every def."""
        for name, node in self.functions.items():
            yield None, name, node
        for cls, methods in self.classes.items():
            for name, node in methods.items():
                yield cls, f"{cls}.{name}", node


def parse_module(path: str, root: str | None = None) -> ModuleIndex | None:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    rel = os.path.relpath(path, root or _SRC_ROOT).replace(os.sep, "/")
    try:
        tree = ast.parse(text, filename=path)
    except SyntaxError:
        return None
    return ModuleIndex(path, rel, tree)


# ---------------------------------------------------------------------------
# PL001 — blocking call reachable from a continuation callback
# ---------------------------------------------------------------------------

# call-site name -> (positional indices, keyword names) holding callables
CONT_SITES = {
    "attach": ((1,), ("callback", "on_error")),
    "attach_counter": ((1,), ("callback", "on_error")),
    "then": ((1,), ("fn", "on_error")),
    "node": ((0,), ("fn",)),
    "subscribe": ((0,), ("fn",)),
    "register_subsystem": ((1,), ("poll",)),
    "async_start": ((0,), ("poll_fn",)),
}

BLOCKING_ATTRS = {"wait", "wait_all", "wait_any", "wait_some", "result",
                  "block_until_ready", "synchronize", "run_until_idle",
                  "item", "tolist"}


def _const(node):
    return node.value if isinstance(node, ast.Constant) else ...


def _blocking_reason(call: ast.Call) -> str | None:
    """Name of the blocking operation, or None if the call is benign."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        attr = fn.attr
        if attr in BLOCKING_ATTRS:
            for kw in call.keywords:
                if kw.arg == "timeout" and _const(kw.value) == 0:
                    return None          # an explicit non-blocking probe
            return attr
        if attr == "acquire":
            for kw in call.keywords:
                if kw.arg == "blocking" and _const(kw.value) is False:
                    return None
                if kw.arg == "timeout" and _const(kw.value) == 0:
                    return None
            if call.args and _const(call.args[0]) is False:
                return None
            return "acquire"
        if attr == "join" and not call.args and not call.keywords:
            return "join"                # str.join always takes an argument
        if attr == "sleep" and isinstance(fn.value, ast.Name) \
                and fn.value.id == "time":
            return "time.sleep"
    elif isinstance(fn, ast.Name) and fn.id == "sleep":
        return "sleep"
    return None


def _callable_exprs(call: ast.Call):
    """Callable-position expressions of a continuation enqueue call."""
    name = None
    if isinstance(call.func, ast.Attribute):
        name = call.func.attr
    elif isinstance(call.func, ast.Name):
        name = call.func.id
    if name not in CONT_SITES:
        return []
    positions, kwnames = CONT_SITES[name]
    out = []
    for i in positions:
        if len(call.args) > i:
            out.append(call.args[i])
    for kw in call.keywords:
        if kw.arg in kwnames:
            out.append(kw.value)
    return out


def _unwrap_partial(expr):
    """functools.partial(f, ...) / partial(f, ...) -> f."""
    while isinstance(expr, ast.Call):
        fn = expr.func
        is_partial = (isinstance(fn, ast.Name) and fn.id == "partial") or \
            (isinstance(fn, ast.Attribute) and fn.attr == "partial")
        if is_partial and expr.args:
            expr = expr.args[0]
        else:
            return expr
    return expr


def _nested_defs(func_node) -> dict[str, ast.FunctionDef]:
    out = {}
    for node in ast.walk(func_node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not func_node:
            out[node.name] = node
    return out


def _resolve_callable(expr, mi: ModuleIndex, cls: str | None, func_node):
    """Resolve a callable expression to [(cls, qual, node)]; lambdas
    come back as themselves."""
    expr = _unwrap_partial(expr)
    if isinstance(expr, ast.Lambda):
        return [(cls, "<lambda>", expr)]
    if isinstance(expr, ast.Name):
        nested = _nested_defs(func_node).get(expr.id)
        if nested is not None:
            return [(cls, expr.id, nested)]
        top = mi.functions.get(expr.id)
        if top is not None:
            return [(None, expr.id, top)]
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id in ("self", "cls"):
        owner, node = mi.method(cls, expr.attr)
        if node is not None:
            return [(owner, f"{owner}.{expr.attr}", node)]
    return []


def _call_edges(mi: ModuleIndex, cls: str | None, func_node):
    """Intra-module callees of one function body."""
    out = []
    for node in ast.walk(func_node):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Name):
            target = _nested_defs(func_node).get(fn.id) \
                or mi.functions.get(fn.id)
            if target is not None and target is not func_node:
                owner = cls if target.name in _nested_defs(func_node) else None
                out.append((owner, fn.id, target))
        elif isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
                and fn.value.id in ("self", "cls"):
            owner, target = mi.method(cls, fn.attr)
            if target is not None and target is not func_node:
                out.append((owner, f"{owner}.{fn.attr}", target))
    return out


def _pl001(mi: ModuleIndex, findings: list[Finding]) -> None:
    roots = []   # (cls, qual, node, attach_qual, attach_line)
    for cls, qual, func in mi.iter_functions():
        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                for expr in _callable_exprs(node):
                    for owner, cq, target in _resolve_callable(
                            expr, mi, cls, func):
                        roots.append((owner, cq, target, qual, node.lineno))
    seen: set[int] = set()
    for owner, root_qual, root_node, attach_qual, attach_line in roots:
        # BFS over intra-module calls from the callback body
        work = [(owner, root_qual, root_node, root_qual)]
        while work:
            cls, qual, node, chain = work.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    reason = _blocking_reason(sub)
                    if reason is not None:
                        findings.append(Finding(
                            "PL001", mi.relpath, sub.lineno, qual,
                            f"`{reason}` blocks inside continuation "
                            f"callback `{chain}` (attached at "
                            f"{attach_qual}:{attach_line})"))
            if not isinstance(node, ast.Lambda):
                for nxt_cls, nxt_qual, nxt in _call_edges(mi, cls, node):
                    work.append((nxt_cls, nxt_qual, nxt,
                                 f"{chain} -> {nxt_qual}"))


# ---------------------------------------------------------------------------
# PL002 — persistent-handle lifecycle (straight-line bodies)
# ---------------------------------------------------------------------------

INIT_ATTRS = {"allreduce_init", "reduce_scatter_init", "allgather_init",
              "alltoall_init", "alltoallv_init", "broadcast_init",
              "channel_init", "send_init", "recv_init"}
INIT_CLASSES = {"PersistentCollective", "P2PChannel"}

_RECOVER = {"start": ACTIVE, "close": CLOSED, "rebuild": IDLE}


def _is_init_call(call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in INIT_ATTRS:
        return True
    if isinstance(fn, ast.Name) and fn.id in INIT_CLASSES:
        return True
    if isinstance(fn, ast.Attribute) and fn.attr in INIT_CLASSES:
        return True
    return False


def _sub_blocks(stmt):
    for field in ("body", "orelse", "finalbody"):
        block = getattr(stmt, field, None)
        if block:
            yield block
    for handler in getattr(stmt, "handlers", []) or []:
        yield handler.body


def _names_in(node) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _pl002_block(stmts, qual: str, relpath: str,
                 findings: list[Finding]) -> None:
    state: dict[str, str] = {}
    started: dict[str, bool] = {}
    reqs: dict[str, str] = {}      # request var -> handle var

    def apply(var: str, ev: str, line: int) -> None:
        st = state[var]
        if ev == "cancel":         # documented no-op when idle/complete
            if st == CLOSED:
                findings.append(Finding(
                    "PL002", relpath, line, qual,
                    f"use-after-close: `{var}.cancel()` on a closed "
                    f"handle"))
            elif st == ACTIVE:
                state[var] = IDLE
            return
        nxt = TRANSITIONS.get((st, ev))
        if nxt is None:
            why = VIOLATIONS.get((st, ev),
                                 f"illegal `{ev}` in state `{st}`")
            findings.append(Finding(
                "PL002", relpath, line, qual,
                f"{why}: `{var}.{ev}()` while the handle is `{st}`"))
            state[var] = _RECOVER.get(ev, st)
        else:
            state[var] = nxt
        if ev == "start":
            started[var] = True

    def handle_call(call: ast.Call, assigned_to: str | None) -> bool:
        """Apply one call's lifecycle effect; True if it was consumed."""
        fn = call.func
        # epoch.invalidate(...) staleness applies to every tracked handle
        if isinstance(fn, ast.Attribute) and fn.attr == "invalidate":
            for var in list(state):
                apply(var, "invalidate", call.lineno)
            return True
        if not isinstance(fn, ast.Attribute):
            return False
        # h.active.wait() — waiting a start that was never issued
        if fn.attr == "wait" and isinstance(fn.value, ast.Attribute) \
                and fn.value.attr == "active" \
                and isinstance(fn.value.value, ast.Name) \
                and fn.value.value.id in state:
            var = fn.value.value.id
            if not started.get(var, False):
                findings.append(Finding(
                    "PL002", relpath, call.lineno, qual,
                    f"wait-without-start: `{var}.active.wait()` but "
                    f"`{var}` was never started in this scope"))
            else:
                apply(var, "wait", call.lineno)
            return True
        if not isinstance(fn.value, ast.Name):
            return False
        base = fn.value.id
        if base in state:
            if fn.attr in ("start", "close", "rebuild", "cancel"):
                apply(base, fn.attr, call.lineno)
                if fn.attr == "start" and assigned_to is not None:
                    reqs[assigned_to] = base
                return True
            if state[base] == CLOSED:
                findings.append(Finding(
                    "PL002", relpath, call.lineno, qual,
                    f"use-after-close: `{base}.{fn.attr}()` on a closed "
                    f"handle"))
                return True
        if base in reqs and fn.attr == "wait":
            handle = reqs[base]
            if state.get(handle) == ACTIVE:
                apply(handle, "wait", call.lineno)
            return True
        return False

    for st in stmts:
        compound = list(_sub_blocks(st))
        if compound:
            for block in compound:
                _pl002_block(block, qual, relpath, findings)
            # anything the compound touched is untrackable afterwards
            touched = _names_in(st)
            for var in list(state):
                if var in touched:
                    state.pop(var, None)
                    started.pop(var, None)
            for var in list(reqs):
                if var in touched:
                    reqs.pop(var, None)
            continue
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name) \
                and isinstance(st.value, ast.Call):
            target = st.targets[0].id
            if _is_init_call(st.value):
                state[target] = IDLE
                started[target] = False
                reqs.pop(target, None)
                continue
            consumed = handle_call(st.value, target)
            if not consumed:
                state.pop(target, None)
                started.pop(target, None)
                reqs.pop(target, None)
            continue
        for node in ast.walk(st):
            if isinstance(node, ast.Call):
                handle_call(node, None)


def _pl002(mi: ModuleIndex, findings: list[Finding]) -> None:
    for _cls, qual, func in mi.iter_functions():
        _pl002_block(func.body, qual, mi.relpath, findings)


# ---------------------------------------------------------------------------
# PL003 — lock-order cycles over lexically nested `with` acquisitions
# ---------------------------------------------------------------------------

def _lock_name(expr, cls: str | None) -> str | None:
    if isinstance(expr, ast.Attribute) and (
            expr.attr.endswith("lock") or expr.attr == "_mu"):
        if isinstance(expr.value, ast.Name) and expr.value.id in ("self",
                                                                  "cls"):
            return f"{cls}.{expr.attr}" if cls else f"*.{expr.attr}"
        return f"*.{expr.attr}"
    return None


class LockEdges:
    """Accumulated across every linted module, then cycle-checked."""

    def __init__(self):
        self.edges: dict[tuple[str, str], list[tuple[str, int, str]]] = {}

    def collect(self, mi: ModuleIndex) -> None:
        for cls, qual, func in mi.iter_functions():
            self._visit(func.body, [], cls, qual, mi.relpath)

    def _visit(self, stmts, held: list[str], cls, qual, relpath) -> None:
        for st in stmts:
            if isinstance(st, ast.With):
                names = []
                for item in st.items:
                    name = _lock_name(item.context_expr, cls)
                    if name is not None:
                        names.append((name, st.lineno))
                for outer in held:
                    for inner, line in names:
                        if outer != inner:
                            self.edges.setdefault((outer, inner), []).append(
                                (relpath, line, qual))
                inner_names = [n for n, _ in names]
                # multi-item `with a, b:` acquires left-to-right
                for i, (a, _) in enumerate(names):
                    for b, line in names[i + 1:]:
                        if a != b:
                            self.edges.setdefault((a, b), []).append(
                                (relpath, line, qual))
                self._visit(st.body, held + inner_names, cls, qual, relpath)
            else:
                for block in _sub_blocks(st):
                    self._visit(block, held, cls, qual, relpath)

    def cycles(self) -> list[tuple[list[str], list[tuple[str, int, str]]]]:
        graph: dict[str, set[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)

        def path(src, dst):
            stack, seen = [(src, [src])], {src}
            while stack:
                node, p = stack.pop()
                if node == dst:
                    return p
                for nxt in graph.get(node, ()):
                    if nxt not in seen:
                        seen.add(nxt)
                        stack.append((nxt, p + [nxt]))
            return None

        out, reported = [], set()
        for (a, b) in sorted(self.edges):
            back = path(b, a)
            if back is None:
                continue
            cycle = [a] + back
            key = frozenset(cycle)
            if key in reported:
                continue
            reported.add(key)
            witnesses = list(self.edges[(a, b)])
            for i in range(len(back) - 1):
                witnesses += self.edges.get((back[i], back[i + 1]), [])
            out.append((cycle, witnesses))
        return out


def _pl003(lock_edges: LockEdges, findings: list[Finding]) -> None:
    for cycle, witnesses in lock_edges.cycles():
        relpath, line, qual = witnesses[0]
        where = ", ".join(f"{p}:{l} ({q})" for p, l, q in witnesses[:4])
        findings.append(Finding(
            "PL003", relpath, line, qual,
            f"lock-order cycle {' -> '.join(cycle)} (witnesses: {where})"))


# ---------------------------------------------------------------------------
# PL004 — donated carry referenced after a donating call
# ---------------------------------------------------------------------------

def _donated_positions(call: ast.Call):
    """Donated positions of a jit/_jit_smap construction call, if any."""
    fn = call.func
    is_jit = (isinstance(fn, ast.Attribute) and fn.attr == "jit") or \
        (isinstance(fn, ast.Name) and fn.id == "jit")
    if is_jit:
        for kw in call.keywords:
            if kw.arg != "donate_argnums":
                continue
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return (v.value,)
            if isinstance(v, (ast.Tuple, ast.List)):
                pos = tuple(e.value for e in v.elts
                            if isinstance(e, ast.Constant))
                return pos or None
        return None
    if isinstance(fn, ast.Name) and fn.id == "_jit_smap" or \
            isinstance(fn, ast.Attribute) and fn.attr == "_jit_smap":
        for kw in call.keywords:
            if kw.arg == "donate" and _const(kw.value) is False:
                return None
        return (0,)
    return None


def _stores_in(node) -> set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}


def _pl004_block(stmts, donors: dict[str, tuple], donated: dict[str, int],
                 qual: str, relpath: str, findings: list[Finding]) -> None:
    for st in stmts:
        compound = list(_sub_blocks(st))
        if compound:
            for block in compound:
                _pl004_block(block, dict(donors), dict(donated), qual,
                             relpath, findings)
            for var in _stores_in(st):
                donated.pop(var, None)
                donors.pop(var, None)
            continue
        # 1. loads of already-donated buffers -> findings
        for node in ast.walk(st):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                    and node.id in donated:
                findings.append(Finding(
                    "PL004", relpath, node.lineno, qual,
                    f"`{node.id}` was donated at line {donated[node.id]} "
                    f"(XLA aliases the buffer) but is referenced again"))
                donated.pop(node.id)    # one finding per donation
        # 2. register new donors / donations from this statement
        for node in ast.walk(st):
            if not isinstance(node, ast.Call):
                continue
            pos = _donated_positions(node)
            if pos is not None and isinstance(st, ast.Assign) \
                    and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name) \
                    and st.value is node:
                donors[st.targets[0].id] = pos
                continue
            if isinstance(node.func, ast.Name) and node.func.id in donors:
                for p in donors[node.func.id]:
                    if len(node.args) > p and isinstance(node.args[p],
                                                         ast.Name):
                        donated[node.args[p].id] = node.lineno
        # 3. rebinds kill tracking
        for var in _stores_in(st):
            donated.pop(var, None)
            if not (isinstance(st, ast.Assign)
                    and isinstance(st.value, ast.Call)
                    and _donated_positions(st.value) is not None):
                donors.pop(var, None)


def _pl004(mi: ModuleIndex, findings: list[Finding]) -> None:
    for _cls, qual, func in mi.iter_functions():
        _pl004_block(func.body, {}, {}, qual, mi.relpath, findings)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def lint_modules(modules: list[ModuleIndex]) -> list[Finding]:
    findings: list[Finding] = []
    lock_edges = LockEdges()
    for mi in modules:
        _pl001(mi, findings)
        _pl002(mi, findings)
        _pl004(mi, findings)
        lock_edges.collect(mi)
    _pl003(lock_edges, findings)
    findings.sort(key=lambda f: (f.rule, f.path, f.line))
    return findings


def lint_source(text: str, path: str = "fixture.py") -> list[Finding]:
    """Lint one source string (the fixture-test entry point)."""
    tree = ast.parse(text, filename=path)
    return lint_modules([ModuleIndex(path, path, tree)])


def collect_paths(root: str) -> list[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py"):
                out.append(os.path.join(dirpath, name))
    return out


def load_allowlist() -> list[dict]:
    mod = _load_by_path("_repro_torch_lint_allowlist",
                        os.path.join(_HERE, "progress_lint_allowlist.py"))
    entries = list(mod.ALLOWLIST)
    for entry in entries:
        for key in ("rule", "path", "qual", "why"):
            if not entry.get(key):
                raise ValueError(
                    f"allowlist entry {entry!r} is missing {key!r} — every "
                    f"exception needs a rule, a location and a written "
                    f"justification")
    return entries


def apply_allowlist(findings: list[Finding], entries: list[dict]) -> None:
    for f in findings:
        for e in entries:
            if e["rule"] != f.rule:
                continue
            if not f.path.endswith(e["path"]):
                continue
            if e["qual"] != "*" and f.qual != e["qual"] \
                    and not f.qual.startswith(e["qual"] + "."):
                continue
            f.allowed = True
            f.why = e["why"]
            break


def format_findings(findings: list[Finding]) -> str:
    """Markdown table, same pipe-table conventions as analysis/report.py."""
    out = ["| rule | location | symbol | finding |",
           "|---|---|---|---|"]
    for f in findings:
        note = f" *(allowlisted: {f.why})*" if f.allowed else ""
        out.append(f"| {f.rule} | `{f.location()}` | `{f.qual}` "
                   f"| {f.message}{note} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on any non-allowlisted finding")
    ap.add_argument("--no-allowlist", action="store_true",
                    help="report raw findings, ignoring the allowlist")
    args = ap.parse_args(argv)

    roots = args.paths or [_PKG_ROOT]
    files: list[str] = []
    for root in roots:
        if os.path.isdir(root):
            files += collect_paths(root)
        else:
            files.append(root)
    modules = [m for m in (parse_module(p) for p in files) if m is not None]
    findings = lint_modules(modules)
    if not args.no_allowlist:
        apply_allowlist(findings, load_allowlist())

    flagged = [f for f in findings if not f.allowed]
    allowed = [f for f in findings if f.allowed]
    print(f"## progress_lint: {len(files)} file(s), "
          f"{len(flagged)} finding(s), {len(allowed)} allowlisted\n")
    if findings:
        print(format_findings(findings))
    else:
        print("clean — no findings.")
    if flagged and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

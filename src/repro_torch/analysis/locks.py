"""Static lock-discipline checker (LANNS010-013).

The port of ``repro.analysis.locks``.  The rules are language-agnostic and
run as they are; the blocking set adds the port's own blocking calls: a
``torch.cuda.synchronize()`` and an event's or stream's ``.synchronize()``
under a lock stall every thread that waits for that lock until the card
drains.

A class opts in by declaring a literal registry of guarded attributes:

    class AsyncAnnFrontend(AnnFrontend):
        _GUARDED_BY = {"pending": "_cond", "completed": "_cond"}
        _LOCK_ORDER = ("_cond", "_stats_lock")   # optional

The pass then proves every ``self.<attr>`` touch of a guarded attribute is
lexically inside ``with self.<lock>:`` (or inside a function annotated
``# lanns: holds[<lock>]``, whose callers take the lock — see
analysis/README.md).  ``__init__``/``__post_init__`` are exempt: nothing
else can hold a reference yet.

Inheritance: a subclass's effective registry is the union of its bases'
registries (within the module) with its own; methods inherited from a base
are checked against the subclass registry unless the subclass overrides
them (the override is what actually runs).

LANNS013 guards the publish protocol of request objects: inside a single
statement list, once ``x.event.set()`` has run, later assignments to
``x.<field>`` race with the woken waiter.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.rules import Finding, SourceFile, attr_chain

_BLOCKING_ATTRS = {"join", "sleep", "synchronize"}
_BLOCKING_CHAINS = {"self.index.query", "self._execute", "time.sleep"}
_CONSTRUCTORS = {"__init__", "__post_init__", "__init_subclass__"}


def _literal_str_dict(node: ast.AST) -> dict[str, str] | None:
    if not isinstance(node, ast.Dict):
        return None
    out: dict[str, str] = {}
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)
                and isinstance(v, ast.Constant) and isinstance(v.value, str)):
            return None
        out[k.value] = v.value
    return out


def _literal_str_seq(node: ast.AST) -> tuple[str, ...] | None:
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    vals: list[str] = []
    for el in node.elts:
        if not (isinstance(el, ast.Constant) and isinstance(el.value, str)):
            return None
        vals.append(el.value)
    return tuple(vals)


class _ClassInfo:
    def __init__(self, node: ast.ClassDef) -> None:
        self.node = node
        self.name = node.name
        self.bases = [attr_chain(b).split(".")[-1]
                      for b in node.bases if attr_chain(b)]
        self.guards: dict[str, str] = {}
        self.lock_order: tuple[str, ...] = ()
        self.published: tuple[str, ...] = ()
        self.methods: dict[str, ast.FunctionDef] = {}
        self.aliases: dict[str, str] = {}  # flush = step -> {"flush": "step"}
        for stmt in node.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], ast.Name):
                tgt = stmt.targets[0].id
                if tgt == "_GUARDED_BY":
                    self.guards = _literal_str_dict(stmt.value) or {}
                elif tgt == "_LOCK_ORDER":
                    self.lock_order = _literal_str_seq(stmt.value) or ()
                elif tgt == "_PUBLISHED_FIELDS":
                    self.published = _literal_str_seq(stmt.value) or ()
                elif isinstance(stmt.value, ast.Name):
                    self.aliases[tgt] = stmt.value.id
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[stmt.name] = stmt


def _collect_classes(src: SourceFile) -> dict[str, _ClassInfo]:
    return {
        node.name: _ClassInfo(node)
        for node in ast.walk(src.tree)
        if isinstance(node, ast.ClassDef)
    }


def _effective(cls: _ClassInfo, classes: dict[str, _ClassInfo],
               attr: str) -> dict:
    """Merge a dict/tuple attribute down the (single-module) base chain."""
    merged: dict = {}
    chain: list[_ClassInfo] = []
    cur: _ClassInfo | None = cls
    seen = set()
    while cur is not None and cur.name not in seen:
        seen.add(cur.name)
        chain.append(cur)
        nxt = None
        for b in cur.bases:
            if b in classes:
                nxt = classes[b]
                break
        cur = nxt
    for ci in reversed(chain):
        merged.update(getattr(ci, attr))
    return merged


def _resolved_methods(cls: _ClassInfo, classes: dict[str, _ClassInfo],
                      ) -> dict[str, tuple[_ClassInfo, ast.FunctionDef]]:
    """name -> (defining class, def) after override resolution."""
    out: dict[str, tuple[_ClassInfo, ast.FunctionDef]] = {}
    cur: _ClassInfo | None = cls
    seen = set()
    while cur is not None and cur.name not in seen:
        seen.add(cur.name)
        for name, fn in cur.methods.items():
            out.setdefault(name, (cur, fn))
        for alias, target in cur.aliases.items():
            # `flush = step`: the alias shadows any inherited def of that
            # name; the aliased method is checked under its own name.
            if target in cur.methods:
                out.setdefault(alias, (cur, cur.methods[target]))
        nxt = None
        for b in cur.bases:
            if b in classes:
                nxt = classes[b]
                break
        cur = nxt
    return out


class _LockWalk(ast.NodeVisitor):
    """One method body; tracks the stack of self.<lock> With contexts."""

    def __init__(self, src: SourceFile, cls: str, meth: str,
                 guards: dict[str, str], order: tuple[str, ...],
                 held_at_entry: str | None) -> None:
        self.src = src
        self.cls = cls
        self.meth = meth
        self.guards = guards
        self.order = order
        self.held: list[str] = [held_at_entry] if held_at_entry else []
        self.findings: list[Finding] = []

    def _lock_names(self, item: ast.withitem) -> str | None:
        chain = attr_chain(item.context_expr)
        if chain.startswith("self.") and chain.count(".") == 1:
            return chain[5:]
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired = [n for n in
                    (self._lock_names(it) for it in node.items) if n]
        for name in acquired:
            if self.order and self.held:
                try:
                    prev = max(self.order.index(h) for h in self.held
                               if h in self.order)
                    if name in self.order and self.order.index(name) < prev:
                        self.findings.append(Finding(
                            "LANNS012", self.src.path, node.lineno,
                            f"`{self.cls}.{self.meth}` acquires "
                            f"`self.{name}` while holding a later lock in "
                            f"_LOCK_ORDER {self.order}",
                        ))
                except ValueError:
                    pass
            self.held.append(name)
        self.generic_visit(node)
        for _ in acquired:
            self.held.pop()

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self" and \
                node.attr in self.guards:
            lock = self.guards[node.attr]
            if lock not in self.held:
                self.findings.append(Finding(
                    "LANNS010", self.src.path, node.lineno,
                    f"`self.{node.attr}` (guarded by `{lock}`) touched in "
                    f"`{self.cls}.{self.meth}` without holding it",
                ))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self.held:
            chain = attr_chain(node.func)
            attr = node.func.attr if isinstance(node.func, ast.Attribute) \
                else ""
            if chain in _BLOCKING_CHAINS or attr in _BLOCKING_ATTRS:
                self.findings.append(Finding(
                    "LANNS011", self.src.path, node.lineno,
                    f"blocking call `{chain or attr}` in "
                    f"`{self.cls}.{self.meth}` while holding "
                    f"`self.{self.held[-1]}`",
                ))
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass  # nested defs (worker closures) are separate execution contexts

    visit_AsyncFunctionDef = visit_FunctionDef


def _check_publish_order(src: SourceFile, published: tuple[str, ...],
                         findings: list[Finding]) -> None:
    """Module-wide LANNS013: fields in any class's _PUBLISHED_FIELDS must
    never be assigned after `<obj>.event.set()` in the same statement list
    (the publisher is usually a DIFFERENT class than the request)."""
    for fn in ast.walk(src.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        meth_name = fn.name
        for node in ast.walk(fn):
            body = getattr(node, "body", None)
            if not isinstance(body, list):
                continue
            set_done: set[str] = set()
            for stmt in body:
                if not isinstance(stmt, ast.stmt):
                    continue
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Assign):
                        for tgt in sub.targets:
                            if isinstance(tgt, ast.Attribute) and \
                                    tgt.attr in published:
                                base = attr_chain(tgt.value)
                                if base in set_done:
                                    findings.append(Finding(
                                        "LANNS013", src.path, sub.lineno,
                                        f"`{base}.{tgt.attr}` assigned "
                                        "after `event.set()` in "
                                        f"`{meth_name}` — waiters may "
                                        "read a half-published result",
                                    ))
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        chain = attr_chain(sub.func)
                        if chain.endswith(".event.set"):
                            set_done.add(chain[: -len(".event.set")])


def run(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    classes = _collect_classes(src)
    for cls in classes.values():
        guards = _effective(cls, classes, "guards")
        order: tuple[str, ...] = ()
        cur: _ClassInfo | None = cls
        seen: set[str] = set()
        while cur is not None and cur.name not in seen:
            seen.add(cur.name)
            if cur.lock_order:
                order = cur.lock_order
                break
            cur = next((classes[b] for b in cur.bases if b in classes), None)
        if guards:
            for name, (owner, fn) in sorted(
                    _resolved_methods(cls, classes).items()):
                if name in _CONSTRUCTORS:
                    continue
                if owner is not cls and owner.guards and owner is not None:
                    # base method already checked against its own class if
                    # the base declares guards; re-checking against every
                    # subclass only duplicates findings.
                    if set(guards) == set(_effective(
                            owner, classes, "guards")):
                        continue
                walk = _LockWalk(src, cls.name, name, guards, order,
                                 src.func_holds(fn))
                for stmt in fn.body:
                    walk.visit(stmt)
                findings.extend(walk.findings)
    published = tuple(sorted({
        f for c in classes.values() for f in c.published
    }))
    if published:
        _check_publish_order(src, published, findings)
    return findings

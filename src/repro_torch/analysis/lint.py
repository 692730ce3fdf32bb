"""The port's lint: a call-graph-aware AST lint over ``src/repro_torch``
(counterpart of ``repro.analysis.lint``).

Four rules, each a static form of an invariant the tests prove with whole
runs:

  R1 host-sync       nothing reachable from a protocol ``tick``
                     (``core/{mandator,sporades,paxos}.py``), the harness's
                     ``_tick`` / ``step``, or a function marked
                     ``# lint: traced-root`` may make the host wait for the
                     device: ``.item()``, ``.tolist()``, ``.cpu()``,
                     ``.numpy()``, ``float()`` / ``int()`` / ``bool()`` of a
                     tensor, a tensor as an ``if`` / ``while`` / ``assert``
                     test or conditional expression, ``print``, and
                     ``np.asarray`` / ``np.array`` of a tensor. A tick
                     captured as a CUDA graph (``core/compile_cache.py``)
                     cannot hold one. The tick index ``t`` is a 0-dim
                     device tensor: a parameter ``t`` is a tensor unless
                     annotated otherwise, so ``float(t)`` or ``int(t)``
                     in a tick is a finding. ``cfg`` fields are Python
                     scalars: no sync, not flagged.
  R2 dtype-hygiene   no float64 (``torch.float64`` / ``torch.double`` /
                     ``np.float64``, ``.double()``, ``dtype=float`` or
                     ``"float64"``, ``astype(float)``) unless justified:
                     the simulator is float32, and each float64 that stays
                     carries its reason in a pragma.
  R4 drop-mask       every ``channel.Send`` construction must reach a
                     ``ring_commit(..., drop=...)`` in the same function,
                     so the scenario's drop mask threads through every
                     send.
  R5 carry-hygiene   results of level-gated initializers (``init_trace`` /
                     ``init_monitor``) may only enter a state dict behind
                     a None / level guard, so the subtree is absent from
                     the carry at ``off``.

The reference's R3 (``SMRConfig`` fields steering control flow in traced
code must be jit-static) has no counterpart: the port compiles nothing
with jit. ``cfg`` steers the Python of a tick as it is captured, and the
captured program's key holds the whole config (``harness._program_key``),
so a config that branches otherwise is another program. The reference's
HLO layer (``hlo_lint``, H1-H4) has its counterpart in
``analysis/graph_lint.py`` (G1-G4), over the captured tick graph
(``python -m repro_torch.analysis --graph``).

Whether an expression is a tensor is judged positively and per function:
a parameter annotated ``torch.Tensor``, a ``torch.*`` call that returns
one, a method call on a tensor, an indexing of a tensor or of a state
dict by a string key, arithmetic or comparison over a tensor, and a name
assigned from any of these. Identity and membership tests (``is``,
``in``) are no sync.

A pragma suppresses a finding on its own line (``findings.PragmaTable``)
or, placed on a statement's first line, on any line of that statement, so
that one pragma covers an expression written over several lines.

The call graph is intra-repo and conservative: bare calls resolve within
the module, ``alias.fn`` through import aliases, and ``obj.method`` only
when exactly one class in the tree defines that method name.

Stdlib-only (``ast`` + ``pathlib``): the lint runs without torch.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import (Finding, PragmaTable, Report,
                                           RULE_KEYS)

ALL_RULES = ("R1", "R2", "R4", "R5")

# the roots of R1: protocol ticks and the harness's tick, by module tail
_TICK_ROOTS = {"core.mandator": ("tick",), "core.sporades": ("tick",),
               "core.paxos": ("tick",), "core.harness": ("_tick", "step")}
# method calls that copy a tensor to the host or wait on the device
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
# torch functions that return no tensor
_TORCH_HOST = {"device", "Size", "is_tensor", "is_floating_point",
               "get_default_dtype", "finfo", "iinfo", "Generator",
               "no_grad", "is_grad_enabled", "cuda", "backends"}
# tensor methods that return host values (shapes and metadata)
_TENSOR_HOST_METHODS = {"dim", "numel", "size", "element_size",
                        "data_ptr", "stride", "is_contiguous",
                        "get_device", "storage_offset", "item", "tolist",
                        "numpy", "nelement", "ndimension"}
# tensor attributes that are host values
_TENSOR_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
                      "layout", "requires_grad"}
# method names too generic to resolve through the unique-method heuristic
_METHOD_DENY = {
    "get", "items", "keys", "values", "append", "update", "copy", "pop",
    "astype", "at", "add", "set", "max", "min", "sum", "any", "all",
    "mean", "item", "ravel", "reshape", "clip", "sort", "split", "join",
    "format", "startswith", "endswith", "replace", "count", "points",
}
_LEVEL_INITS = {"init_trace", "init_monitor"}


def _qual_chain(node: ast.AST) -> Optional[str]:
    """Flatten a Name/Attribute chain to 'a.b.c' (None if not a chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class FuncInfo:
    qual: str                      # e.g. repro_torch.core.mandator.tick
    module: "ModuleInfo"
    node: ast.AST                  # FunctionDef
    calls: List[Tuple[str, int]] = field(default_factory=list)
    is_root: bool = False


class ModuleInfo:
    def __init__(self, name: str, path: Path, relpath: str):
        self.name = name
        self.path = path
        self.relpath = relpath
        source = path.read_text()
        self.tree = ast.parse(source, filename=str(path))
        self.pragmas = PragmaTable(source, relpath)
        self.aliases: Dict[str, str] = {}   # local -> module fullname
        self.symbols: Dict[str, str] = {}   # local -> module.attr fullname
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent

    def ancestors(self, node: ast.AST):
        n = self.parents.get(node)
        while n is not None:
            yield n
            n = self.parents.get(n)


class Index:
    """Two-pass repo index: parse + collect defs, then resolve imports
    and call edges against the collected definitions."""

    def __init__(self, root: Path, rel_to: Path):
        self.root = root
        self.modules: Dict[str, ModuleInfo] = {}
        self.funcs: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self.methods: Dict[str, List[str]] = {}  # method name -> quals
        for path in sorted(root.rglob("*.py")):
            name = self._module_name(path)
            try:
                rel = path.relative_to(rel_to).as_posix()
            except ValueError:
                rel = str(path)
            mod = ModuleInfo(name, path, rel)
            self.modules[name] = mod
            self._collect_defs(mod)
        for mod in self.modules.values():
            self._collect_imports(mod)
        for fn in self.funcs.values():
            self._collect_calls(fn)
        self._mark_roots()

    def _module_name(self, path: Path) -> str:
        rel = path.relative_to(self.root).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        # anchor at the import root: src/repro_torch/... lints as
        # repro_torch....
        prefix = [self.root.name] if self.root.name != "src" else []
        return ".".join(prefix + parts) if (prefix or parts) else "_"

    def _collect_defs(self, mod: ModuleInfo) -> None:
        def visit(node: ast.AST, scope: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qual = f"{scope}.{child.name}"
                    self.funcs[qual] = FuncInfo(qual, mod, child)
                    visit(child, qual)
                elif isinstance(child, ast.ClassDef):
                    qual = f"{scope}.{child.name}"
                    self.classes[qual] = child
                    for item in child.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            mq = f"{qual}.{item.name}"
                            self.funcs[mq] = FuncInfo(mq, mod, item)
                            self.methods.setdefault(item.name,
                                                    []).append(mq)
                            visit(item, mq)
                else:
                    visit(child, scope)
        visit(mod.tree, mod.name)

    def _collect_imports(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
                    if a.asname is None and "." in a.name:
                        # `import a.b.c` binds `a`; keep the full path
                        # resolvable through the dotted chain too
                        mod.aliases[a.name] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                base = node.module
                for a in node.names:
                    local = a.asname or a.name
                    full = f"{base}.{a.name}"
                    if full in self.modules or base in ("numpy", "torch"):
                        mod.aliases[local] = full
                    else:
                        mod.symbols[local] = full

    def resolve_module(self, mod: ModuleInfo, chain: str) -> Optional[str]:
        """Longest prefix of a dotted chain that names a module; returns
        the full chain rewritten onto the real module name."""
        parts = chain.split(".")
        for cut in range(len(parts), 0, -1):
            prefix = ".".join(parts[:cut])
            if prefix in mod.aliases:
                return ".".join([mod.aliases[prefix]] + parts[cut:])
        return None

    def resolve_call(self, fn: FuncInfo, call: ast.Call) -> Optional[str]:
        mod = fn.module
        chain = _qual_chain(call.func)
        if chain is None:
            return None
        if "." not in chain:
            # bare call: local symbol import, then same module / class
            if chain in mod.symbols:
                tgt = mod.symbols[chain]
                if tgt in self.funcs or tgt in self.classes:
                    return tgt
                return None
            qual = f"{mod.name}.{chain}"
            if qual in self.funcs or qual in self.classes:
                return qual
            # nested helper of an enclosing function scope
            scope = fn.qual
            while "." in scope:
                scope = scope.rsplit(".", 1)[0]
                qual = f"{scope}.{chain}"
                if qual in self.funcs:
                    return qual
            return None
        resolved = self.resolve_module(mod, chain)
        if resolved is not None:
            if resolved in self.funcs or resolved in self.classes:
                return resolved
            return None
        # obj.method: unique-method heuristic
        attr = chain.rsplit(".", 1)[1]
        cands = self.methods.get(attr, [])
        if attr not in _METHOD_DENY and len(cands) == 1:
            return cands[0]
        return None

    def _collect_calls(self, fn: FuncInfo) -> None:
        for node in self._own_body(fn.node):
            if isinstance(node, ast.Call):
                tgt = self.resolve_call(fn, node)
                if tgt is not None:
                    if tgt in self.classes:
                        tgt = f"{tgt}.__init__"
                        if tgt not in self.funcs:
                            continue
                    fn.calls.append((tgt, node.lineno))

    @staticmethod
    def _own_body(func_node: ast.AST):
        """Walk a function body without descending into nested defs
        (lambdas stay: they run inline with their enclosing body)."""
        stack = list(ast.iter_child_nodes(func_node))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _mark_roots(self) -> None:
        for fn in self.funcs.values():
            node = fn.node
            mod, _, name = fn.qual.rpartition(".")
            for tail, names in _TICK_ROOTS.items():
                if (mod == tail or mod.endswith("." + tail)) \
                        and name in names:
                    fn.is_root = True
            marker_lines = set(fn.module.pragmas.roots)
            if {node.lineno, node.lineno - 1} & marker_lines:
                fn.is_root = True

    def reachable(self) -> Set[str]:
        seen: Set[str] = set()
        stack = [q for q, f in self.funcs.items() if f.is_root]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            stack.extend(tgt for tgt, _ in self.funcs[q].calls
                         if tgt not in seen)
        return seen


def _emit(report: Report, mod: ModuleInfo, rule: str, node: ast.AST,
          message: str, severity: str = "error") -> None:
    key = RULE_KEYS[rule]
    line = getattr(node, "lineno", 0)
    pragma = mod.pragmas.lookup(line, key)
    if pragma is None:
        # a pragma on a statement's first line covers every line of it
        stmt = next((a for a in mod.ancestors(node)
                     if isinstance(a, ast.stmt)), None)
        if stmt is not None and stmt.lineno != line:
            pragma = mod.pragmas.lookup(stmt.lineno, key)
    report.findings.append(Finding(
        rule=rule, key=key, file=mod.relpath, line=line,
        col=getattr(node, "col_offset", 0), severity=severity,
        message=message,
        pragma="allowed" if pragma and pragma.justification else "none"))


# --------------------------------------------------------------- R1

class _Tensors:
    """Which expressions of one function are tensors (see the module
    docstring): parameters annotated ``torch.Tensor`` and names assigned
    from tensor expressions, to a fixpoint."""

    def __init__(self, index: Index, fn: FuncInfo):
        self.index, self.mod = index, fn.module
        self.names: Set[str] = set()
        args = fn.node.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            ann = _qual_chain(a.annotation) if a.annotation is not None \
                else None
            if ann and ann.split(".")[-1] == "Tensor":
                self.names.add(a.arg)
            elif a.arg == "t" and a.annotation is None:
                self.names.add(a.arg)       # the tick index
        assigns = [n for n in Index._own_body(fn.node)
                   if isinstance(n, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign))]
        changed = True
        while changed:
            changed = False
            for n in assigns:
                if n.value is None or not self.is_tensor(n.value):
                    continue
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name) and \
                                sub.id not in self.names:
                            self.names.add(sub.id)
                            changed = True

    def _torch_call(self, func: ast.AST) -> bool:
        chain = _qual_chain(func)
        base = self.index.resolve_module(self.mod, chain) if chain else None
        if not base or base.split(".")[0] != "torch":
            return False
        return not set(base.split(".")[1:]) & _TORCH_HOST

    def is_tensor(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Attribute):
            if e.attr in _TENSOR_HOST_ATTRS:
                return False
            return self.is_tensor(e.value) and e.attr in ("T", "mT",
                                                          "real", "imag")
        if isinstance(e, ast.Call):
            if self._torch_call(e.func):
                return True
            f = e.func
            if isinstance(f, ast.Attribute) and \
                    f.attr not in _TENSOR_HOST_METHODS:
                return self.is_tensor(f.value)
            return False
        if isinstance(e, ast.Subscript):
            if self.is_tensor(e.value):
                return True
            # a state dict's leaf: st["cvc"], carry["m"]["wl"]["buffer"]
            key = e.slice
            return isinstance(key, ast.Constant) and \
                isinstance(key.value, str) and \
                isinstance(e.value, (ast.Name, ast.Subscript))
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return False
            return any(self.is_tensor(x) for x in [e.left, *e.comparators])
        if isinstance(e, ast.BoolOp):
            return any(self.is_tensor(x) for x in e.values)
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        return False


def _check_r1(index: Index, report: Report) -> None:
    reached = index.reachable()
    for qual in sorted(reached):
        fn = index.funcs[qual]
        mod = fn.module
        tensors = _Tensors(index, fn)
        for node in Index._own_body(fn.node):
            test = None
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                test = node.test
            if test is not None and tensors.is_tensor(test):
                _emit(report, mod, "R1", test,
                      "a tensor as a branch test waits for the device "
                      f"(reachable from a tick via {qual})")
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
                    and not node.args and not node.keywords:
                _emit(report, mod, "R1", node,
                      f".{f.attr}() copies to the host and waits for the "
                      f"device (reachable from a tick via {qual})")
            elif isinstance(f, ast.Name) and f.id in ("float", "int",
                                                      "bool") \
                    and node.args and tensors.is_tensor(node.args[0]):
                _emit(report, mod, "R1", node,
                      f"`{f.id}()` of a tensor waits for the device "
                      f"(reachable from a tick via {qual})")
            elif isinstance(f, ast.Name) and f.id == "print":
                _emit(report, mod, "R1", node,
                      "print() in the tick formats on the host (and "
                      f"waits for any tensor it prints; via {qual})")
            else:
                chain = _qual_chain(f)
                base = index.resolve_module(mod, chain) if chain else None
                if base in ("numpy.asarray", "numpy.array") and \
                        node.args and tensors.is_tensor(node.args[0]):
                    _emit(report, mod, "R1", node,
                          f"`{chain}` of a tensor copies it to the host "
                          f"(reachable from a tick via {qual})")


# --------------------------------------------------------------- R2

def _check_r2(index: Index, report: Report) -> None:
    for mod in index.modules.values():
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr in ("float64", "double"):
                chain = _qual_chain(node)
                base = index.resolve_module(mod, chain) if chain else None
                if base and base.split(".")[0] in ("numpy", "torch"):
                    _emit(report, mod, "R2", node,
                          f"`{chain}`: a float64 dtype in the port (the "
                          "simulator is float32)")
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "double" \
                        and not node.args:
                    _emit(report, mod, "R2", node,
                          ".double() widens to float64 (the simulator is "
                          "float32)")
                for kw in node.keywords:
                    if kw.arg == "dtype" and (
                            isinstance(kw.value, ast.Name)
                            and kw.value.id in ("float", "int")):
                        _emit(report, mod, "R2", kw.value,
                              f"dtype={kw.value.id} is float64/int64 — "
                              "name an explicit 32-bit dtype")
                    elif kw.arg == "dtype" and (
                            isinstance(kw.value, ast.Constant)
                            and kw.value.value == "float64"):
                        _emit(report, mod, "R2", kw.value,
                              'dtype="float64" in the port (the simulator '
                              "is float32)")
                if isinstance(f, ast.Attribute) and f.attr == "astype" \
                        and node.args:
                    a = node.args[0]
                    if isinstance(a, ast.Name) and a.id in ("float",
                                                            "int"):
                        _emit(report, mod, "R2", node,
                              f"astype({a.id}) widens to float64/int64 — "
                              "name an explicit 32-bit dtype")


# --------------------------------------------------------------- R4

def _check_r4(index: Index, report: Report) -> None:
    for fn in index.funcs.values():
        mod = fn.module
        sends: List[ast.Call] = []
        commits: List[ast.Call] = []
        for node in Index._own_body(fn.node):
            if not isinstance(node, ast.Call):
                continue
            chain = _qual_chain(node.func)
            if chain is None:
                continue
            tail = chain.split(".")[-1]
            tgt = index.resolve_call(fn, node)
            if tgt:
                tgt = tgt.rsplit(".__init__", 1)[0]
            if tail == "Send" and tgt and tgt.split(".")[-1] == "Send":
                sends.append(node)
            elif tail == "ring_commit":
                # only commits whose callee takes a drop mask: the
                # kernel-level ops.ring_commit runs after the masks
                callee = index.funcs.get(tgt) if tgt else None
                if callee is None or any(
                        a.arg == "drop" for a in
                        callee.node.args.args + callee.node.args.kwonlyargs):
                    commits.append(node)
        for call in commits:
            if not any(kw.arg == "drop" for kw in call.keywords):
                _emit(report, mod, "R4", call,
                      "ring_commit without drop= — sends bypass the "
                      "scenario drop mask (silent-omission semantics)")
        if sends and not commits:
            _emit(report, mod, "R4", sends[0],
                  "channel.Send constructed here but never committed "
                  "via ring_commit(..., drop=...) in this function — "
                  "the drop mask cannot thread through")


# --------------------------------------------------------------- R5

def _guard_mentions(test: ast.AST, names: Set[str],
                    guard_vars: Set[str]) -> bool:
    for sub in ast.walk(test):
        if isinstance(sub, ast.Name) and (sub.id in names
                                          or sub.id in guard_vars):
            return True
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr == "on":
            return True
    return False


def _check_r5(index: Index, report: Report) -> None:
    for fn in index.funcs.values():
        mod = fn.module
        optional_vars: Set[str] = set()
        guard_vars: Set[str] = set()
        init_calls: List[ast.Call] = []
        for node in Index._own_body(fn.node):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                chain = _qual_chain(node.value.func) or ""
                tail = chain.split(".")[-1]
                tgt = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
                if tail in _LEVEL_INITS and tgt:
                    optional_vars.update(tgt)
                elif tail == "on" and tgt:
                    guard_vars.update(tgt)
            if isinstance(node, ast.Call):
                chain = _qual_chain(node.func) or ""
                if chain.split(".")[-1] in _LEVEL_INITS:
                    init_calls.append(node)
        if not optional_vars and not init_calls:
            continue

        def guarded(node: ast.AST, names: Set[str]) -> bool:
            for anc in mod.ancestors(node):
                if isinstance(anc, (ast.IfExp, ast.If)) and \
                        _guard_mentions(anc.test, names, guard_vars):
                    return True
                if isinstance(anc, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    break
            return False

        def stored(v: ast.AST) -> bool:
            return (isinstance(v, ast.Name) and v.id in optional_vars) or \
                (isinstance(v, ast.Call) and
                 (_qual_chain(v.func) or "").split(".")[-1] in _LEVEL_INITS)

        for node in Index._own_body(fn.node):
            # dict-literal values carrying the optional subtree
            if isinstance(node, ast.Dict):
                for v in node.values:
                    if stored(v) and not guarded(node, optional_vars):
                        _emit(report, mod, "R5", v,
                              "level-gated subtree stored in a carry "
                              "dict without a None/level guard — it "
                              "would ride the carry even at off")
            # subscript stores: st["tr"] = tr / = init_trace(...)
            elif isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Subscript) for t in node.targets):
                if stored(node.value) and not guarded(node, optional_vars):
                    _emit(report, mod, "R5", node,
                          "level-gated subtree assigned into state "
                          "without a None/level guard — it would ride "
                          "the carry even at off")


_CHECKS = {"R1": _check_r1, "R2": _check_r2, "R4": _check_r4,
           "R5": _check_r5}


def run_lint(root: Path, rules=None, rel_to: Optional[Path] = None) \
        -> Report:
    """Lint every ``*.py`` under ``root``; returns the Report (pragma
    findings included). ``rules`` restricts to a subset of ALL_RULES."""
    root = Path(root)
    if rel_to is None:
        rel_to = root.parents[1] if root.parent.name == "src" else root
    index = Index(root, rel_to)
    report = Report()
    for rule in (rules or ALL_RULES):
        _CHECKS[rule](index, report)
    for mod in index.modules.values():
        report.extend(mod.pragmas.pragma_findings())
    return report

"""Device-plane dataflow analysis over the lint forest (the torch port).

Tier-1 runs on the CPU, where the device plane's nastiest bug classes
are invisible: an in-place write into a tensor the HBM cache or the
chunk memo still hands out (silent corruption of every later reader),
a kernel object reused for a plan, device or plane it was not built
for, and host syncs hidden inside a program body (visible only as the
stalls the kernel profiler measures after the fact, on the card). This
pass proves their absence statically, before dispatch:

* **discovery** — every kernel construction site in the package:
  a factory handed to `FingerprintCache.get_or_create(key, make)` (the
  kernel classes it constructs own the program bodies: their `_kernel`
  / `_program` methods), `devplane.plane_jit(fn)` (the plane program
  seam), the executor/mesh dict caches (a function storing into a
  module dict under a key that folds `devplane.mesh_fingerprint`), and
  the hand-written kernel's build (`ops/segsum.build`: a function of
  ops/ running the compiler through `subprocess`);
* **in-place analysis** — tensors read from the HBM cache or the chunk
  memo (`dev_cache_get`, `device_put_chunk`, `get_or_fill`, a resident
  block's `.cols` / `.replicas`, and parameters every in-forest call
  site feeds from those) may be written in place only after a
  `clone()`: the `store/device_cache.scatter_block` patch shape;
* **cache-key analysis** — every `self` attribute / config read /
  module global reachable from a program body must be an operand or be
  folded into the owning cache key, `devplane.mesh_fingerprint` and
  `str(device)` included; the segsum build's reuse check must cover
  every input of its compile command;
* **retrace analysis** — dispatch operands must flow through the pow2
  superchunk bucketing (so kernel-cache rows and per-shape launch plans
  stay bounded), and host coercions of a *tensor* (`int`/`float`/
  `bool`/`.item()`/`.tolist()`/`.cpu()`/`.numpy()`) inside a program
  body are findings;
* **compile prediction** — a static per-family construction model
  (every site sits behind a cache or memo, so warm runs construct
  nothing) that `python -m tidb_tpu_torch.bench lintcheck` cross-checks
  against `information_schema.kernel_profile`'s counters (in the port
  a "compile" is a kernel object constructed, `profiler.note_construct`).

Zero extra parses: the pass walks the shared forest and reuses the
flow call graph (`flow_of(forest).graph`); `device_flow_of(forest)` is
memoized on the forest like `flow_of` itself. The rules consuming this
live in tidb_tpu_torch/lint/rules/device.py.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from tidb_tpu_torch.lint.flow import flow_of

__all__ = ["DeviceFlow", "device_flow_of", "TracedSite", "DispatchSite",
           "TensorScope", "SHAPERS", "COERCIONS", "HOST_METHODS"]

# helpers whose presence sanctions a dispatch's operand shaping: they
# are the pow2 superchunk bucketing seams (ops/runtime.py) and the
# per-kernel shard/pad entry points built on them
SHAPERS = frozenset({
    "bucket_size", "pad_column", "device_put_chunk", "put_lanes",
    "prepare_build", "_shard_probe", "_put_side", "superchunk_batches",
    "_bucket",
})

# callables whose results are host Python values: calling them on a
# tensor forces a device->host sync
COERCIONS = frozenset({"float", "int", "bool"})
# tensor methods whose result lives on the host (each one a device->host
# copy the caller waits for)
HOST_METHODS = frozenset({"item", "cpu", "tolist", "numpy"})

# the methods of a kernel class that hold its device program
PROGRAM_METHODS = ("_kernel", "_program")

# torch.<name> callables that return no tensor
_TORCH_NON_TENSOR = frozenset({
    "device", "dtype", "iinfo", "finfo", "Size", "Generator", "cuda",
    "get_default_dtype", "is_tensor", "is_floating_point", "numel",
    "manual_seed", "set_num_threads", "get_num_threads", "promote_types",
    "result_type", "can_cast", "no_grad", "inference_mode", "backends",
    "utils", "profiler", "library", "ops", "version", "set_printoptions",
    "use_deterministic_algorithms", "are_deterministic_algorithms_enabled",
})
# tensor methods whose result is no tensor
_NON_TENSOR_METHODS = HOST_METHODS | frozenset({
    "size", "dim", "numel", "nelement", "element_size", "data_ptr",
    "stride", "storage_offset", "is_contiguous", "is_pinned",
    "get_device", "untyped_storage", "equal", "is_floating_point",
    "type", "__len__",
})
# tensor attributes that are tensors themselves
_TENSOR_ATTRS = frozenset({"T", "mT", "H", "mH", "real", "imag", "data"})

_MESH_ROOT = "<mesh>"          # pseudo-root: value derives from the
#                                device plane (covered by the mesh
#                                fingerprint in the cache key)
_DEVICE_ROOT = "<device>"      # pseudo-root: the key holds str(device)

_SUBPROCESS = frozenset({"run", "check_call", "check_output", "Popen",
                         "call"})


def _root_names(expr) -> set:
    """Bare Name roots of an expression (the base of attribute /
    subscript chains; call args recursed)."""
    out: set = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Name):
            out.add(node.id)
    return out


def _is_const(name: str) -> bool:
    return name.isupper() or name.lstrip("_").isupper()


def _call_name(call: ast.Call) -> str | None:
    """Trailing name of the callee: `runtime.bucket_size` ->
    'bucket_size', `self._bucket` -> '_bucket'."""
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _dotted(expr) -> list | None:
    """`torch.nn.functional.pad` -> ['torch', 'nn', 'functional', 'pad'];
    None unless the chain is Names/Attributes only."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return parts[::-1]


def _is_plane_jit(expr) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id == "plane_jit"
    return isinstance(expr, ast.Attribute) and expr.attr == "plane_jit"


def _is_mesh_fp(call: ast.Call) -> bool:
    return _call_name(call) in ("mesh_fingerprint", "mesh_generation")


def _is_device_str(call: ast.Call) -> bool:
    """`str(device)` / `str(self.device)`: the device's identity in a
    key (a torch.device for 'cuda' and one for 'cuda:0' differ; the
    string names the card the kernel object is bound to)."""
    return isinstance(call.func, ast.Name) and call.func.id == "str" and \
        len(call.args) == 1 and any(
            "dev" in n.lower() for n in _root_names(call.args[0]) |
            {a.attr for a in ast.walk(call.args[0])
             if isinstance(a, ast.Attribute)})


def is_subprocess_call(call: ast.Call) -> bool:
    parts = _dotted(call.func)
    return bool(parts) and len(parts) == 2 and parts[0] == "subprocess" \
        and parts[1] in _SUBPROCESS


def is_host_method_call(call: ast.Call) -> str | None:
    """'.item()' / '.cpu()' / '.tolist()' / '.numpy()' / '.to("cpu")'
    when `call` has that shape (receiver unchecked), else None."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    if fn.attr in HOST_METHODS and not call.args:
        return f".{fn.attr}()"
    if fn.attr == "to":
        targets = list(call.args[:1]) + [kw.value for kw in call.keywords
                                         if kw.arg == "device"]
        for t in targets:
            if isinstance(t, ast.Constant) and t.value == "cpu":
                return '.to("cpu")'
    return None


class TensorScope:
    """Names of one function (and its lexical closure chain) that are
    provably bound to tensors: parameters annotated `torch.Tensor`, and
    locals bound from a `torch.*` call, a tensor method, a subscript or
    arithmetic over a tensor. Deliberately under-approximate: an
    unannotated parameter or a value of unknown origin is no tensor, so
    a numpy array's `.item()` or a Python int's `int()` never reports."""

    def __init__(self, fi, parent: "TensorScope | None" = None):
        self.names: set = set(parent.names) if parent else set()
        node = fi.node
        a = node.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            if arg.annotation is not None and self._tensor_annotation(
                    arg.annotation):
                self.names.add(arg.arg)
        binds = []
        for n in ast.walk(node):
            if isinstance(n, ast.Assign):
                binds.append((n.targets, n.value))
            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                binds.append(([n.target], n.value))
            elif isinstance(n, (ast.For, ast.comprehension)):
                binds.append(([n.target], ("iter", n.iter)))
        for _ in range(3):          # fixpoint over out-of-order binds
            before = len(self.names)
            for targets, value in binds:
                for t in targets:
                    self._bind(t, value)
            if len(self.names) == before:
                break

    @staticmethod
    def _tensor_annotation(ann) -> bool:
        parts = _dotted(ann)
        return bool(parts) and parts[-1] == "Tensor"

    def _bind(self, target, value) -> None:
        if isinstance(value, tuple):            # ("iter", expr)
            if isinstance(target, ast.Name) and self.is_tensor(value[1]):
                self.names.add(target.id)       # rows of a tensor
            return
        if isinstance(target, ast.Name):
            if self.is_tensor(value):
                self.names.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and \
                    len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self._bind(t, v)
            elif self._torch_call(value) or (
                    isinstance(value, ast.Call) and
                    isinstance(value.func, ast.Attribute) and
                    self.is_tensor(value.func.value)):
                # torch.sort / torch.unique / t.max(dim) -> tensors
                for t in target.elts:
                    if isinstance(t, ast.Name):
                        self.names.add(t.id)

    @staticmethod
    def _torch_call(expr) -> bool:
        if not isinstance(expr, ast.Call):
            return False
        parts = _dotted(expr.func)
        return bool(parts) and parts[0] == "torch" and len(parts) > 1 \
            and parts[1] not in _TORCH_NON_TENSOR

    def is_tensor(self, e) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Call):
            if self._torch_call(e):
                return True
            fn = e.func
            return isinstance(fn, ast.Attribute) and \
                fn.attr not in _NON_TENSOR_METHODS and \
                self.is_tensor(fn.value)
        if isinstance(e, ast.Attribute):
            return e.attr in _TENSOR_ATTRS and self.is_tensor(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return False
            return self.is_tensor(e.left) or \
                any(self.is_tensor(c) for c in e.comparators)
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        return False


@dataclass
class TracedSite:
    """One kernel construction site."""
    rel: str
    line: int
    form: str                     # "factory" | "plane_jit" | "dict"
    #                               | "build"
    call: ast.AST | None          # the construction call / store
    fns: list = field(default_factory=list)   # resolved program bodies
    #                               (FuncInfo), possibly several
    fn_name: str = ""             # display name of the program
    owner: object = None          # FuncInfo of the enclosing function
    cls: str | None = None        # class owning the stored program
    store: tuple = ("anon", None)  # ("attr"|"global"|"dict"|"local"
    #                                |"cache"|"return"|"file", name)
    key: ast.AST | None = None    # the cache-key expression (factory,
    #                               dict forms)
    kernel_classes: list = field(default_factory=list)   # (rel, cls)


@dataclass
class DispatchSite:
    """One call of a program body."""
    rel: str
    line: int
    call: ast.Call
    site: TracedSite              # the program being dispatched
    func: object = None           # enclosing FuncInfo
    via_factory: ast.Call | None = None   # inner factory/getter call
    #                               whose args key a program memo


class DeviceFlow:
    """The device-plane facts for one forest (see module docstring)."""

    def __init__(self, forest):
        self.forest = forest
        self.graph = flow_of(forest).graph
        self.sites: list[TracedSite] = []
        # program stores, for dispatch resolution
        self._attr_sites: dict[tuple, TracedSite] = {}   # (rel, attr)
        self._name_sites: dict[tuple, TracedSite] = {}   # (rel, name)
        self._factory_sites: dict[tuple, TracedSite] = {}  # FuncInfo.key
        self._node_func: dict[int, object] = {}          # id(def node)
        for fi in self.graph.funcs.values():
            self._node_func[id(fi.node)] = fi
        self._parents: dict[str, dict[int, ast.AST]] = {}
        self._scopes: dict[tuple, TensorScope] = {}
        self._bindings: dict[tuple, dict] = {}
        self._discover()
        self.dispatches: list[DispatchSite] = self._find_dispatches()
        self._reachable_memo: dict[tuple, set] = {}

    # -- plumbing ------------------------------------------------------------

    def _parent_map(self, rel: str) -> dict[int, ast.AST]:
        pm = self._parents.get(rel)
        if pm is None:
            pf = self.forest.get(rel)
            pm = {}
            for node in pf.nodes:
                for child in ast.iter_child_nodes(node):
                    pm[id(child)] = node
            self._parents[rel] = pm
        return pm

    def enclosing_function(self, rel: str, node) -> object:
        """Innermost FuncInfo containing `node` (by parent walk)."""
        pm = self._parent_map(rel)
        cur = node
        while cur is not None:
            fi = self._node_func.get(id(cur))
            if fi is not None:
                return fi
            cur = pm.get(id(cur))
        return None

    def enclosing_class(self, rel: str, node) -> str | None:
        pm = self._parent_map(rel)
        cur = node
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur.name
            cur = pm.get(id(cur))
        return None

    def tensors(self, fi) -> TensorScope:
        """The tensor-typed names of `fi` (memoized)."""
        scope = self._scopes.get(fi.key)
        if scope is None:
            parent = self.tensors(fi.parent) if fi.parent else None
            scope = self._scopes[fi.key] = TensorScope(fi, parent)
        return scope

    def _resolve_callable(self, expr, rel: str, enclosing) -> list:
        """Resolve a callable expression to FuncInfo(s). `self.X` that
        misses in the enclosing class fans out to every same-module
        method named X (base-class plumbing like
        MeshKernelBase._setup_mesh wraps the subclass's `_program`)."""

        class _Fake:
            func = expr
        hit = self.graph.resolve_call(_Fake, rel, enclosing)
        if hit is not None:
            return [hit]
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            return [fi for (r, c, n), fi in self.graph._method.items()
                    if r == rel and n == expr.attr]
        return []

    def _unwrap_traced(self, expr, rel: str, owner) -> tuple:
        """-> (fns, display_name) for the first argument of a plane_jit
        wrap, unwrapping `shard_map(fn, ...)` wrappers, local names
        bound to them, and closure factories that `return` a nested def
        (the `_stage2_fn(bucket)` shape)."""
        if isinstance(expr, ast.Call):
            name = _call_name(expr)
            if name == "shard_map" and expr.args:
                return self._unwrap_traced(expr.args[0], rel, owner)
            hits = self._resolve_callable(expr.func, rel, owner)
            out = []
            for fi in hits:
                ret = [n for n in ast.walk(fi.node)
                       if isinstance(n, ast.Return)]
                for r in ret:
                    if isinstance(r.value, ast.Name) and \
                            r.value.id in fi.nested:
                        out.append(fi.nested[r.value.id])
            if out:
                return out, out[0].node.name
            return [], ast.unparse(expr)[:40]
        if isinstance(expr, ast.Name) and owner is not None:
            for node in ast.walk(owner.node):
                if isinstance(node, ast.Assign) and \
                        any(isinstance(t, ast.Name) and t.id == expr.id
                            for t in node.targets):
                    if isinstance(node.value, ast.Call):
                        return self._unwrap_traced(node.value, rel,
                                                   owner)
        fns = self._resolve_callable(expr, rel, owner)
        name = expr.attr if isinstance(expr, ast.Attribute) else \
            (expr.id if isinstance(expr, ast.Name) else
             ast.unparse(expr)[:40])
        return fns, name

    def ctor_class(self, fi, call: ast.Call) -> tuple | None:
        """(rel, cls) when `call` constructs an in-forest class."""
        hit = self.graph.resolve_call(call, fi.rel, fi)
        if hit is not None and hit.cls is not None and \
                hit.node.name == "__init__":
            return (hit.rel, hit.cls)
        if isinstance(call.func, ast.Name):
            rel = self.graph._classes.get((fi.rel, call.func.id))
            if rel is not None:
                return (rel, call.func.id)
        return None

    def program_methods(self, rel: str, cls: str) -> list:
        """A kernel class's program bodies (`_kernel` / `_program`)."""
        return [self.graph._method[(rel, cls, m)] for m in PROGRAM_METHODS
                if (rel, cls, m) in self.graph._method]

    # -- discovery -----------------------------------------------------------

    def _discover(self) -> None:
        for pf in self.forest:
            for node in pf.nodes:
                if not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "get_or_create" and \
                        len(node.args) >= 2:
                    self._add_factory_site(pf, node)
                elif _is_plane_jit(node.func) and node.args:
                    self._add_site(pf, node, "plane_jit")
        for fi in list(self.graph.funcs.values()):
            if fi.parent is not None or fi.cls is not None:
                continue
            self._add_dict_site(fi)
            self._add_build_site(fi)

    def _add_factory_site(self, pf, call: ast.Call) -> None:
        owner = self.enclosing_function(pf.rel, call)
        if owner is None:
            return
        fac = call.args[1]
        bodies = []
        if isinstance(fac, ast.Lambda):
            bodies = [fac.body]
        else:
            bodies = [f.node for f in
                      self._resolve_callable(fac, pf.rel, owner)]
        classes: list = []
        for body in bodies:
            for n in ast.walk(body):
                if isinstance(n, ast.Call):
                    k = self.ctor_class(owner, n)
                    if k is not None and k not in classes:
                        classes.append(k)
        if not classes:
            return          # a registry's get_or_create, not a kernel
        recv = call.func.value
        store = recv.attr if isinstance(recv, ast.Attribute) else \
            (recv.id if isinstance(recv, ast.Name) else None)
        fns = [m for rel, cls in classes
               for m in self.program_methods(rel, cls)]
        site = TracedSite(pf.rel, call.lineno, "factory", call, fns=fns,
                          fn_name="/".join(c for _r, c in classes),
                          owner=owner, cls=None, store=("cache", store),
                          key=call.args[0], kernel_classes=classes)
        self.sites.append(site)
        for fn in fns:
            self._attr_sites[(fn.rel, fn.node.name)] = site

    def _add_site(self, pf, call: ast.Call, form: str) -> None:
        owner = self.enclosing_function(pf.rel, call)
        cls = self.enclosing_class(pf.rel, call)
        site = TracedSite(pf.rel, call.lineno, form, call, owner=owner,
                          cls=cls)
        site.fns, site.fn_name = self._unwrap_traced(
            call.args[0], pf.rel, owner)
        site.store = self._store_of(pf.rel, call, owner)
        self.sites.append(site)
        kind, name = site.store
        if kind == "attr":
            self._attr_sites[(pf.rel, name)] = site
        elif kind in ("global", "local"):
            self._name_sites[(pf.rel, name)] = site
        if owner is not None and kind in ("dict", "return", "local"):
            # the enclosing function acts as a program factory/getter
            self._factory_sites[owner.key] = site

    def _add_dict_site(self, fi) -> None:
        """A module-level function that fingerprints the plane and
        stores into a module dict: the executor/mesh kernel cache."""
        if not any(isinstance(n, ast.Call) and _is_mesh_fp(n)
                   for n in ast.walk(fi.node)):
            return
        pf = self.forest.get(fi.rel)
        globals_ = {t.id for stmt in pf.tree.body
                    if isinstance(stmt, (ast.Assign, ast.AnnAssign))
                    for t in (stmt.targets if isinstance(stmt, ast.Assign)
                              else [stmt.target])
                    if isinstance(t, ast.Name)}
        for n in ast.walk(fi.node):
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id in globals_:
                        self.sites.append(TracedSite(
                            fi.rel, n.lineno, "dict", t, owner=fi,
                            fn_name=fi.node.name,
                            store=("dict", t.value.id), key=t.slice))
                        return

    def _add_build_site(self, fi) -> None:
        """A module-level function of ops/ that runs a compiler through
        subprocess: the hand-written kernel's build."""
        if "/ops/" not in fi.rel:
            return
        for n in ast.walk(fi.node):
            if isinstance(n, ast.Call) and is_subprocess_call(n):
                self.sites.append(TracedSite(
                    fi.rel, n.lineno, "build", n, owner=fi,
                    fn_name=fi.node.name, store=("file", None)))
                return

    def _store_of(self, rel: str, call: ast.Call, owner) -> tuple:
        """Where the constructed program lands: walk up to the
        statement and classify its target."""
        pm = self._parent_map(rel)
        cur: ast.AST = call
        stmt = None
        while cur is not None:
            if isinstance(cur, (ast.Assign, ast.AnnAssign, ast.Return)):
                stmt = cur
                break
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef, ast.Module)):
                break
            cur = pm.get(id(cur))
        if isinstance(stmt, ast.Return):
            return ("return", None)
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.target is not None:
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Subscript):
                base = t.value
                name = base.attr if isinstance(base, ast.Attribute) \
                    else (base.id if isinstance(base, ast.Name)
                          else None)
                return ("dict", name)
        for t in targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and \
                    t.value.id == "self":
                return ("attr", t.attr)
        for t in targets:
            if isinstance(t, ast.Name):
                kind = "global" if owner is None else "local"
                return (kind, t.id)
        return ("anon", None)

    # -- dispatch resolution -------------------------------------------------

    def _find_dispatches(self) -> list[DispatchSite]:
        out: list[DispatchSite] = []
        for pf in self.forest:
            for node in pf.nodes:
                if not isinstance(node, ast.Call):
                    continue
                d = self._classify_dispatch(pf.rel, node)
                if d is not None:
                    out.append(d)
        return out

    def _classify_dispatch(self, rel: str,
                           call: ast.Call) -> DispatchSite | None:
        fn = call.func
        # self._jit(...) / self._kernel(...) — attribute stores and
        # program methods, matched by name within the module (base-class
        # dispatch methods run with subclass instances)
        if isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and fn.value.id == "self":
            site = self._attr_sites.get((rel, fn.attr))
            if site is not None:
                fi = self.enclosing_function(rel, call)
                if fi is not None and \
                        fi.key in {f.key for f in site.fns}:
                    return None     # a program calling itself
                return DispatchSite(rel, call.lineno, call, site, fi)
            return None
        if isinstance(fn, ast.Name):
            site = self._name_sites.get((rel, fn.id))
            if site is not None and site.call is not call:
                fi = self.enclosing_function(rel, call)
                via = None
                if fi is not None:
                    via = self._binding_factory_call(fi, fn.id)
                return DispatchSite(rel, call.lineno, call, site, fi,
                                    via_factory=via)
            if not self._factory_sites:
                return None
            fi = self.enclosing_function(rel, call)
            if fi is not None:
                bound = self._binding_factory_call(fi, fn.id)
                if bound is not None:
                    hits = self._resolve_callable(bound.func, rel, fi)
                    for h in hits:
                        site = self._factory_sites.get(h.key)
                        if site is not None:
                            return DispatchSite(rel, call.lineno, call,
                                                site, fi,
                                                via_factory=bound)
            return None
        if isinstance(fn, ast.Call):
            fi = self.enclosing_function(rel, call)
            hits = self._resolve_callable(fn.func, rel, fi)
            for h in hits:
                site = self._factory_sites.get(h.key)
                if site is not None:
                    return DispatchSite(rel, call.lineno, call, site,
                                        fi, via_factory=fn)
        return None

    def _binding_factory_call(self, fi, name: str) -> ast.Call | None:
        """The call expression a local `name` is bound from in `fi`
        (the first such binding; one walk of `fi`, memoized)."""
        calls = self._bindings.get(fi.key)
        if calls is None:
            calls = self._bindings[fi.key] = {}
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            calls.setdefault(t.id, node.value)
        return calls.get(name)

    # -- reachability --------------------------------------------------------

    def reachable(self, fi) -> list:
        """FuncInfos reachable from `fi` through the call graph
        (bounded BFS; a program's closure is small)."""
        memo = self._reachable_memo.get(fi.key)
        if memo is not None:
            return memo
        seen = {fi.key}
        out = [fi]
        queue = [fi]
        while queue and len(out) < 120:
            cur = queue.pop()
            for node in ast.walk(cur.node):
                if not isinstance(node, ast.Call):
                    continue
                hit = self.graph.resolve_call(node, cur.rel, cur)
                if hit is not None and hit.key not in seen:
                    seen.add(hit.key)
                    out.append(hit)
                    queue.append(hit)
        self._reachable_memo[fi.key] = out
        return out

    def traced_bodies(self, site: TracedSite) -> list:
        seen: set = set()
        out: list = []
        for fn in site.fns:
            for body in self.reachable(fn):
                if body.key not in seen:
                    seen.add(body.key)
                    out.append(body)
        return out

    # -- compile prediction --------------------------------------------------

    def compile_predictions(self) -> dict:
        """Static per-family construction model for the lintcheck leg:
        every construction site sits behind a fingerprint cache or a
        bounded kernel memo, so (a) warm re-runs construct nothing and
        (b) fingerprint-cached families construct at most once per
        profile row. The profiler plane falsifies this if a seam
        regresses (and the lint rules falsify the profiler if a cache
        stops keying what the kernel reads)."""
        families: list[str] = []
        for pf in self.forest:
            if not pf.rel.endswith("profiler.py"):
                continue
            for node in pf.tree.body:
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == "FAMILIES"
                        for t in node.targets) and \
                        isinstance(node.value, ast.Tuple):
                    families = [e.value for e in node.value.elts
                                if isinstance(e, ast.Constant)]
        # modules mentioning the family string own its construction
        # sites ("hashagg"/"scalaragg" are picked via a variable, so
        # the literal — not the profile() call arg — is the anchor)
        fam_rels: dict[str, set] = {f: set() for f in families}
        for pf in self.forest:
            for node in pf.nodes:
                if isinstance(node, ast.Constant) and \
                        node.value in fam_rels:
                    fam_rels[node.value].add(pf.rel)
        kernels = [s for s in self.sites if s.form != "build"]
        preds: dict[str, dict] = {}
        for fam in families:
            if fam == "plane":
                # plane rows key on the wrapped fn name, and every kernel
                # instance wraps its programs once, so only warm
                # stability is predicted
                preds[fam] = {"sites": sum(
                    1 for s in kernels if s.form == "plane_jit"),
                    "per_row_bound": None, "warm_growth": 0}
            else:
                n_sites = sum(1 for s in kernels
                              if s.rel in fam_rels[fam])
                preds[fam] = {"sites": n_sites, "per_row_bound": 1,
                              "warm_growth": 0}
        return preds


def device_flow_of(forest) -> DeviceFlow:
    """The forest's device-plane analysis, computed once and memoized
    on the forest instance (the device rules and the bench cross-check
    share the same facts)."""
    df = getattr(forest, "_device_flow", None)
    if df is None:
        df = DeviceFlow(forest)
        forest._device_flow = df
    return df

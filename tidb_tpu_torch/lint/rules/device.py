"""Device-plane discipline rules: inplace-safety, cache-key
completeness, and retrace-hazard — the three checks of the
tidb_tpu_torch/lint/flow/device.py dataflow pass (see that module's
docstring for the hazard classes). `inplace-safety` is the torch
counterpart of the JAX package's `donation-safety`: torch has no
buffer donation; the hazard that took its place is an in-place write
into a tensor a cache still hands out."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule
from tidb_tpu_torch.lint.flow.device import (COERCIONS, SHAPERS,
                                             _DEVICE_ROOT, _MESH_ROOT,
                                             _call_name, _is_const,
                                             _is_device_str, _is_mesh_fp,
                                             _root_names, device_flow_of,
                                             is_host_method_call)

_BUILTINS = frozenset({
    "self", "len", "max", "min", "sorted", "sum", "range", "zip",
    "enumerate", "list", "tuple", "dict", "set", "frozenset", "id",
    "getattr", "setattr", "hasattr", "isinstance", "print", "abs",
    "any", "all", "repr", "str", "type", "iter", "next", "map",
    "filter", "reversed", "slice", "None", "True", "False",
    "int", "float", "bool", "bytes", "object", "Exception",
    "ValueError", "RuntimeError", "KeyError",
})


def _mod_info(df, rel: str) -> tuple:
    """(scope_names, mutable_globals) for a module. scope_names are
    code references — imports (external ones included; the callgraph
    only indexes in-forest targets), function/class defs, builtins.
    mutable_globals are lowercase module-level assignment targets:
    reads of THOSE from a program body are state a cache key must see."""
    cache = getattr(df, "_mod_info_cache", None)
    if cache is None:
        cache = df._mod_info_cache = {}
    hit = cache.get(rel)
    if hit is not None:
        return hit
    g = df.graph
    scope = set(g._imports.get(rel, {}))
    scope |= {n for (r, n) in g._top if r == rel}
    scope |= {c for (r, c) in g._classes if r == rel}
    scope |= _BUILTINS
    mutable: set = set()
    pf = next((p for p in df.forest if p.rel == rel), None)
    if pf is not None:
        for node in pf.nodes:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    scope.add(alias.asname or
                              alias.name.split(".")[0])
        for stmt in pf.tree.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                targets = [stmt.target]
            for t in targets:
                if isinstance(t, ast.Name) and not _is_const(t.id):
                    mutable.add(t.id)
        mutable -= scope
    out = (scope, mutable)
    cache[rel] = out
    return out


def _bound_names(fi) -> set:
    """Names bound in `fi` or its lexical closure chain: params,
    assignment targets, loop/with/comprehension targets."""
    out: set = set()
    cur = fi
    while cur is not None:
        a = cur.node.args
        for arg in (a.posonlyargs + a.args + a.kwonlyargs):
            out.add(arg.arg)
        if a.vararg:
            out.add(a.vararg.arg)
        if a.kwarg:
            out.add(a.kwarg.arg)
        for node in ast.walk(cur.node):
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, (ast.Store, ast.Del)):
                out.add(node.id)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.ClassDef)):
                out.add(node.name)
        cur = cur.parent
    return out


# ---------------------------------------------------------------------------
# cache-key
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# inplace-safety
# ---------------------------------------------------------------------------

# calls whose result is (or aliases) a tensor a cache keeps handing out:
# the chunk memo (dev_cache_get, and device_put_chunk's memoized lanes)
# and the HBM block cache (get_or_fill, upload_block's resident lanes)
_CACHE_READS = frozenset({"dev_cache_get", "device_put_chunk",
                          "get_or_fill", "upload_block"})
# a resident DeviceBlock's lanes
_RESIDENT_ATTRS = frozenset({"cols", "replicas"})
# tensor methods whose result shares the receiver's storage (or IS the
# receiver: .to() / .contiguous() on a tensor that needs no change), and
# the dict views a resident block's replicas are read through
_VIEW_METHODS = frozenset({
    "view", "view_as", "reshape", "reshape_as", "narrow", "select",
    "expand", "expand_as", "as_strided", "flatten", "unflatten",
    "squeeze", "unsqueeze", "t", "permute", "transpose", "swapaxes",
    "movedim", "contiguous", "detach", "to", "unbind", "split", "chunk",
    "tensor_split", "diagonal", "unfold", "values", "items", "get",
})
# iteration wrappers whose items alias the wrapped container's items
_PASS_THROUGH = frozenset({"enumerate", "zip", "reversed", "list",
                           "tuple", "iter", "sorted"})


def _bound(target) -> set:
    """Names a binding target binds (through tuple / starred unpacking;
    a subscript or attribute target binds no name)."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, ast.Starred):
        return _bound(target.value)
    if isinstance(target, (ast.Tuple, ast.List)):
        return set().union(*(_bound(t) for t in target.elts))
    return set()


@register_rule("inplace-safety")
class InplaceSafetyRule(Rule):
    """An in-place write to a tensor read from the HBM cache or the
    chunk memo must go to a clone() made in the same function.

    torch has no buffer donation (the JAX package's donation-safety
    hazard); the hazard that took its place is aliasing. The chunk memo
    (`runtime.dev_cache_get`, and the lanes `device_put_chunk` memoizes
    on a chunk) and the HBM block cache (`get_or_fill`, a resident
    block's `.cols` / `.replicas`) hand the SAME tensors to every later
    reader: an `index_copy_` / `index_add_` / `copy_` / any `*_`
    method, an `out=` argument, a slice assignment or an augmented
    assignment on one of them — or on a view of one — silently corrupts
    every query that reads the block afterwards, and the concurrent
    reader that captured it mid-dispatch. The sanctioned shape is
    store/device_cache.scatter_block's: `nd = data.clone()`, then
    `nd.index_copy_(...)`, and the patched block swapped in whole.
    Parameters are tracked across calls: a function whose in-forest
    caller passes it a resident tensor is held to the same rule."""

    min_sites = 4       # the memo reads and resident-block reads in-tree
    fixture = (
        "from tidb_tpu_torch.ops import runtime\n"
        "\n"
        "def patch(chunk, size, idx, vals):\n"
        "    cols = runtime.dev_cache_get(chunk, size)\n"
        "    data, valid = cols[0]\n"
        "    data.index_copy_(0, idx, vals)\n"
        "    valid[idx] = True\n"
    )

    def check(self, forest):
        df = device_flow_of(forest)
        facts = [(fi, *self._facts(fi)) for fi in df.graph.funcs.values()]
        fed: dict = {}          # FuncInfo.key -> params fed a resident
        for _ in range(3):      # tensor by an in-forest call site
            grew = False
            for fi, binds, srcs, calls in facts:
                if not srcs and fi.key not in fed:
                    continue
                derived = self._derived(binds, fed.get(fi.key, ()))
                for call in calls:
                    grew |= self._feed(df, fi, call, derived, fed)
            if not grew:
                break
        for fi, binds, srcs, _calls in facts:
            self.sites += srcs
            if not srcs and fi.key not in fed:
                continue
            derived = self._derived(binds, fed.get(fi.key, ()))
            if not derived:
                continue
            for node in ast.walk(fi.node):
                what = self._write(node, derived)
                if what is None:
                    continue
                yield Finding(
                    fi.rel, node.lineno, self.name,
                    f"in-place {what} in {fi.qualname} writes a tensor "
                    f"read from the HBM cache / chunk memo — every later "
                    f"reader of the cached block sees the write; clone() "
                    f"it first (store/device_cache.scatter_block's shape)")

    # -- derivation ----------------------------------------------------------

    @staticmethod
    def _source(expr) -> bool:
        if isinstance(expr, ast.Call):
            return _call_name(expr) in _CACHE_READS
        if isinstance(expr, ast.Attribute) and \
                expr.attr in _RESIDENT_ATTRS:
            roots = _root_names(expr.value)
            return any("block" in r.lower() for r in roots)
        return False

    def _is_derived(self, expr, derived) -> bool:
        if self._source(expr):
            return True
        if isinstance(expr, ast.Name):
            return expr.id in derived
        if isinstance(expr, ast.Subscript):
            return self._is_derived(expr.value, derived)
        if isinstance(expr, ast.Starred):
            return self._is_derived(expr.value, derived)
        if isinstance(expr, ast.Attribute):
            return expr.attr in _RESIDENT_ATTRS and \
                self._is_derived(expr.value, derived)
        if isinstance(expr, ast.IfExp):
            return self._is_derived(expr.body, derived) or \
                self._is_derived(expr.orelse, derived)
        if isinstance(expr, ast.Call):
            fn = expr.func
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in _VIEW_METHODS:
                return self._is_derived(fn.value, derived)
            if isinstance(fn, ast.Name) and fn.id in _PASS_THROUGH:
                return any(self._is_derived(a, derived)
                           for a in expr.args)
        return False

    def _facts(self, fi) -> tuple:
        """-> (bindings, cache reads seen, calls) of one walk of `fi`."""
        binds, calls = [], []
        srcs = 0
        for node in ast.walk(fi.node):
            if self._source(node):
                srcs += 1
            if isinstance(node, ast.Call):
                calls.append(node)
            elif isinstance(node, ast.Assign):
                binds.append((node.targets, node.value))
            elif isinstance(node, (ast.For, ast.comprehension)):
                binds.append(([node.target], node.iter))
        return binds, srcs, calls

    def _derived(self, binds, fed_params) -> set:
        """Names bound (directly or through views) to cached tensors."""
        derived = set(fed_params)
        for _ in range(3):
            before = len(derived)
            for targets, value in binds:
                if self._is_derived(value, derived):
                    for t in targets:
                        derived |= _bound(t)
            if len(derived) == before:
                break
        return derived

    def _feed(self, df, fi, call, derived, fed) -> bool:
        """Mark the callee params this call passes cached tensors to."""
        args = [i for i, a in enumerate(call.args)
                if self._is_derived(a, derived)]
        kws = [kw.arg for kw in call.keywords
               if kw.arg and self._is_derived(kw.value, derived)]
        if not args and not kws:
            return False
        callee = df.graph.resolve_call(call, fi.rel, fi)
        if callee is None:
            return False
        a = callee.node.args
        params = [p.arg for p in a.posonlyargs + a.args]
        if callee.cls is not None and params and params[0] == "self" \
                and callee.node.name != "__init__":
            params = params[1:]
        elif callee.node.name == "__init__":
            params = params[1:]
        names = {params[i] for i in args if i < len(params)}
        names |= {k for k in kws if k in params or
                  k in {p.arg for p in a.kwonlyargs}}
        cur = fed.setdefault(callee.key, set())
        if names - cur:
            cur |= names
            return True
        return False

    # -- writes --------------------------------------------------------------

    def _write(self, node, derived) -> str | None:
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr.endswith("_") \
                    and not fn.attr.startswith("_") and \
                    self._is_derived(fn.value, derived):
                return f".{fn.attr}()"
            for kw in node.keywords:
                if kw.arg == "out" and self._is_derived(kw.value,
                                                        derived):
                    return "out= write"
            return None
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        self._is_derived(t.value, derived):
                    return "slice assignment"
            return None
        if isinstance(node, ast.AugAssign):
            t = node.target
            if (isinstance(t, ast.Name) and t.id in derived) or (
                    isinstance(t, ast.Subscript) and
                    self._is_derived(t.value, derived)):
                return "augmented assignment"
        return None

@register_rule("cache-key")
class CacheKeyRule(Rule):
    """Everything a kernel's program body reads must be an operand or be
    folded into the kernel object's cache key.

    A cached kernel object whose program body reads `self` state, a
    config/sysvar, or a mutable module global is specialized on that
    value when it is constructed; if the value is not part of the
    `FingerprintCache`/dict-cache key, a later call with different
    state silently reuses the stale kernel. Checks: (a) every ctor
    argument feeding program-read `self` attributes appears in the
    cache key (via `plan_fingerprint` args, the key tuple, or the
    executor/mesh cache-put helper); (b) every key includes
    `devplane.mesh_fingerprint` (the plane-identity contract) and, for
    a kernel bound to one device, `str(device)`; (c) program bodies
    read no config vars or mutable module globals; (d) kernel classes
    owning instance-bound programs are constructed only under a kernel
    cache; (e) profiler registrations distinguish the same components
    the cache key does; (f) the hand-written kernel's build reuses a
    library only under a key covering every input of its compile
    command (sources and flags)."""

    min_sites = 15
    fixture = (
        "import subprocess\n"
        "from tidb_tpu_torch.ops import runtime\n"
        "from tidb_tpu_torch import config\n"
        "\n"
        "SOURCE = 'k.cu'\n"
        "FLAGS = ['-O3']\n"
        "LIBRARY = 'k.so'\n"
        "\n"
        "class K:\n"
        "    def __init__(self, exprs, width, device):\n"
        "        self.exprs = exprs\n"
        "        self.width = width\n"
        "        self.device = device\n"
        "\n"
        "    def _kernel(self, cols, n):\n"
        "        lim = config.direct_agg_slots()\n"
        "        return (cols, self.width, lim)\n"
        "\n"
        "_KERNELS = runtime.FingerprintCache(8)\n"
        "\n"
        "def kernel_for(exprs, width, device):\n"
        "    fp = runtime.plan_fingerprint(None, exprs, [])\n"
        "    def make():\n"
        "        return K(exprs, width, device)\n"
        "    return _KERNELS.get_or_create(fp, make)\n"
        "\n"
        "def build(stale):\n"
        "    if not stale(SOURCE, LIBRARY):\n"
        "        return LIBRARY\n"
        "    subprocess.run(['nvcc', *FLAGS, '-o', LIBRARY, SOURCE])\n"
        "    return LIBRARY\n"
    )
    fixture_rel = "tidb_tpu_torch/ops/__lint_fixture__.py"

    def check(self, forest):
        df = device_flow_of(forest)
        classes = self._kernel_classes(df)
        caching = self._caching_functions(df, classes)
        cached_ctors = set()
        for F, info in caching.values():
            yield from self._check_caching_fn(df, F, info, classes,
                                              cached_ctors)
        yield from self._check_uncached_ctors(df, classes, cached_ctors,
                                              caching)
        yield from self._check_traced_state(df, classes)
        for site in df.sites:
            if site.form == "build":
                yield from self._check_build(df, site)

    # -- kernel classes ------------------------------------------------------

    def _kernel_classes(self, df) -> dict:
        """(rel, cls) -> {"attrs": {attr: read line}, "init": {attr:
        set of ctor param roots}, "params": [ctor params],
        "instance_bound": bool}."""
        out: dict = {}
        for site in df.sites:
            for fn in site.fns:
                if fn.cls is None:
                    continue
                key = (fn.rel, fn.cls)
                info = out.setdefault(
                    key, {"attrs": {}, "init": {}, "params": [],
                          "instance_bound": False, "fns": {}})
                info["fns"][fn.key] = fn
                if site.cls == fn.cls and site.store[0] in (
                        "attr", "dict", "return"):
                    info["instance_bound"] = True
        for (rel, cls), info in out.items():
            seen_bodies = set()
            for fn in list(info["fns"].values()):
                for body in df.reachable(fn):
                    if body.cls == cls and body.rel == rel and \
                            body.key not in seen_bodies:
                        seen_bodies.add(body.key)
                        self._attr_reads(body, info["attrs"])
            init = df.graph._method.get((rel, cls, "__init__"))
            if init is not None:
                a = init.node.args
                params = [p.arg for p in a.args[1:]]
                info["params"] = params
                env = {p: {p} for p in params}
                self._init_closure(df, init, env, info["init"], 0)
        return out

    def _attr_reads(self, fi, attrs: dict) -> None:
        callee_ids = set()
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                callee_ids.add(id(node.func))
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self" and \
                    isinstance(node.ctx, ast.Load) and \
                    id(node) not in callee_ids and \
                    not node.attr.startswith("__"):
                attrs.setdefault(node.attr, node.lineno)

    def _init_closure(self, df, fi, env: dict, out: dict,
                      depth: int) -> None:
        """self.X assignments of __init__ (helpers inlined to depth 3):
        X -> ctor-param roots of its value."""
        if depth > 3:
            return

        def roots(expr) -> set:
            r: set = set()
            for n in _root_names(expr):
                r |= env.get(n, set())
            for node in ast.walk(expr):
                if isinstance(node, ast.Call):
                    cn = _call_name(node)
                    if _is_mesh_fp(node) or (
                            isinstance(node.func, ast.Attribute) and
                            isinstance(node.func.value, ast.Name) and
                            node.func.value.id == "devplane"):
                        r.add(_MESH_ROOT)
                    _ = cn
            return r

        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign):
                val_roots = roots(node.value)
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        out.setdefault(t.attr, set()).update(val_roots)
                    elif isinstance(t, ast.Name):
                        env.setdefault(t.id, set()).update(val_roots)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self":
                helper = df.graph._method.get(
                    (fi.rel, fi.cls, node.func.attr))
                if helper is not None and \
                        node.func.attr != "__init__":
                    a = helper.node.args
                    hparams = [p.arg for p in a.args[1:]]
                    henv = {}
                    for i, arg in enumerate(node.args):
                        if i < len(hparams):
                            henv[hparams[i]] = roots(arg)
                    for kw in node.keywords:
                        if kw.arg in hparams:
                            henv[kw.arg] = roots(kw.value)
                    self._init_closure(df, helper, henv, out, depth + 1)

    # -- caching functions ---------------------------------------------------

    def _caching_functions(self, df, classes) -> dict:
        """Functions that own a kernel cache: they call
        `.get_or_create(key, ...)`, a cache helper whose body both
        fingerprints the mesh and stores into a module dict, or — when
        they construct a kernel class themselves — memoize inline into
        a keyed dict (the executor shuffle-kernel shape). Scoped to
        modules that hold kernel sites or functions that construct a
        kernel class; unrelated registries (the profiler's own row
        cache) are not kernel caches."""
        site_rels = {s.rel for s in df.sites}
        factories = {id(s.call) for s in df.sites if s.form == "factory"}
        out: dict = {}
        for fi in df.graph.funcs.values():
            if fi.parent is not None:
                continue
            makes_kernel = any(
                isinstance(n, ast.Call) and
                self._ctor_class(df, fi, n, classes) is not None
                for n in ast.walk(fi.node))
            if fi.rel not in site_rels and not makes_kernel:
                continue
            entries = []        # (kind, node)
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                if id(node) in factories:
                    entries.append(("get_or_create", node))
                else:
                    hit = df.graph.resolve_call(node, fi.rel, fi)
                    if hit is not None and hit.rel == fi.rel and \
                            hit is not fi and \
                            self._is_cache_helper(hit):
                        entries.append(("helper", node))
            if makes_kernel and not entries:
                for node in ast.walk(fi.node):
                    if isinstance(node, ast.Assign):
                        for t in node.targets:
                            if isinstance(t, ast.Subscript):
                                entries.append(("inline", t))
            if entries:
                out[fi.key] = (fi, entries)
        return out

    def _is_cache_helper(self, fi) -> bool:
        has_mesh = any(isinstance(n, ast.Call) and _is_mesh_fp(n)
                       for n in ast.walk(fi.node))
        if not has_mesh:
            return False
        for node in ast.walk(fi.node):
            if isinstance(node, (ast.Assign,)):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        return True
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Store):
                return True
        return False

    def _resolve_roots(self, fi, expr, memo=None, depth=0) -> set:
        """Transitive bare-name roots of `expr` within `fi`'s body
        (locals resolved through their bindings; mesh-fingerprint
        calls contribute the mesh pseudo-root)."""
        if memo is None:
            memo = {}
        out: set = set()
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                if _is_mesh_fp(node) or (
                        isinstance(node.func, ast.Attribute) and
                        node.func.attr == "active_mesh"):
                    out.add(_MESH_ROOT)
                if _is_device_str(node):
                    out.add(_DEVICE_ROOT)
        if depth > 4:
            return out | _root_names(expr)
        for name in _root_names(expr):
            if name in memo:
                out |= memo[name]
                continue
            memo[name] = {name}
            binding = None
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == name
                        for t in node.targets):
                    binding = node.value
                    break
            if binding is not None:
                # a local is an alias: its roots are the underlying
                # sources, not the alias name itself
                resolved = self._resolve_roots(fi, binding, memo,
                                               depth + 1)
                memo[name] = resolved or {name}
            out |= memo[name]
        return out

    def _check_caching_fn(self, df, F, entries, classes, cached_ctors):
        covered: set = set()
        mesh_ok = False
        device_ok = False
        for kind, call in entries:
            self.sites += 1
            if kind == "get_or_create":
                key_roots = self._resolve_roots(F, call.args[0])
                covered |= key_roots
                if _MESH_ROOT in key_roots:
                    mesh_ok = True
                if _DEVICE_ROOT in key_roots:
                    device_ok = True
            elif kind == "inline":
                key_roots = self._resolve_roots(F, call.slice)
                covered |= key_roots
                if _MESH_ROOT in key_roots:
                    mesh_ok = True
                if _DEVICE_ROOT in key_roots:
                    device_ok = True
            else:
                for arg in call.args:
                    covered |= self._resolve_roots(F, arg)
                mesh_ok = True      # helper bodies fingerprint the mesh
                device_ok = True    # the plane names the devices
        if not mesh_ok:
            yield Finding(
                F.rel, entries[0][1].lineno, self.name,
                f"kernel cache in {F.qualname}() does not fold "
                f"devplane.mesh_fingerprint into its key — a plane "
                f"change would reuse kernel objects built for another "
                f"plane")
        mod_names, _ = _mod_info(df, F.rel)
        # constructions of kernel classes inside F (and its closures)
        for node in ast.walk(F.node):
            if not isinstance(node, ast.Call):
                continue
            cls_key = self._ctor_class(df, F, node, classes)
            if cls_key is None:
                continue
            cached_ctors.add(id(node))
            info = classes[cls_key]
            bindings = self._ctor_bindings(info["params"], node)
            if "device" in bindings and not device_ok:
                self.sites += 1
                yield Finding(
                    F.rel, node.lineno, self.name,
                    f"{cls_key[1]} is bound to a device but the cache "
                    f"key in {F.qualname}() does not hold str(device) — "
                    f"a kernel built for one card would serve another")
            for attr, line in sorted(info["attrs"].items()):
                self.sites += 1
                roots = info["init"].get(attr)
                if roots is None:
                    continue        # attr not ctor-derived: flagged by
                    #                 _check_traced_state if stateful
                for param in sorted(roots):
                    if param == _MESH_ROOT:
                        if not mesh_ok:
                            yield Finding(
                                F.rel, node.lineno, self.name,
                                f"{cls_key[1]}.{attr} derives from the "
                                f"device plane but the cache key has "
                                f"no mesh fingerprint")
                        continue
                    arg_expr = bindings.get(param)
                    if arg_expr is None:
                        continue    # default value: constant
                    need = {n for n in self._resolve_roots(F, arg_expr)
                            if n not in mod_names and not _is_const(n)
                            and n != _MESH_ROOT}
                    missing = need - covered
                    if missing:
                        yield Finding(
                            F.rel, node.lineno, self.name,
                            f"program body of {cls_key[1]} reads "
                            f"self.{attr} (line {line}) but ctor arg "
                            f"{param!r} <- {', '.join(sorted(missing))} "
                            f"is not folded into the cache key")
        # profiler registrations must key on covered components
        var_covered = {n for n in covered
                       if n != _MESH_ROOT and not _is_const(n)}
        for node in ast.walk(F.node):
            if isinstance(node, ast.Call) and \
                    _call_name(node) == "profile" and \
                    len(node.args) >= 2 and \
                    isinstance(node.args[0], ast.Constant):
                if isinstance(node.args[1], ast.Constant):
                    continue    # explicit unfingerprinted row ("~")
                self.sites += 1
                fp_roots = self._resolve_roots(F, node.args[1])
                if var_covered and not (fp_roots & (
                        var_covered | {_MESH_ROOT})):
                    yield Finding(
                        F.rel, node.lineno, self.name,
                        "profiler registration does not distinguish "
                        "the cache key's components — profile rows "
                        "from different kernel objects would merge")

    def _ctor_class(self, df, F, call, classes):
        if isinstance(call.func, ast.Name):
            rel = df.graph._classes.get((F.rel, call.func.id))
            if rel is not None and (rel, call.func.id) in classes:
                return (rel, call.func.id)
        hit = df.graph.resolve_call(call, F.rel, F)
        if hit is not None and hit.cls is not None and \
                hit.node.name == "__init__" and \
                (hit.rel, hit.cls) in classes:
            return (hit.rel, hit.cls)
        return None

    def _ctor_bindings(self, params, call) -> dict:
        out = {}
        for i, arg in enumerate(call.args):
            if i < len(params):
                out[params[i]] = arg
        for kw in call.keywords:
            if kw.arg in params:
                out[kw.arg] = kw.value
        return out

    def _check_uncached_ctors(self, df, classes, cached_ctors, caching):
        """Instance-bound plane programs must be built under a kernel
        cache — a per-statement construction rebuilds them per query."""
        bound = {k for k, v in classes.items() if v["instance_bound"]}
        if not bound:
            return
        names = {cls: key for key, v in classes.items()
                 for (rel, cls) in [key] if key in bound}
        for pf in df.forest:
            for node in pf.nodes:
                if not isinstance(node, ast.Call) or \
                        id(node) in cached_ctors:
                    continue
                if not isinstance(node.func, ast.Name) or \
                        node.func.id not in names:
                    continue
                key = names[node.func.id]
                if df.graph._classes.get(
                        (pf.rel, node.func.id)) != key[0] and \
                        pf.rel != key[0]:
                    # name does not resolve to the kernel class here
                    if node.func.id not in df.graph._imports.get(
                            pf.rel, {}):
                        continue
                self.sites += 1
                fi = df.enclosing_function(pf.rel, node)
                if fi is not None and (fi.key in caching or (
                        fi.parent is not None and
                        fi.parent.key in caching)):
                    continue
                if fi is not None and fi.cls == key[1]:
                    continue        # class's own plumbing
                yield Finding(
                    pf.rel, node.lineno, self.name,
                    f"{node.func.id} owns instance-bound plane "
                    f"programs but is constructed outside a kernel "
                    f"cache — every construction rebuilds them")

    def _check_traced_state(self, df, classes):
        """Config reads and mutable module globals inside program
        bodies."""
        seen: set = set()
        scanned: set = set()
        for site in df.sites:
            for fn in site.fns:
                if fn.key in scanned:
                    continue
                scanned.add(fn.key)
                self.sites += 1
                _, mod_mutable = _mod_info(df, fn.rel)
                bound = _bound_names(fn)
                for node in ast.walk(fn.node):
                    if isinstance(node, ast.Call) and \
                            isinstance(node.func, ast.Attribute) and \
                            isinstance(node.func.value, ast.Name) and \
                            node.func.value.id == "config":
                        k = (fn.rel, node.lineno)
                        if k not in seen:
                            seen.add(k)
                            yield Finding(
                                fn.rel, node.lineno, self.name,
                                f"config.{node.func.attr}() read "
                                f"inside program body "
                                f"{fn.qualname} — a cached kernel "
                                f"object keeps serving whatever the "
                                f"value was; pass it as a ctor arg "
                                f"folded into the cache key")
                    elif isinstance(node, ast.Name) and \
                            isinstance(node.ctx, ast.Load) and \
                            node.id in mod_mutable and \
                            node.id not in bound:
                        k = (fn.rel, node.lineno, node.id)
                        if k not in seen:
                            seen.add(k)
                            yield Finding(
                                fn.rel, node.lineno, self.name,
                                f"program body {fn.qualname} reads "
                                f"module global `{node.id}` — "
                                f"state the cache key cannot see")

    # -- the hand-written kernel's build -------------------------------------

    def _check_build(self, df, site):
        """The library a build reuses must be keyed on every module
        constant its compile command reads: a reuse check that looks at
        the source alone keeps serving a library built with other
        flags."""
        F = site.owner
        self.sites += 1
        cmd = site.call.args[0] if site.call.args else site.call
        inputs = self._module_inputs(df, F, cmd, 0)
        key: set = set()
        for stmt in ast.walk(F.node):
            if isinstance(stmt, ast.If) and stmt.lineno < site.line and \
                    any(isinstance(n, ast.Return) for s in stmt.body
                        for n in ast.walk(s)):
                key |= self._module_inputs(df, F, stmt.test, 0)
        missing = sorted(inputs - key)
        if missing:
            yield Finding(
                F.rel, site.line, self.name,
                f"{F.qualname}() reuses a built library under a check "
                f"that does not cover {', '.join(missing)} — a change "
                f"there would keep loading the stale build; fold every "
                f"input of the compile command into the reuse key")

    def _module_inputs(self, df, fi, expr, depth) -> set:
        """Module-level constants `expr` reads in `fi`: through local
        bindings, same-module helper calls (to depth 3) and the
        constants' own definitions."""
        pf = df.forest.get(fi.rel)
        consts = {}
        for stmt in pf.tree.body:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and _is_const(t.id):
                        consts[t.id] = stmt.value
        out: set = set()
        seen: set = set()

        def walk(e, f, d):
            for n in ast.walk(e):
                if isinstance(n, ast.Name) and n.id not in seen:
                    seen.add(n.id)
                    if n.id in consts:
                        out.add(n.id)
                        walk(consts[n.id], f, d)
                        continue
                    for b in ast.walk(f.node):
                        if isinstance(b, ast.Assign) and any(
                                isinstance(t, ast.Name) and t.id == n.id
                                for t in b.targets):
                            walk(b.value, f, d)
                            break
                elif isinstance(n, ast.Call) and d < 3:
                    hit = df.graph.resolve_call(n, f.rel, f)
                    if hit is not None and hit.rel == f.rel and \
                            hit is not f:
                        for s in hit.node.body:
                            walk(s, hit, d + 1)

        walk(expr, fi, depth)
        return out

# ---------------------------------------------------------------------------
# retrace-hazard
# ---------------------------------------------------------------------------

@register_rule("retrace-hazard")
class RetraceHazardRule(Rule):
    """Dispatch shapes must be bounded, and program bodies must not
    coerce tensors to Python.

    The kernel caches key per plan, and the per-shape work below them
    (the segment-sum kernel's launch plan, the profiler's rows, the
    caching allocator's blocks) keys per operand shape: raw data-sized
    operands mint one entry per input length, so operands must flow
    through the pow2 superchunk bucketing (`runtime.bucket_size` /
    `pad_column` / `device_put_chunk` / `put_lanes`) and program-memo
    keys must be bucketed (the bounded bucket-dict shape is
    sanctioned). Inside a program body, `float()`/`int()`/`bool()` of a
    tensor, a tensor's `.item()` / `.tolist()` / `.cpu()` / `.numpy()`,
    or `np.asarray` over one forces a device->host sync mid-program —
    host coercions belong in finalize, after the one readback. Only
    provable tensors count: a Python int's `int(m - 1)` is shape
    arithmetic, not a sync."""

    min_sites = 10
    fixture = (
        "import torch\n"
        "from tidb_tpu_torch.ops import runtime\n"
        "\n"
        "class K:\n"
        "    def _kernel(self, cols, n):\n"
        "        total = torch.sum(cols[0])\n"
        "        return bool(total > 0), total.item()\n"
        "\n"
        "    def dispatch(self, cols):\n"
        "        return self._kernel(cols, 4)\n"
        "\n"
        "_KERNELS = runtime.FingerprintCache(8)\n"
        "\n"
        "def kernel_for(key):\n"
        "    def make():\n"
        "        return K()\n"
        "    return _KERNELS.get_or_create(key, make)\n"
    )

    def check(self, forest):
        df = device_flow_of(forest)
        inline = set()          # fns reachable from program bodies:
        for site in df.sites:   # calls there run inside the program,
            for fn in site.fns:  # not at a dispatch boundary
                inline |= {f.key for f in df.reachable(fn)}
        for d in df.dispatches:
            self.sites += 1
            if d.func is not None and d.func.key in inline:
                continue
            yield from self._check_shapes(d)
            yield from self._check_memo_key(df, d)
        yield from self._check_coercions(df)

    def _check_shapes(self, d):
        fi = d.func
        if fi is None:
            return
        if any(isinstance(n, ast.Call) and _call_name(n) in SHAPERS
               for n in ast.walk(fi.node)):
            return
        a = fi.node.args
        params = {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}
        for arg in d.call.args:
            if isinstance(arg, ast.Name) and arg.id in params:
                yield Finding(
                    d.rel, d.line, self.name,
                    f"`{arg.id}` dispatched to `{d.site.fn_name}` at "
                    f"its raw size — one launch shape per input length; "
                    f"route it through runtime.bucket_size pow2 "
                    f"padding")

    def _check_memo_key(self, df, d):
        if d.via_factory is None:
            return
        fi = d.func
        for arg in d.via_factory.args:
            self.sites += 1
            if not self._bounded_key(fi, arg, 0):
                yield Finding(
                    d.rel, d.line, self.name,
                    f"program-memo key `{ast.unparse(arg)}` is not "
                    f"bucketed — an unbounded key set builds (and "
                    f"pins) one program per distinct value")

    def _bounded_key(self, fi, expr, depth: int) -> bool:
        if isinstance(expr, ast.Starred):
            expr = expr.value
        if isinstance(expr, ast.Constant):
            return True
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                cn = _call_name(node) or ""
                if cn in SHAPERS or "bucket" in cn:
                    return True
        if isinstance(expr, ast.Attribute):
            return "cap" in expr.attr or "bucket" in expr.attr
        if isinstance(expr, (ast.Tuple, ast.List)):
            return all(self._bounded_key(fi, e, depth + 1)
                       for e in expr.elts)
        if isinstance(expr, ast.Name) and fi is not None:
            a = fi.node.args
            if expr.id in {p.arg for p in
                           (a.posonlyargs + a.args + a.kwonlyargs)}:
                return True     # caller's discipline, checked there
            if depth > 3:
                return False
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == expr.id
                        for t in node.targets):
                    return self._bounded_key(fi, node.value, depth + 1)
        return False

    def _check_coercions(self, df):
        seen: set = set()
        for site in df.sites:
            for body in df.traced_bodies(site):
                if body.key in seen:
                    continue
                seen.add(body.key)
                self.sites += 1
                yield from self._scan_body(df, body)

    def _scan_body(self, df, fi):
        tensors = df.tensors(fi)
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in COERCIONS and \
                    node.args and tensors.is_tensor(node.args[0]):
                yield Finding(
                    fi.rel, node.lineno, self.name,
                    f"{fn.id}() of a tensor inside program body "
                    f"{fi.qualname} forces a device->host sync — host "
                    f"coercions belong in finalize")
                continue
            kind = is_host_method_call(node)
            if kind is not None and tensors.is_tensor(fn.value):
                yield Finding(
                    fi.rel, node.lineno, self.name,
                    f"{kind} inside program body {fi.qualname} — a "
                    f"device->host sync per call")
            elif isinstance(fn, ast.Attribute) and \
                    isinstance(fn.value, ast.Name) and \
                    fn.value.id in ("np", "numpy") and \
                    fn.attr in ("asarray", "array") and node.args and \
                    tensors.is_tensor(node.args[0]):
                yield Finding(
                    fi.rel, node.lineno, self.name,
                    f"{fn.value.id}.{fn.attr}() of a tensor inside "
                    f"program body {fi.qualname} materializes on the "
                    f"host mid-program")

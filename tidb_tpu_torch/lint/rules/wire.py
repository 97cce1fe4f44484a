"""Wire-path codec discipline (port of tests/test_lint_wire.py)."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule

# every module that builds, parses, or routes frames
WIRE_PATH_FILES = (
    "tidb_tpu_torch/store/wire.py",
    "tidb_tpu_torch/store/remote.py",
    "tidb_tpu_torch/store/stream.py",
    "tidb_tpu_torch/store/copr.py",
    "tidb_tpu_torch/store/region_cache.py",
    "tidb_tpu_torch/mockstore/rpc.py",
)

_CODE_LOADERS = ("pickle", "cPickle", "dill", "shelve", "marshal")

# the only functions allowed to call socket .recv(); each must be a
# bounded loop over an explicit byte count
RECV_HELPERS = {"_recv_exact"}

_RECV_HOME = "tidb_tpu_torch/store/remote.py"


def _functions_calling_recv(tree):
    out = {}

    class V(ast.NodeVisitor):
        def __init__(self):
            self.stack = []

        def _visit_func(self, node):
            self.stack.append(node.name)
            self.generic_visit(node)
            self.stack.pop()

        visit_FunctionDef = _visit_func
        visit_AsyncFunctionDef = _visit_func

        def visit_Call(self, node):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr == "recv":
                name = self.stack[-1] if self.stack else "<module>"
                out.setdefault(name, []).append(node)
            self.generic_visit(node)

    V().visit(tree)
    return out


@register_rule("wire-discipline")
class WireRule(Rule):
    """Wire path stays pickle-free and every socket recv is the bounded
    length-prefixed helper.

    1. No wire-path module imports a code-executing deserializer
       (pickle family): decoding must never execute code. Trusted
       local-disk snapshots live in store/snapshot.py, deliberately OFF
       the wire list.
    2. Every socket `recv` happens inside `_recv_exact`, which loops on
       an explicit remaining-byte count and raises on EOF; ad-hoc
       `sock.recv(65536)` loops are how partial reads become frame
       desync.
    3. store/wire.py (the codec) calls no eval/exec/__import__/compile:
       decode() only constructs registry types.
    """

    min_sites = 1       # at least the _recv_exact recv itself
    fixture_rel = "tidb_tpu_torch/store/wire.py"
    fixture = (
        "import pickle\n"
        "def read_frame(sock, n):\n"
        "    return sock.recv(65536)\n"
    )

    def check(self, forest):
        for rel in WIRE_PATH_FILES:
            pf = forest.get(rel)
            if pf is None:
                # the old walker failed loudly (FileNotFoundError) when
                # a wire module moved; a silent skip would un-enforce
                # the invariants exactly when a refactor renames a file
                yield Finding(
                    rel, 1, self.name,
                    "wire-path module missing from the forest — moved/"
                    "renamed files must update WIRE_PATH_FILES in "
                    "tidb_tpu_torch/lint/rules/wire.py")
                continue
            yield from self._check_imports(pf)
            yield from self._check_recv(pf)
        yield from self._check_helper(forest)
        yield from self._check_codec_closed(forest)

    def _check_imports(self, pf):
        for node in pf.nodes:
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for mod in mods:
                self.sites += 1
                if mod.split(".")[0] in _CODE_LOADERS:
                    yield Finding(
                        pf.rel, node.lineno, self.name,
                        f"imports {mod}: wire-path modules must stay "
                        f"pickle-free (trusted on-disk snapshots belong "
                        f"in store/snapshot.py)")

    def _check_recv(self, pf):
        for fname, calls in _functions_calling_recv(pf.tree).items():
            for call in calls:
                self.sites += 1
                if fname not in RECV_HELPERS:
                    yield Finding(
                        pf.rel, call.lineno, self.name,
                        f"socket recv in {fname!r}, outside the bounded "
                        f"helper(s) {sorted(RECV_HELPERS)} — all frame "
                        f"reads go through the length-prefixed "
                        f"_recv_exact loop")
                elif not call.args or isinstance(call.args[0],
                                                 ast.Constant):
                    yield Finding(
                        pf.rel, call.lineno, self.name,
                        "recv must take the exact remaining byte count, "
                        "never no-arg / constant-buffer style")

    def _check_helper(self, forest):
        pf = forest.get(_RECV_HOME)
        if pf is None:
            return
        helper = None
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.FunctionDef) and \
                    node.name == "_recv_exact":
                helper = node
                break
        if helper is None:
            yield Finding(pf.rel, 1, self.name,
                          "store/remote.py lost _recv_exact")
            return
        self.sites += 1
        has_loop = any(isinstance(n, ast.While) for n in ast.walk(helper))
        raises = any(isinstance(n, ast.Raise) for n in ast.walk(helper))
        if not (has_loop and raises):
            yield Finding(pf.rel, helper.lineno, self.name,
                          "_recv_exact must loop to the requested count "
                          "and raise on EOF (no silent short read)")

    def _check_codec_closed(self, forest):
        pf = forest.get("tidb_tpu_torch/store/wire.py")
        if pf is None:
            return
        for node in ast.walk(pf.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in ("eval", "exec", "__import__",
                                     "compile"):
                yield Finding(pf.rel, node.lineno, self.name,
                              f"codec calls {node.func.id} — decode() "
                              f"only constructs registry types")

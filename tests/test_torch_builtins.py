"""The port's builtin functions against the JAX package's, through SQL.

`expression/builtins.py`, `builtins_ext.py` and `util/aes128.py` are the
port's copies of the reference's long-tail functions, reached through the
resolver for every SQL function outside its first-class ops. This file
holds them against the reference on the same statements:

  * the corpus is every statement the reference's own builtin tests
    (tests/test_builtins.py, tests/test_builtins_ext.py) evaluate, read
    from those files' syntax trees: each `one(sess, EXPR[, WHERE])`, each
    parametrized `expr`, and each constant SELECT sent to a session
    fixture, over the tables the fixture and the tests create;
  * each statement runs in both packages' Sessions over the same rows
    (the port's storage on `device="cpu"`), the port's twice: with the
    device path on (and `tidb_tpu_device_min_rows = 1`, so the core ops
    around the builtins run on tensors) and with `tidb_tpu_device = 0`;
  * rows must be equal: every value of the same Python type and equal,
    REAL within rel=1e-12. A statement the reference refuses with an
    error must be refused by the port with the same kind and message.
    Functions whose value changes from call to call (the clock, UUIDs,
    RAND() without a seed, RANDOM_BYTES) are held to the same type and,
    for strings and bytes, the same length;
  * the port's AES-128 block cipher passes the FIPS-197 appendix C.1
    vector and agrees with the reference's on random keys and blocks,
    and AES_ENCRYPT / AES_DECRYPT through it (the fallback taken where
    the `cryptography` package is absent) equal the reference's.
"""

import ast
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu.util import aes128 as jaes
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage
from tidb_tpu_torch.util import aes128 as paes

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

TESTS = pathlib.Path(__file__).parent
SOURCES = ("test_builtins.py", "test_builtins_ext.py")

_VOLATILE = re.compile(
    r"\b(?:NOW|CURDATE|CURTIME|SYSDATE|LOCALTIME|LOCALTIMESTAMP|UTC_DATE|"
    r"UTC_TIME|UTC_TIMESTAMP|UUID|UUID_SHORT|RANDOM_BYTES)\s*\(|"
    r"\bRAND\(\s*\)", re.I)


def _const(node):
    return node.value if isinstance(node, ast.Constant) and \
        isinstance(node.value, str) else None


def _fixtures(fn) -> set:
    return {a.arg for a in fn.args.args}


def _is_fixture(fn) -> bool:
    return any("fixture" in ast.unparse(d) for d in fn.decorator_list)


def _one_sql(expr: str, where: str = "id=1") -> str:
    return f"SELECT {expr} FROM t WHERE {where}"


def _harvest(path: pathlib.Path):
    """(setups, statements) of one reference test file: `setups` maps a
    session fixture's name to the CREATE TABLE / INSERT statements that
    make its data (the fixture's own, then the tests'), `statements` is
    [(fixture, sql)] of every SELECT the file evaluates."""
    tree = ast.parse(path.read_text())
    fns = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]
    names = {fn.name for fn in fns if _is_fixture(fn)}
    setups = {name: [] for name in names}
    stmts = []
    for fn in sorted(fns, key=_is_fixture, reverse=True):
        owner = fn.name if fn.name in names else None
        used = _fixtures(fn) & names
        params = []
        for d in fn.decorator_list:
            if isinstance(d, ast.Call) and \
                    ast.unparse(d.func).endswith("parametrize") and \
                    _const(d.args[0]) and \
                    _const(d.args[0]).split(",")[0] == "expr":
                for v in d.args[1].elts:
                    first = v.elts[0] if isinstance(v, ast.Tuple) else v
                    params.append(_const(first))
        calls = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Call)),
                       key=lambda n: (n.lineno, n.col_offset))
        for call in calls:
            f = call.func
            args = [_const(a) for a in call.args]
            if isinstance(f, ast.Name) and f.id == "one" and \
                    getattr(call.args[0], "id", None) in used:
                sess = call.args[0].id
                where = args[2] if len(args) > 2 else "id=1"
                if args[1] is not None:
                    stmts.append((sess, _one_sql(args[1], where)))
                elif isinstance(call.args[1], ast.Name):
                    stmts.extend((sess, _one_sql(p, where)) for p in params)
            elif isinstance(f, ast.Attribute) and \
                    f.attr in ("query", "execute") and args and args[0]:
                recv = ast.unparse(f.value)
                sess = owner if owner and recv == "s" else \
                    recv if recv in used else None
                sql = args[0].lstrip()
                if sess is None:
                    continue
                if re.match(r"(CREATE TABLE|INSERT)\b", sql, re.I):
                    setups[sess].append(sql)
                elif re.match(r"SELECT\b", sql, re.I) and owner is None:
                    stmts.append((sess, sql))
    return setups, list(dict.fromkeys(stmts))


def _corpus():
    cases = []
    for src in SOURCES:
        setups, stmts = _harvest(TESTS / src)
        cases += [pytest.param(src, setups[s], s, sql,
                               id=f"{src[5:-3]}-{s}-{sql}")
                  for s, sql in stmts]
    return cases


CORPUS = _corpus()


@pytest.fixture(scope="module")
def sessions():
    """(source, fixture) -> (reference session, port session), made on
    first use over the same statements; closed at the end."""
    made = {}

    def get(src, fixture, setup):
        key = (src, fixture)
        if key not in made:
            js, ps = jnew_storage(), pnew_storage(device="cpu")
            jsess, psess = JSession(js), PSession(ps)
            for s in (jsess, psess):
                s.execute("CREATE DATABASE bt")
                s.execute("USE bt")
                for sql in setup:
                    s.execute(sql)
            made[key] = (jsess, psess, js, ps)
        return made[key][:2]

    yield get
    for jsess, psess, js, ps in made.values():
        psess.close()
        jsess.close()
        ps.close()
        js.close()


def _run(sess, sql):
    try:
        return sess.query(sql).rows
    except Exception as e:   # noqa: BLE001 - the kind is what is compared
        return (type(e).__name__, str(e))


def _same_value(got, want, volatile: bool) -> bool:
    if type(got) is not type(want):
        return False
    if volatile:
        return len(got) == len(want) if isinstance(got, (str, bytes)) \
            else True
    if isinstance(want, float):
        return math.isclose(got, want, rel_tol=1e-12) or \
            (math.isnan(got) and math.isnan(want))
    return got == want


def assert_same(got, want, volatile: bool):
    if isinstance(want, tuple):       # an error: the same kind and text
        assert got == want
        return
    assert isinstance(got, list), got
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert all(_same_value(a, b, volatile) for a, b in zip(g, w)), \
            (g, w)


def test_corpus_covers_both_files():
    per_file = {src: sum(1 for c in CORPUS if c.values[0] == src)
                for src in SOURCES}
    assert per_file["test_builtins.py"] > 100
    assert per_file["test_builtins_ext.py"] > 100


@pytest.mark.parametrize("src,setup,fixture,sql", CORPUS)
def test_statement_equals_the_reference(sessions, src, setup, fixture, sql):
    jsess, psess = sessions(src, fixture, setup)
    volatile = bool(_VOLATILE.search(sql))
    want = _run(jsess, sql)
    psess.execute("SET @@tidb_tpu_device_min_rows = 1")
    try:
        assert_same(_run(psess, sql), want, volatile)
    finally:
        psess.execute("SET @@tidb_tpu_device_min_rows = 2048")
    psess.execute("SET @@tidb_tpu_device = 0")
    try:
        assert_same(_run(psess, sql), want, volatile)
    finally:
        psess.execute("SET @@tidb_tpu_device = 1")


def test_aes128_matches_fips197():
    """FIPS-197 appendix C.1: AES-128 of 00112233...eeff under the key
    000102...0f."""
    key = bytes(range(16))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    ct = paes.encrypt_block(key, pt)
    assert ct.hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
    assert paes.decrypt_block(key, ct) == pt


def test_aes128_equals_the_reference():
    rng = np.random.default_rng(42)
    for _ in range(64):
        key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        block = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        ct = paes.encrypt_block(key, block)
        assert ct == jaes.encrypt_block(key, block)
        assert paes.decrypt_block(key, ct) == block
        assert paes.decrypt_block(key, block) == \
            jaes.decrypt_block(key, block)


def test_aes_fallback_equals_the_reference(sessions, monkeypatch):
    from tidb_tpu_torch.expression import builtins_ext
    src = "test_builtins_ext.py"
    setup = next(c.values[1] for c in CORPUS if c.values[0] == src)
    jsess, psess = sessions(src, "sess", setup)
    sql = ("SELECT HEX(AES_ENCRYPT(CONCAT(s, REPEAT('x', 20)), 'key')), "
           "AES_DECRYPT(AES_ENCRYPT(s, 'k2'), 'k2') FROM t ORDER BY id")
    want = _run(jsess, sql)
    assert want[0][1] == "hello"
    monkeypatch.setattr(builtins_ext, "_AES_HAVE_CRYPTOGRAPHY", False)
    assert_same(_run(psess, sql), want, volatile=False)

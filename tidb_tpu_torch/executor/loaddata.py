"""LOAD DATA INFILE: bulk text-file ingestion.

The port's copy of the JAX package's executor/loaddata.py (ref:
executor/write.go:1373 LoadDataExec and its field and line splitting:
FIELDS TERMINATED / ENCLOSED / ESCAPED, LINES STARTING / TERMINATED,
IGNORE n LINES, \\N = NULL). The server reads the named file in bounded
chunks (host memory stays O(chunk + one line)) and writes through the
same Table.add_record path as INSERT, reusing Insert's duplicate
handling for REPLACE / IGNORE. All rows land in the statement's
transaction.

Single-byte separators scan through the native C++ scanner
(native/loadscan.cc); the general Python scanner takes what it cannot:
multi-byte separators or LINES STARTING BY, a missing native library,
and an irregular remainder the scanner stalls on. `SCAN_STATS` counts
the chunks and rows the native scanner served and each fallback under
its reason ("separators", "unavailable", "irregular").
"""

from __future__ import annotations

import functools
import re
import threading
from decimal import Decimal, InvalidOperation


from tidb_tpu_torch.executor import ExecError
from tidb_tpu_torch.executor.write import Insert
from tidb_tpu_torch.sqltypes import EvalType, parse_datetime

__all__ = ["parse_lines", "convert_fields", "read_text_chunks",
           "RowsInsert", "READ_CHUNK", "SCAN_STATS", "scan_stats",
           "reset_scan_stats"]

READ_CHUNK = 1 << 20          # file read granularity (bytes of text)

_stats_lock = threading.Lock()
# native scanner chunks and rows served, and Python-scanner fallbacks
# by reason; guarded-by: _stats_lock
SCAN_STATS = {"native_chunks": 0, "native_rows": 0, "fallbacks": {}}


def _note_fallback(reason: str) -> None:
    with _stats_lock:
        fb = SCAN_STATS["fallbacks"]
        fb[reason] = fb.get(reason, 0) + 1


def _note_native(rows: int) -> None:
    with _stats_lock:
        SCAN_STATS["native_chunks"] += 1
        SCAN_STATS["native_rows"] += rows


def scan_stats() -> dict:
    """A copy of SCAN_STATS."""
    with _stats_lock:
        return {"native_chunks": SCAN_STATS["native_chunks"],
                "native_rows": SCAN_STATS["native_rows"],
                "fallbacks": dict(SCAN_STATS["fallbacks"])}


def reset_scan_stats() -> None:
    with _stats_lock:
        SCAN_STATS["native_chunks"] = 0
        SCAN_STATS["native_rows"] = 0
        SCAN_STATS["fallbacks"] = {}


def _unescape(s: str, esc: str) -> str | None:
    """Undo ESCAPED BY sequences; a lone escaped 'N' is SQL NULL."""
    if esc and s == esc + "N":
        return None
    if not esc or esc not in s:
        return s
    out = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c == esc and i + 1 < n:
            nxt = s[i + 1]
            out.append({"n": "\n", "t": "\t", "r": "\r",
                        "0": "\0"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _split_lines(chunks, lt: str, ft: str, enc: str, esc: str,
                 starting: str = "", ignore_lines: int = 0):
    """Logical lines from a stream of text chunks: a terminator inside an
    enclosed field or behind the escape character does not end the row,
    and a token straddling a chunk boundary is handled by holding back a
    small tail until more text arrives. Memory is O(chunk + current
    line). Event scanning is find-based (one regex alternation), not
    per-character. An enclosure opens only at field start (line start or
    right after a field terminator) — a stray quote mid-field is a
    literal, exactly as in MySQL's parser. With LINES STARTING BY, text
    up to the prefix is skipped RAW (quotes there carry no meaning) and
    prefix-less lines are dropped whole."""
    toks = [t for t in {esc, enc, lt, ft} if t]
    pat = re.compile("|".join(re.escape(t)
                              for t in sorted(toks, key=len, reverse=True)))
    # longest token minus one, plus one char of escape/quote lookahead;
    # a straddling line prefix needs its own length of held-back tail
    hold = max(len(lt), len(ft), len(starting) + 1, 2) - 1
    buf = ""
    cur: list[str] = []
    in_enc = False
    field_start = True
    skipping = bool(starting)      # before the line prefix
    it = iter(chunks)
    final = False
    while True:
        if not final:
            try:
                buf += next(it)
            except StopIteration:
                final = True
        # tokens starting before `limit` always fit inside buf
        limit = len(buf) if final else max(len(buf) - hold, 0)
        i = 0
        while i < limit:
            if ignore_lines > 0:
                # IGNORE n LINES skips PHYSICAL lines — raw terminator
                # scan, before any prefix/enclosure semantics (MySQL's
                # READ_INFO::next_line does the same)
                l_ = buf.find(lt, i, limit + len(lt) - 1)
                if l_ < 0:
                    i = limit
                    break
                i = l_ + len(lt)
                ignore_lines -= 1
                continue
            if skipping:
                p = buf.find(starting, i, limit + len(starting) - 1)
                l_ = buf.find(lt, i, limit + len(lt) - 1)
                if 0 <= p and (l_ < 0 or p < l_):
                    i = p + len(starting)
                    skipping = False
                    field_start = True
                    continue
                if 0 <= l_:        # prefix-less line: drop it whole
                    i = l_ + len(lt)
                    continue
                i = limit          # no event yet: discard scanned text
                break
            m = pat.search(buf, i)
            if m is None or m.start() >= limit:
                if limit > i:
                    cur.append(buf[i:limit])
                    field_start = False
                i = limit
                break
            j = m.start()
            tok = m.group()
            if j > i:
                cur.append(buf[i:j])
                field_start = False
                i = j
            if esc and buf.startswith(esc, j):
                if j + len(esc) < len(buf):
                    cur.append(buf[j:j + len(esc) + 1])
                    i = j + len(esc) + 1
                    field_start = False
                    continue
                break              # lone escape at the end: literal tail
            if enc and tok == enc:
                if in_enc:
                    if j + len(enc) < len(buf) and \
                            buf.startswith(enc, j + len(enc)):
                        cur.append(enc + enc)   # doubled quote: literal
                        i = j + 2 * len(enc)
                        continue
                    in_enc = False
                elif field_start:
                    in_enc = True
                cur.append(enc)
                i = j + len(enc)
                field_start = False
                continue
            if in_enc:             # ft/lt inside an enclosure: literal
                cur.append(tok)
                i = j + len(tok)
                continue
            if ft and tok == ft:   # longer tokens win the alternation
                cur.append(ft)
                i = j + len(ft)
                field_start = True
                continue
            # tok == lt
            i = j + len(lt)
            yield "".join(cur)
            cur = []
            field_start = True
            skipping = bool(starting)
        buf = buf[i:]
        if final:
            break
    if not skipping and ignore_lines <= 0 and (cur or buf):
        cur.append(buf)
        yield "".join(cur)


def _split_fields(line: str, ft: str, enc: str, esc: str) -> list:
    """One logical line -> fields (None for escaped-N NULLs). Terminators
    inside enclosures or behind the escape char are literal."""
    fields: list = []
    cur: list[str] = []
    field_start, in_enc = True, False
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if esc and c == esc and i + 1 < n:
            cur.append(c)
            cur.append(line[i + 1])    # keep for _unescape (incl. \N)
            i += 2
            field_start = False
            continue
        if in_enc:
            if c == enc:
                if i + 1 < n and line[i + 1] == enc:   # doubled quote
                    cur.append(enc)
                    i += 2
                    continue
                in_enc = False
                i += 1
                continue
            cur.append(c)
            i += 1
            continue
        if field_start and enc and c == enc:
            in_enc = True
            field_start = False
            i += 1
            continue
        if line.startswith(ft, i):
            fields.append(_unescape("".join(cur), esc))
            cur = []
            field_start = True
            i += len(ft)
            continue
        cur.append(c)
        field_start = False
        i += 1
    fields.append(_unescape("".join(cur), esc))
    return fields


def parse_lines(text, stmt):
    """Split file text (a str, or an iterable of str chunks) into rows of
    fields (str, or None for \\N). Honors LINES STARTING/TERMINATED,
    FIELDS TERMINATED/ENCLOSED/ESCAPED and IGNORE n LINES.

    Regular single-byte-separator inputs scan through the native C++
    loader (native/loadscan.cc) with row-aligned fallback to this
    module's general scanner on anything irregular, counted by reason
    in SCAN_STATS."""
    lt = stmt.lines_terminated or "\n"
    ft = stmt.fields_terminated or "\t"
    enc = stmt.fields_enclosed
    esc = stmt.fields_escaped
    chunks = [text] if isinstance(text, str) else text
    if (len(lt.encode()) == 1 and len(ft.encode()) == 1 and
            len(enc.encode()) <= 1 and len(esc.encode()) <= 1 and
            enc != esc and not stmt.lines_starting):
        native = _parse_lines_native(chunks, stmt, lt, ft, enc, esc)
        if native is not None:
            yield from native
            return
        _note_fallback("unavailable")
    else:
        _note_fallback("separators")
    for line in _split_lines(chunks, lt, ft, enc, esc,
                             stmt.lines_starting or "",
                             stmt.ignore_lines):
        if not line:
            continue
        yield _split_fields(line, ft, enc, esc)


def _parse_lines_native(chunks, stmt, lt, ft, enc, esc):
    """Generator over rows via the C++ scanner, or None when the native
    library is unavailable. Streams with a row-aligned carry buffer;
    irregular remainders (and a stalled scan) run the general Python
    scanner instead."""
    from tidb_tpu_torch.native import scan_rows_native
    probe = scan_rows_native(b"", ft.encode(), lt.encode(),
                            enc.encode(), esc.encode(), 0)
    if probe is None:
        return None

    def gen():
        import itertools
        ftb, ltb = ft.encode(), lt.encode()
        encb, escb = enc.encode(), esc.encode()
        carry = b""
        ignore = stmt.ignore_lines
        it = iter(chunks)
        final = False
        while not final:
            chunk = next(it, None)
            if chunk is None:
                final = True
            else:
                carry += chunk.encode("utf8")
                if len(carry) < (1 << 16):
                    continue
            # IGNORE n LINES: strip physical lines in the buffer first
            while ignore > 0:
                at = carry.find(ltb)
                if at < 0:
                    break
                carry = carry[at + 1:]
                ignore -= 1
            if ignore > 0:
                if not final:
                    continue
                carry = b""       # the whole tail is an ignored line
                break
            if not carry:
                continue
            res = scan_rows_native(carry, ftb, ltb, encb, escb, 0,
                                   final_chunk=final)
            consumed, rowoff, fs, fe, fl = res
            if len(rowoff) > 1:
                _note_native(len(rowoff) - 1)
            for r in range(len(rowoff) - 1):
                lo, hi = int(rowoff[r]), int(rowoff[r + 1])
                if hi - lo == 1 and fs[lo] == fe[lo] and fl[lo] == 0:
                    continue       # empty line (matches the host scanner)
                fields = []
                for j in range(lo, hi):
                    if fl[j] & 4:
                        fields.append(None)
                        continue
                    sv = carry[int(fs[j]):int(fe[j])].decode(
                        "utf8", "replace")
                    if fl[j] & 2 and enc:
                        sv = sv.replace(enc + enc, enc)
                    if fl[j] & 1 and esc:
                        sv = _unescape(sv, esc)
                    fields.append(sv)
                yield fields
            if consumed == 0 and (final or len(carry) > (1 << 20)):
                # irregular head the C scanner cannot progress past:
                # the general scanner takes the whole remainder
                _note_fallback("irregular")
                rest = carry.decode("utf8", "replace")
                tail = itertools.chain(
                    [rest], (c for c in it if c is not None))
                for line in _split_lines(tail, lt, ft, enc, esc, "", 0):
                    if line:
                        yield _split_fields(line, ft, enc, esc)
                return
            carry = carry[consumed:]
        if carry:
            _note_fallback("irregular")
            for line in _split_lines([carry.decode("utf8", "replace")],
                                     lt, ft, enc, esc, "", 0):
                if line:
                    yield _split_fields(line, ft, enc, esc)

    return gen()


# a file repeats its date texts (a day per 2.4k rows of TPC-H lineitem):
# parse each text once; parse_datetime is a pure function of it
_parse_datetime = functools.lru_cache(maxsize=1 << 16)(parse_datetime)


def convert_fields(info, col_names: list[str], fields: list,
                   cols: list | None = None) -> dict:
    """One parsed row -> {col_name: value} with MySQL implicit casts.
    Extra fields are dropped, missing ones become NULL (MySQL warns).
    col_names must be lowercase (the schema's storage convention);
    `cols` are their ColumnInfos (`info.col_by_name` of each), looked up
    once per statement by a caller that passes them."""
    values: dict = {}
    if cols is None:
        cols = [info.col_by_name(c) for c in col_names]
    for cname, ci, s in zip(col_names, cols, fields):
        if ci is None:
            raise ExecError(f"unknown column '{cname}' in LOAD DATA")
        if s is None:
            values[cname] = None
            continue
        et = ci.ft.eval_type
        try:
            if et == EvalType.INT:
                try:
                    values[cname] = int(s)
                except ValueError:
                    values[cname] = int(float(s))   # '1.5' truncates
            elif et == EvalType.REAL:
                values[cname] = float(s)
            elif et == EvalType.DECIMAL:
                frac = max(ci.ft.frac, 0)
                scaled = int((Decimal(s) * (10 ** frac))
                             .to_integral_value(rounding="ROUND_HALF_UP"))
                values[cname] = (frac, scaled)
            elif et == EvalType.DATETIME:
                values[cname] = _parse_datetime(s)
            else:
                values[cname] = s
        except (ValueError, InvalidOperation):
            raise ExecError(
                f"incorrect value {s!r} for column '{cname}'") from None
    for cname in col_names[len(fields):]:
        values[cname] = None
    return values


def read_text_chunks(f, size: int = READ_CHUNK):
    """Bounded file reader feeding parse_lines."""
    while True:
        chunk = f.read(size)
        if not chunk:
            return
        yield chunk


class RowsInsert(Insert):
    """Insert over pre-materialized value dicts: LOAD DATA reuses the
    whole duplicate-key machinery (REPLACE / IGNORE) without a plan."""

    def __init__(self, info, rows, dup_mode: str):
        super().__init__(info, [], None, is_replace=(dup_mode == "replace"),
                         ignore=(dup_mode == "ignore"))
        self._rows = rows

    def _source_rows(self, ctx):
        return iter(self._rows)

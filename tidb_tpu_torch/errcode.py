"""MySQL error-code catalog and exception classification: the port of
the JAX package's errcode.py.

Reference: TiDB's mysql/errcode.go (the code constants),
mysql/errname.go, terror/terror.go:152 (error class -> MySQL code
mapping surfaced on the wire). The server's ERR packet carries
(errno, sqlstate, message); classify() maps the port's typed exceptions
onto the right pair so MySQL clients and drivers see standard codes
(1062 duplicate key, 1146 missing table, ...). It knows the port's own
exception classes: the session's SQLError, the executors' ExecError, the
KV errors (kv.RetryableError and its kin), memtrack's
QuotaExceededError and sched's AdmissionRejectedError. `not_ported`
gives the one message of the errors the port raises where it has no
counterpart of the reference's code path yet.
"""

from __future__ import annotations

import re

__all__ = ["classify", "is_retryable", "ER_UNKNOWN", "not_ported"]

# -- the catalog (ref: mysql/errcode.go; MySQL range 1xxx/3xxx plus the
# reference's own 8xxx planner/DDL and 9xxx storage ranges) ------------------

ER_DUP_ENTRY = 1062
ER_NO_SUCH_TABLE = 1146
ER_BAD_DB_ERROR = 1049
ER_DB_CREATE_EXISTS = 1007
ER_TABLE_EXISTS_ERROR = 1050
ER_PARSE_ERROR = 1064
ER_ACCESS_DENIED_ERROR = 1045
ER_TABLEACCESS_DENIED_ERROR = 1142
ER_BAD_FIELD_ERROR = 1054
ER_DUP_FIELDNAME = 1060
ER_DUP_KEYNAME = 1061
ER_CANNOT_USER = 1396
ER_NON_UNIQ_ERROR = 1052          # ambiguous column
ER_UNKNOWN_SYSTEM_VARIABLE = 1193
ER_LOCK_WAIT_TIMEOUT = 1205
ER_LOCK_DEADLOCK = 1213
ER_NO_DB_ERROR = 1046
ER_WRONG_VALUE_COUNT = 1136
ER_TRUNCATED_WRONG_VALUE = 1292
ER_DATA_TOO_LONG = 1406
ER_BAD_NULL_ERROR = 1048
ER_QUERY_INTERRUPTED = 1317
ER_NO_SUCH_THREAD = 1094
ER_UNKNOWN = 1105

# server / connection
ER_CON_COUNT_ERROR = 1040
ER_OUT_OF_RESOURCES = 1041
ER_ABORTING_CONNECTION = 1152
ER_NET_PACKET_TOO_LARGE = 1153
ER_NEW_ABORTING_CONNECTION = 1184
ER_TOO_MANY_USER_CONNECTIONS = 1203
ER_UNKNOWN_COM_ERROR = 1047

# schema / DDL
ER_BAD_TABLE_ERROR = 1051
ER_WRONG_DB_NAME = 1102
ER_WRONG_TABLE_NAME = 1103
ER_WRONG_COLUMN_NAME = 1166
ER_TOO_LONG_IDENT = 1059
ER_TOO_LONG_KEY = 1071
ER_TOO_MANY_FIELDS = 1117
ER_TOO_MANY_KEYS = 1069
ER_KEY_COLUMN_DOES_NOT_EXITS = 1072
ER_WRONG_AUTO_KEY = 1075
ER_PRIMARY_CANT_HAVE_NULL = 1171
ER_CANT_DROP_FIELD_OR_KEY = 1091
ER_KEY_DOES_NOT_EXIST = 1176
ER_TABLE_MUST_HAVE_COLUMNS = 1113
ER_BLOB_USED_AS_KEY = 1073
ER_TOO_BIG_FIELDLENGTH = 1074
ER_INVALID_DEFAULT = 1067
ER_MULTIPLE_PRI_KEY = 1068
ER_TOO_BIG_PRECISION = 1426
ER_TOO_BIG_SCALE = 1425
ER_TOO_BIG_DISPLAYWIDTH = 1439
ER_UNSUPPORTED_DDL_OPERATION = 8200

# planner / resolver
ER_EMPTY_QUERY = 1065
ER_NONUNIQ_TABLE = 1066
ER_WRONG_FIELD_WITH_GROUP = 1055
ER_INVALID_GROUP_FUNC_USE = 1111
ER_MIX_OF_GROUP_FUNC_AND_FIELDS = 1140
ER_FIELD_SPECIFIED_TWICE = 1110
ER_OPERAND_COLUMNS = 1241
ER_SUBQUERY_NO_1_ROW = 1242
ER_ILLEGAL_REFERENCE = 1247
ER_DERIVED_MUST_HAVE_ALIAS = 1248
ER_TABLENAME_NOT_ALLOWED_HERE = 1250
ER_NOT_SUPPORTED_YET = 1235
ER_UNKNOWN_PROCEDURE = 1305
ER_WRONG_PARAMCOUNT_TO_PROCEDURE = 1318

# values / types
ER_DIVISION_BY_ZERO = 1365
ER_WARN_DATA_OUT_OF_RANGE = 1264
ER_DATA_OUT_OF_RANGE = 1690
ER_TRUNCATED_WRONG_VALUE_FOR_FIELD = 1366
ER_NO_DEFAULT_FOR_FIELD = 1364
ER_WARN_NULL_TO_NOTNULL = 1263
ER_INVALID_USE_OF_NULL = 1138
ER_UNKNOWN_CHARACTER_SET = 1115
ER_UNKNOWN_COLLATION = 1273
ER_WRONG_VALUE_FOR_VAR = 1231
ER_GLOBAL_VARIABLE = 1229
ER_LOCAL_VARIABLE = 1228
ER_INCORRECT_GLOBAL_LOCAL_VAR = 1238

# prepared statements / transactions
ER_UNKNOWN_STMT_HANDLER = 1243
ER_NEED_REPREPARE = 1615
ER_MAX_PREPARED_STMT_COUNT_REACHED = 1461
ER_READ_ONLY_TRANSACTION = 1207
ER_CANT_CHANGE_TX_CHARACTERISTICS = 1568
ER_SPECIFIC_ACCESS_DENIED = 1227

# storage / distributed (the reference's own 9xxx range, terror.go):
# every one of these is RETRYABLE at the client — the statement may be
# re-run verbatim once the cluster heals
ER_PD_SERVER_TIMEOUT = 9001
ER_TIKV_SERVER_TIMEOUT = 9002
ER_TIKV_SERVER_BUSY = 9003
ER_RESOLVE_LOCK_TIMEOUT = 9004
ER_REGION_UNAVAILABLE = 9005
ER_GC_TOO_EARLY = 9006
# region-stream-interrupted: a streamed coprocessor reply died
# mid-region and exhausted its resume budget (store/stream.py); same
# retryable class as region unavailability
ER_REGION_STREAM_INTERRUPTED = 9007
# statement refused at admission (tidb_tpu/sched.py): the server sits
# over tidb_tpu_server_mem_quota, the shed chain freed too little, and
# the bounded queue wait expired. RETRYABLE like ER_TIKV_SERVER_BUSY —
# nothing ran, the session and its transaction are untouched, a
# verbatim replay after backoff is always safe
ER_SERVER_BUSY_ADMISSION = 9008
# device-plane fault (tidb_tpu/util/failpoint.py DeviceFaultError): a
# kernel dispatch/finalize, HBM cache fill/patch failed or tripped the
# dispatch watchdog (tidb_tpu_dispatch_timeout_ms). RETRYABLE — the
# statement was cancelled before producing anything partial, its
# scheduler slots and device-ledger bytes were released, and the
# recovery chain (host fallback, device quarantine + re-probe) means a
# verbatim replay lands on a working path
ER_DEVICE_FAULT = 9009
# store-plane member unreachable (kv.StoreUnavailableError: the node a
# fleet SQL server dialed is down/partitioned). RETRYABLE — nothing of
# the statement's effect is ambiguous (connection-level failure before
# a response); a verbatim replay after the client re-routes is safe
ER_STORE_UNAVAILABLE = 9010
# commit outcome unknown (network error on the primary commit,
# 2pc.go:421-431): NOT retryable — the write may have landed, so a
# verbatim replay risks applying it twice
ER_RESULT_UNDETERMINED = 8501

# per-statement memory quota exceeded with no spill action left
# (memtrack.py; ref: the reference's "Out Of Memory Quota!" cancel in
# its executor 8xxx range): the query was cancelled, the session lives
ER_MEM_EXCEED_QUOTA = 8175

# codes a client may retry verbatim after backoff (the reference's
# terror retryable classes + lock waits/deadlocks)
RETRYABLE = frozenset({
    ER_LOCK_WAIT_TIMEOUT, ER_LOCK_DEADLOCK, ER_NEED_REPREPARE,
    ER_PD_SERVER_TIMEOUT, ER_TIKV_SERVER_TIMEOUT, ER_TIKV_SERVER_BUSY,
    ER_RESOLVE_LOCK_TIMEOUT, ER_REGION_UNAVAILABLE,
    ER_REGION_STREAM_INTERRUPTED, ER_SERVER_BUSY_ADMISSION,
    ER_DEVICE_FAULT, ER_STORE_UNAVAILABLE,
})


def is_retryable(errno: int) -> bool:
    """True when a MySQL client may safely re-issue the statement."""
    return errno in RETRYABLE


_SQLSTATE = {
    ER_DUP_ENTRY: "23000",
    ER_BAD_NULL_ERROR: "23000",
    ER_QUERY_INTERRUPTED: "70100",
    ER_NO_SUCH_THREAD: "HY000",
    ER_NO_SUCH_TABLE: "42S02",
    ER_BAD_DB_ERROR: "42000",
    ER_DB_CREATE_EXISTS: "HY000",
    ER_TABLE_EXISTS_ERROR: "42S01",
    ER_PARSE_ERROR: "42000",
    ER_ACCESS_DENIED_ERROR: "28000",
    ER_TABLEACCESS_DENIED_ERROR: "42000",
    ER_BAD_FIELD_ERROR: "42S22",
    ER_DUP_FIELDNAME: "42S21",
    ER_DUP_KEYNAME: "42000",
    ER_CANNOT_USER: "HY000",
    ER_NON_UNIQ_ERROR: "23000",
    ER_UNKNOWN_SYSTEM_VARIABLE: "HY000",
    ER_LOCK_WAIT_TIMEOUT: "HY000",
    ER_LOCK_DEADLOCK: "40001",
    ER_NO_DB_ERROR: "3D000",
    ER_WRONG_VALUE_COUNT: "21S01",
    ER_TRUNCATED_WRONG_VALUE: "22007",
    ER_DATA_TOO_LONG: "22001",
    ER_UNKNOWN: "HY000",
    # server / connection
    ER_CON_COUNT_ERROR: "08004",
    ER_OUT_OF_RESOURCES: "08004",
    ER_ABORTING_CONNECTION: "08S01",
    ER_NET_PACKET_TOO_LARGE: "08S01",
    ER_NEW_ABORTING_CONNECTION: "08S01",
    ER_TOO_MANY_USER_CONNECTIONS: "42000",
    ER_UNKNOWN_COM_ERROR: "08S01",
    # schema / DDL
    ER_BAD_TABLE_ERROR: "42S02",
    ER_WRONG_DB_NAME: "42000",
    ER_WRONG_TABLE_NAME: "42000",
    ER_WRONG_COLUMN_NAME: "42000",
    ER_TOO_LONG_IDENT: "42000",
    ER_TOO_LONG_KEY: "42000",
    ER_TOO_MANY_FIELDS: "42000",
    ER_TOO_MANY_KEYS: "42000",
    ER_KEY_COLUMN_DOES_NOT_EXITS: "42000",
    ER_WRONG_AUTO_KEY: "42000",
    ER_PRIMARY_CANT_HAVE_NULL: "42000",
    ER_CANT_DROP_FIELD_OR_KEY: "42000",
    ER_KEY_DOES_NOT_EXIST: "42000",
    ER_TABLE_MUST_HAVE_COLUMNS: "42000",
    ER_BLOB_USED_AS_KEY: "42000",
    ER_TOO_BIG_FIELDLENGTH: "42000",
    ER_INVALID_DEFAULT: "42000",
    ER_MULTIPLE_PRI_KEY: "42000",
    ER_TOO_BIG_PRECISION: "42000",
    ER_TOO_BIG_SCALE: "42000",
    ER_TOO_BIG_DISPLAYWIDTH: "42000",
    ER_UNSUPPORTED_DDL_OPERATION: "HY000",
    # planner / resolver
    ER_EMPTY_QUERY: "42000",
    ER_NONUNIQ_TABLE: "42000",
    ER_WRONG_FIELD_WITH_GROUP: "42000",
    ER_INVALID_GROUP_FUNC_USE: "HY000",
    ER_MIX_OF_GROUP_FUNC_AND_FIELDS: "42000",
    ER_FIELD_SPECIFIED_TWICE: "42000",
    ER_OPERAND_COLUMNS: "21000",
    ER_SUBQUERY_NO_1_ROW: "21000",
    ER_ILLEGAL_REFERENCE: "42S22",
    ER_DERIVED_MUST_HAVE_ALIAS: "42000",
    ER_TABLENAME_NOT_ALLOWED_HERE: "42000",
    ER_NOT_SUPPORTED_YET: "42000",
    ER_UNKNOWN_PROCEDURE: "42000",
    ER_WRONG_PARAMCOUNT_TO_PROCEDURE: "42000",
    # values / types
    ER_DIVISION_BY_ZERO: "22012",
    ER_WARN_DATA_OUT_OF_RANGE: "22003",
    ER_DATA_OUT_OF_RANGE: "22003",
    ER_TRUNCATED_WRONG_VALUE_FOR_FIELD: "HY000",
    ER_NO_DEFAULT_FOR_FIELD: "HY000",
    ER_WARN_NULL_TO_NOTNULL: "22004",
    ER_INVALID_USE_OF_NULL: "22004",
    ER_UNKNOWN_CHARACTER_SET: "42000",
    ER_UNKNOWN_COLLATION: "HY000",
    ER_WRONG_VALUE_FOR_VAR: "42000",
    ER_GLOBAL_VARIABLE: "HY000",
    ER_LOCAL_VARIABLE: "HY000",
    ER_INCORRECT_GLOBAL_LOCAL_VAR: "HY000",
    # prepared statements / transactions
    ER_UNKNOWN_STMT_HANDLER: "HY000",
    ER_NEED_REPREPARE: "HY000",
    ER_MAX_PREPARED_STMT_COUNT_REACHED: "42000",
    ER_READ_ONLY_TRANSACTION: "25000",
    ER_CANT_CHANGE_TX_CHARACTERISTICS: "25001",
    ER_SPECIFIC_ACCESS_DENIED: "42000",
    # storage / distributed
    ER_PD_SERVER_TIMEOUT: "HY000",
    ER_TIKV_SERVER_TIMEOUT: "HY000",
    ER_TIKV_SERVER_BUSY: "HY000",
    ER_RESOLVE_LOCK_TIMEOUT: "HY000",
    ER_REGION_UNAVAILABLE: "HY000",
    ER_GC_TOO_EARLY: "HY000",
    ER_REGION_STREAM_INTERRUPTED: "HY000",
    ER_SERVER_BUSY_ADMISSION: "HY000",
    ER_DEVICE_FAULT: "HY000",
    ER_STORE_UNAVAILABLE: "HY000",
    ER_RESULT_UNDETERMINED: "HY000",
    ER_MEM_EXCEED_QUOTA: "HY000",
}

# message-shape fallbacks for SQLError strings raised deep in the stack
_PATTERNS = [
    (re.compile(r"Unknown database", re.I), ER_BAD_DB_ERROR),
    (re.compile(r"doesn't exist|Unknown table", re.I), ER_NO_SUCH_TABLE),
    (re.compile(r"database '[^']*' (already )?exists", re.I),
     ER_DB_CREATE_EXISTS),
    (re.compile(r"index '[^']*' (already )?exists", re.I), ER_DUP_KEYNAME),
    (re.compile(r"column '[^']*' (already )?exists", re.I),
     ER_DUP_FIELDNAME),
    (re.compile(r"user .* (already )?exists", re.I), ER_CANNOT_USER),
    (re.compile(r"(already )?exists", re.I), ER_TABLE_EXISTS_ERROR),
    (re.compile(r"Unknown column", re.I), ER_BAD_FIELD_ERROR),
    (re.compile(r"ambiguous", re.I), ER_NON_UNIQ_ERROR),
    (re.compile(r"denied", re.I), ER_TABLEACCESS_DENIED_ERROR),
    (re.compile(r"Unknown system variable|unknown variable", re.I),
     ER_UNKNOWN_SYSTEM_VARIABLE),
    (re.compile(r"is a GLOBAL variable", re.I), ER_GLOBAL_VARIABLE),
    (re.compile(r"No database selected", re.I), ER_NO_DB_ERROR),
    (re.compile(r"parameter count|column count", re.I),
     ER_WRONG_VALUE_COUNT),
    (re.compile(r"cannot be null", re.I), ER_BAD_NULL_ERROR),
    # memory quota before the generic "interrupted" net: the OOM cancel
    # rides the cooperative-kill path but must keep its own code
    (re.compile(r"Out Of Memory Quota", re.I), ER_MEM_EXCEED_QUOTA),
    # device-fault/watchdog cancels ride the same cooperative-kill path
    # and must keep their retryable 9009 — matched before "interrupted"
    (re.compile(r"device fault|dispatch watchdog", re.I),
     ER_DEVICE_FAULT),
    (re.compile(r"interrupted", re.I), ER_QUERY_INTERRUPTED),
    (re.compile(r"Unknown thread id", re.I), ER_NO_SUCH_THREAD),
    (re.compile(r"incorrect value", re.I), ER_TRUNCATED_WRONG_VALUE),
    (re.compile(r"division by zero|divide by zero", re.I),
     ER_DIVISION_BY_ZERO),
    (re.compile(r"Unknown collation", re.I), ER_UNKNOWN_COLLATION),
    (re.compile(r"Unknown character set|unknown charset", re.I),
     ER_UNKNOWN_CHARACTER_SET),
    (re.compile(r"returns more than 1 row", re.I), ER_SUBQUERY_NO_1_ROW),
    (re.compile(r"out of range", re.I), ER_DATA_OUT_OF_RANGE),
    (re.compile(r"not supported|unsupported", re.I), ER_NOT_SUPPORTED_YET),
    (re.compile(r"Unknown prepared statement", re.I),
     ER_UNKNOWN_STMT_HANDLER),
    (re.compile(r"Region is unavailable", re.I), ER_REGION_UNAVAILABLE),
]


def _is_sql_layer(exc: BaseException) -> bool:
    from tidb_tpu_torch import kv
    from tidb_tpu_torch.executor import ExecError
    from tidb_tpu_torch.session import SQLError
    return isinstance(exc, (SQLError, ExecError, kv.KVError))


def _is_admission_reject(exc: BaseException) -> bool:
    from tidb_tpu_torch.sched import AdmissionRejectedError
    return isinstance(exc, AdmissionRejectedError)


def _is_quota_exceeded(exc: BaseException) -> bool:
    from tidb_tpu_torch.memtrack import QuotaExceededError
    return isinstance(exc, QuotaExceededError)


def _is_device_fault(exc: BaseException) -> bool:
    from tidb_tpu_torch.util.failpoint import DeviceFaultError
    return isinstance(exc, DeviceFaultError)


def classify(exc: BaseException) -> tuple[int, str, str]:
    """exception -> (errno, sqlstate, message) for the wire ERR packet."""
    from tidb_tpu_torch import kv
    from tidb_tpu_torch.parser import ParseError
    from tidb_tpu_torch.schema.infoschema import SchemaError
    from tidb_tpu_torch.table import DupKeyError

    msg = str(exc)
    code = None
    if isinstance(exc, DupKeyError):
        code = ER_DUP_ENTRY
    elif isinstance(exc, ParseError):
        code = ER_PARSE_ERROR
        msg = f"You have an error in your SQL syntax; {msg}"
    elif isinstance(exc, SchemaError):
        # infoschema raises exactly "Unknown database '<db>'" for a bad
        # db; anything else is a missing table (whose NAME may contain
        # the word "database")
        code = ER_BAD_DB_ERROR if msg.startswith("Unknown database") \
            else ER_NO_SUCH_TABLE
    elif isinstance(exc, kv.KeyLockedError):
        code = ER_LOCK_WAIT_TIMEOUT
    elif isinstance(exc, kv.WriteConflictError):
        code = ER_LOCK_DEADLOCK
    elif _is_quota_exceeded(exc):
        code = ER_MEM_EXCEED_QUOTA
    elif _is_admission_reject(exc):
        # refused BEFORE anything ran (tidb_tpu/sched.py): retryable
        # server-busy class, same contract as ER_TIKV_SERVER_BUSY
        code = ER_SERVER_BUSY_ADMISSION
    elif _is_device_fault(exc):
        # device-plane fault past the in-process recovery chain
        # (retry/fallback/quarantine, tidb_tpu/sched.py): retryable —
        # a replay lands on the host path or a re-probed device
        code = ER_DEVICE_FAULT
    elif isinstance(exc, kv.StreamInterruptedError):
        # streamed coprocessor reply died past its resume budget: the
        # retryable region-stream class (store/stream.py subsystem)
        code = ER_REGION_STREAM_INTERRUPTED
    elif isinstance(exc, kv.StoreUnavailableError):
        # before the generic RegionError arm: StoreUnavailableError IS
        # a RegionError, but a dead store-plane member deserves its own
        # retryable code (fleet clients re-route on it)
        code = ER_STORE_UNAVAILABLE
    elif isinstance(exc, kv.RegionError):
        code = ER_REGION_UNAVAILABLE
    elif isinstance(exc, kv.ServerBusyError):
        code = ER_TIKV_SERVER_BUSY
    elif isinstance(exc, kv.GCTooEarlyError):
        code = ER_GC_TOO_EARLY
    elif isinstance(exc, kv.UndeterminedError):
        # commit may or may not have landed: must NOT look retryable
        code = ER_RESULT_UNDETERMINED
    elif isinstance(exc, kv.TxnAbortedError):
        code = ER_TIKV_SERVER_TIMEOUT
    else:
        try:
            from tidb_tpu_torch.config import UnknownVariableError
            if isinstance(exc, UnknownVariableError):
                code = ER_UNKNOWN_SYSTEM_VARIABLE
                msg = f"Unknown system variable '{msg}'"
        except ImportError:
            pass
    if code is None and _is_sql_layer(exc):
        # message patterns apply ONLY to SQL-layer errors; an arbitrary
        # internal exception must surface as ER_UNKNOWN ("internal
        # error"), never masquerade as a user mistake
        for pat, c in _PATTERNS:
            if pat.search(msg):
                code = c
                break
    if code is None:
        code = ER_UNKNOWN
    return code, _SQLSTATE.get(code, "HY000"), msg


def not_ported(what: str) -> str:
    """The message of the error the port raises where it has no
    counterpart of the reference's code path yet."""
    return f"{what} is not ported yet"

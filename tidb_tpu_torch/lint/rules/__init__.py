"""Rule catalog: importing this package registers every rule, in the
order CI reports them — the JAX package's catalog, in its order: four
ported from the original standalone test walkers, twelve
project-specific additions, three whole-program flow rules built on
tidb_tpu_torch/lint/flow (call graph + lock registry over the same
shared parse), and three device-plane dataflow rules built on
tidb_tpu_torch/lint/flow/device (kernel-site discovery over that same
parse). The device rules match torch; inplace-safety takes the place
of the reference's donation-safety."""

from tidb_tpu_torch.lint.rules import (  # noqa: F401  (import == register)
    wire,        # wire-discipline
    sync,        # hot-path-sync / device-sync
    metrics,     # metric-names / metric-cardinality
    memtrack,    # memtrack-alloc
    locks,       # lock-discipline
    sysvars,     # sysvar-registry
    errcodes,    # errcode-discipline
    dtypes,      # dtype-discipline
    excepts,     # bare-except
    devcache,    # device-cache
    decode,      # decode-discipline (encoded execution stays encoded)
    failpoints,  # failpoint-discipline (fault-injection registry)
    planeimports,  # no-parallel-import (unified device plane only)
    tracenames,  # trace-names       (statement-trace span vocabulary)
    lockorder,   # lock-order        (flow: acquisition-order cycles)
    guardedby,   # guarded-by        (flow: annotated shared state)
    pairres,     # paired-resource   (flow: consume/release, dispatch/
    #              finalize balance)
    device,      # inplace-safety / cache-key / retrace-hazard
)                # (flow: device-plane dataflow)

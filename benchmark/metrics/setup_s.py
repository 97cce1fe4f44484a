"""setup_s: seconds from the run's process start to the window's start:
imports, the kernel build (a checkout's first run), the data from the
seed, DDL, bulk load and pre-split, the server and the load process,
and the mix warmed."""


def read(r):
    return r.setup_s

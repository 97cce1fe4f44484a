"""h2d_bytes_per_row: host-to-device bytes in the window (the program's
ops/runtime.put_bytes counter) over the base-table rows of the analytic
statements completed in it."""


def read(r):
    return r.h2d_bytes / r.input_rows if r.input_rows else None

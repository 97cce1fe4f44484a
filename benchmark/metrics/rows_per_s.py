"""rows_per_s: the base-table rows (reference/<dataset>/<statement>.py's
BASE_TABLE, at its loaded row count) of every analytic statement
answered right within the window, over the window's seconds."""


def read(r):
    return r.input_rows / r.window_s if r.window_s else None

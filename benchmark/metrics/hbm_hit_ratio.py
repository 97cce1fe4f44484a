"""hbm_hit_ratio: the HBM block cache's hits over hits and misses in
the window, in percent, from the program's counters
(store/device_cache.py)."""


def read(r):
    hits = r.counters["tidb_tpu_hbm_cache_hits_total"]
    misses = r.counters["tidb_tpu_hbm_cache_misses_total"]
    return 100.0 * hits / (hits + misses) if hits + misses else None

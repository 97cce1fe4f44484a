"""segsum_roofline: the segment-sum kernel (csrc/segsum.cu) against the
card's HBM bandwidth, in percent: the least time its launches in the
window could take (the bytes each needs, yardstick.segsum_bytes, from
the shapes the program counts its launches under, over the data sheet's
bytes/s) over the kernel's device time in the profiler trace."""

from benchmark.yardstick import HBM_PEAK_BYTES_PER_S, segsum_bytes


def read(r):
    if r.device_ops is None:
        return None
    kernel_ns = sum(e - s for n, s, e in r.device_ops if "segsum" in n)
    peak = HBM_PEAK_BYTES_PER_S.get(r.card.split(",")[0])
    if not kernel_ns or not peak or not r.segsum_shapes:
        return None
    need = sum(segsum_bytes(shape) * n for shape, n in
               r.segsum_shapes.items())
    return 100.0 * (need / peak) / (kernel_ns / 1e9)

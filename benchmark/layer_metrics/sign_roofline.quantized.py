"""The Hamming stage's least time per call (roofline_quantized.hamming) as
a share of the time per call that its kernels ran on cuda:0 (profiler
trace), %: K6, the sign scan (``SignEpilogue``), and K7, the group rows
(``extract_rows_kernel``); None where the trace holds neither."""

from benchmark.roofline_quantized import hamming

#: K6 and K7, by a part of their names in the trace
KERNELS = ("SignEpilogue", "extract_rows_kernel")


def read(run):
    t = run.trace
    if t is None or t["calls"] == 0:
        return None
    ops = t["ops_by_card"].get(0, {})
    seconds = sum(sec for name, sec in ops.items() if any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    s = run.shape
    least, _by = hamming(s["batch"], s["rows_per_card"], s["dims"])
    return 100.0 * least / (seconds / t["calls"])

"""ms per call that the quantized generator's kernels ran on cuda:0
(profiler trace): K6, the sign scan (``vt_sign_scan``, the tensor-core
scan skeleton with ``SignEpilogue``), and K7, the group rows
(``extract_rows_kernel``); None where the trace holds neither."""

#: K6 and K7, by a part of their names in the trace
KERNELS = ("SignEpilogue", "extract_rows_kernel")


def read(run):
    t = run.trace
    if t is None or t["calls"] == 0:
        return None
    ops = t["ops_by_card"].get(0, {})
    seconds = sum(sec for name, sec in ops.items() if any(k in name for k in KERNELS))
    return 1e3 * seconds / t["calls"] if seconds > 0 else None

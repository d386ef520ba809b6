"""The quantized call's least time (roofline_quantized.least_call) as a
share of the host-clock time per call in the measured window, %: the whole
call's share of the card's peak."""

from benchmark.roofline_quantized import least_call


def read(run):
    calls = len(run.latencies_s)
    if calls == 0 or run.window_s <= 0:
        return None
    s = run.shape
    least, _by = least_call(s["batch"], s["rows_per_card"], s["dims"], s["candidates"])
    return 100.0 * least / (run.window_s / calls)

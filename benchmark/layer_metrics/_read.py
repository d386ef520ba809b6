"""What the per-layer readers share: host spans per call, and device time
from the traced window."""

from __future__ import annotations

from benchmark import roofline


def span_ms(run, name: str):
    """Mean ms per call of span ``name`` in the measured window."""
    if name not in run.spans:
        return None
    seconds, calls = run.spans[name]
    return 1e3 * seconds / calls


def outside_ms(run, outer: str, inner: str):
    """Mean ms per call of span ``outer`` outside span ``inner``."""
    if outer not in run.spans or inner not in run.spans:
        return None
    return 1e3 * (run.spans[outer][0] - run.spans[inner][0]) / run.spans[outer][1]


def _busy(run):
    t = run.trace
    if t is None or not t["busy_by_card"] or t["calls"] == 0:
        return None
    return t["busy_by_card"]


#: the exact scan's kernels, by a part of their names in the trace: K1
#: (``wgmma_scan.cuh``) and K2 (``group_rescore.cuh``)
SCAN_KERNELS = ("wg::scan_kernel<", "gr::group_rescore<")


def _least_scan_s(run) -> float:
    s = run.shape
    least, _by = roofline.exact_scan(s["batch"], s["rows_per_card"], s["dims"], s["k"],
                                     s["elem_bytes"])
    return least


def scan_roofline(run):
    """The least time of the exact scan of one call on one card, as a share
    (%) of the time per call that the scan's kernels (``SCAN_KERNELS``) ran
    on the card where they ran longest; None where the trace holds none of
    them."""
    t = run.trace
    if t is None or t["calls"] == 0:
        return None
    scan = [sum(sec for name, sec in ops.items() if any(k in name for k in SCAN_KERNELS))
            for ops in t["ops_by_card"].values()]
    if not scan or max(scan) <= 0:
        return None
    return 100.0 * _least_scan_s(run) / (max(scan) / t["calls"])


def step_mfu(run):
    """The least time of the exact scan of one call on one card, as a share
    (%) of the host-clock time per call in the measured window: the whole
    call's share of the card's peak (every card's, on a mesh, whose cards
    scan in parallel)."""
    calls = len(run.latencies_s)
    if calls == 0 or run.window_s <= 0:
        return None
    return 100.0 * _least_scan_s(run) / (run.window_s / calls)


def idle_pct(run, card: int | None = 0):
    """The share (%) of the traced window in which card ``card`` ran no
    operation; with ``card`` None, the mean over the cards used."""
    busy = _busy(run)
    if busy is None:
        return None
    window = run.trace["window_s"]
    if card is None:
        return 100.0 * sum(1 - b / window for b in busy.values()) / len(busy)
    if card not in busy:
        return None
    return 100.0 * (1 - busy[card] / window)

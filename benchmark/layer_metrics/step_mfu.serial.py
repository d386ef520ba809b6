"""The exact scan's least time per call (roofline.exact_scan) as a share
of the host-clock time per call in the measured window, %: the whole
call's share of the card's peak."""

from benchmark.layer_metrics._read import step_mfu


def read(run):
    return step_mfu(run)

"""The exact scan's least time per call (roofline.exact_scan) as a share
of the time per call that its kernels, K1 and K2, ran on the busiest card
(profiler trace), %."""

from benchmark.layer_metrics._read import scan_roofline


def read(run):
    return scan_roofline(run)

"""Share of the traced window in which cuda:0 ran no operation, %."""

from benchmark.layer_metrics._read import idle_pct


def read(run):
    return idle_pct(run, 0)

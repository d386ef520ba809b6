"""Each card's idle share of the traced window, the mean over the cards, %."""

from benchmark.layer_metrics._read import idle_pct


def read(run):
    return idle_pct(run, None)

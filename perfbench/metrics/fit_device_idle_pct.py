"""Share of the traced window with no kernel and no copy on the card
(device trace)."""

from perfbench.metrics._device import idle_pct


def read(run):
    return idle_pct(run)

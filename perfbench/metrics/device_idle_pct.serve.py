"""100 x (1 - the union of the card's activity / the traced window)."""

from perfbench.harness.readers import idle_pct as read  # noqa: F401

"""The device's idle share of the traced stretch of a stepping cell
(``readers.idle_pct``)."""

from portbench.readers import idle_pct as read  # noqa: F401

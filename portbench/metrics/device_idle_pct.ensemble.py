"""The device's idle share of the traced stretch of an ensemble served
through the forecast server (``readers.idle_pct``)."""

from portbench.readers import idle_pct as read  # noqa: F401

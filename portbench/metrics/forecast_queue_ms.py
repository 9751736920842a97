"""``serve.forecast``'s queueing: the mean, over the forecasts dispatched in
the traced stretch, of the server's own stamp ``queue_latency_s`` (from
``submit`` to the dispatch of its batch), in milliseconds."""


def read(t):
    waits = t.layer.get("queue_s") or []
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)

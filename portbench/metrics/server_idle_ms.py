"""``serve.forecast``'s own host work, as the device sees it: device-idle
milliseconds a cycle inside the program's ``serve.forecast.step`` spans and
outside its ``health.probe`` spans (admission, the stack, the batched
call's enqueue, the wait, the unstack and the stamps;
``spans.Spans.idle_s``). With ``probe_idle_ms`` it splits the stretch's
idle time; the rest lies outside any step, on the client's side. None where
the program opens no such span or the device ran nothing."""

from portbench import spans

STEP, PROBE = "serve.forecast.step", "health.probe"


def read(t):
    s = spans.of(t)
    if not s.count(STEP) or s.busy_s <= 0:
        return None
    return spans.per_unit(t, s.idle_s(STEP, exclude=(PROBE,)), 1e3)

"""The device's idle share of the traced window, in %: one minus the
union of its operations' intervals in the profiler's trace over the
window's length."""


def read(t):
    tr = t.get("trace")
    if not tr or not tr["busy_s"]:
        return None
    return (1 - tr["busy_s"] / tr["window_s"]) * 100

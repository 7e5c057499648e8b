"""The training collection's time per iteration (``Trainer.collect``, its
end waiting for the device): the mean of the benchmark's
``trainer.collect`` span over the window's calls, in ms (host clock)."""


def read(t):
    spans = t["spans"].get("trainer.collect")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1000

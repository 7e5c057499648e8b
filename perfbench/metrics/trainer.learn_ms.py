"""The learning half's time per iteration (``Trainer.learn``: values, GAE,
Welford and the PPO update; its end waiting for the device): the mean of
the benchmark's ``trainer.learn`` span over the window's calls, in ms
(host clock)."""


def read(t):
    spans = t["spans"].get("trainer.learn")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1000

"""Metric report: aggregation and console display (GigaLearnCPP/Util/
Report.{h,cpp}): a key -> float map with averaging helpers and a
formatted console block.  The JAX package's module has no JAX in it; this
is the port's own copy.
"""

from __future__ import annotations


def _fmt(v: float) -> str:
    if abs(v) >= 1e6:
        return f"{v:,.0f}"
    if abs(v) >= 100:
        return f"{v:,.1f}"
    return f"{v:.4f}"


class Report:
    def __init__(self, values: dict | None = None):
        self.values: dict[str, float] = dict(values or {})
        self._avg_accum: dict[str, tuple[float, int]] = {}

    def __setitem__(self, key: str, value: float):
        self.values[key] = float(value)

    def __getitem__(self, key: str) -> float:
        return self.values[key]

    def __contains__(self, key):
        return key in self.values

    def add_avg(self, key: str, value: float):
        """Accumulate an average (reference Report::AddAvg/Finish)."""
        total, n = self._avg_accum.get(key, (0.0, 0))
        self._avg_accum[key] = (total + float(value), n + 1)

    def finish(self):
        for key, (total, n) in self._avg_accum.items():
            self.values[key] = total / max(n, 1)
        self._avg_accum.clear()
        return self

    def display(self, indent: str = "  ") -> str:
        self.finish()
        width = max((len(k) for k in self.values), default=0)
        lines = [f"{indent}{k.ljust(width)}  {_fmt(v)}"
                 for k, v in sorted(self.values.items())]
        return "\n".join(lines)

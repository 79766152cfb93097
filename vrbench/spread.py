#!/usr/bin/env python3
"""Medians and spreads of runs, the readings a bound is set from.

    python3 vrbench/spread.py RUN.out ...

Each file holds one run's standard output, its result the last line; runs
group by the file's name without its last two dot-separated parts (so
``hdr10_1080.b16.A.3.out`` is run 3 of set A of the cell).  For each group
and metric it prints the runs' values, the median and the spread, (Q3 -
Q1) / median with ``statistics.quantiles(values, n=4)``'s quartiles, and
``correct`` over the group."""

from __future__ import annotations

import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(HERE))

from vrbench import stats  # noqa: E402


def main(paths) -> int:
    groups: dict = {}
    for path in paths:
        with open(path, encoding="utf-8") as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        group = os.path.basename(path).rsplit(".", 2)[0]
        groups.setdefault(group, []).append(json.loads(lines[-1]))
    for group, runs in sorted(groups.items()):
        values: dict = {}
        for r in runs:
            for name, m in r["metrics"].items():
                values.setdefault(name, []).append(m["value"])
        for name, xs in sorted(values.items()):
            print(json.dumps({"group": group, "metric": name, "values": xs,
                              "median": statistics.median(xs),
                              "spread": stats.spread(xs) if len(xs) > 1
                              else None}))
        print(json.dumps({"group": group, "runs": len(runs),
                          "correct": [r["correct"] for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

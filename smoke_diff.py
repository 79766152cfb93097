#!/usr/bin/env python3
"""Compares ``chip_smoke.py`` runs of two trees made on the same inputs:
their output digests, every accuracy figure, and the times.

    python3 smoke_diff.py --base PARENT.log [...] --new CHANGE.log [...]

Each log is the standard output of one ``python3 chip_smoke.py`` run (its
JSON lines; other lines are skipped).  The runs of one side must agree among
themselves on digests and accuracy (the inputs are seeded).  Prints JSON
lines:
  * ``digests``: every key with "digest" in its name, equal or not between
    the first base run and each new run (equal exactly when the outputs are
    bit-equal);
  * ``accuracy``: every PSNR, kernel-vs-plain error, code difference and
    bit-equality flag, equal or not;
  * ``kernels``: for each entry of the kernels line, its time in every run,
    the mean of each side and new / base;
  * ``times``: the same for every other time a phase prints (keys ending in
    ``ms``, ``ms_per_frame``, ``ms_per_field`` ...).
Exits 1 when a digest or an accuracy figure differs.
"""

from __future__ import annotations

import argparse
import json
import sys

ACCURACY = ("psnr", "err", "code_diff", "frac_differing", "bit_equal",
            "alpha_ok", "bars_black")


def flatten(obj, path=()):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from flatten(v, path + (str(k),))
    elif isinstance(obj, list) and obj and all(
            isinstance(x, dict) and "name" in x for x in obj):
        for x in obj:
            yield from flatten(x, path + (x["name"],))
    else:
        yield path, obj


def read(log: str) -> dict:
    """(phase, key, ...) -> value over the run's JSON lines."""
    out = {}
    with open(log) as f:
        for ln in f:
            try:
                obj = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if not isinstance(obj, dict):
                continue
            phase = obj.pop("phase", None) or (
                "kernels" if "kernels" in obj else None)
            if phase is None:
                continue
            for path, v in flatten(obj):
                out[(phase,) + path] = v
    return out


def kind(path: tuple) -> str | None:
    joined, last = "/".join(path[1:]), path[-1]
    if "digest" in joined:
        return "digest"
    if last.endswith("ms") or "ms_per" in last or last.startswith("ms_"):
        return "time"
    if any(a in joined for a in ACCURACY):
        return "accuracy"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", nargs="+", required=True)
    ap.add_argument("--new", nargs="+", required=True)
    args = ap.parse_args(argv)
    base, new = [read(f) for f in args.base], [read(f) for f in args.new]
    ok = True
    for what in ("digest", "accuracy"):
        same, differ = 0, []
        for path, v in base[0].items():
            if kind(path) != what:
                continue
            for run in base[1:] + new:
                if run.get(path) != v:
                    differ.append({"key": "/".join(path), "base": v,
                                   "other": run.get(path)})
                    break
            else:
                same += 1
        ok &= not differ
        name = "digests" if what == "digest" else what
        print(json.dumps({name: {"equal": same, "differing": differ}}))
    for section in ("kernels", "times"):
        rows = {}
        for path in base[0]:
            if kind(path) != "time" or (path[0] == "kernels") != (
                    section == "kernels"):
                continue
            b = [r.get(path) for r in base]
            n = [r.get(path) for r in new]
            if None in b + n or not all(isinstance(x, (int, float))
                                        for x in b + n):
                continue
            mb, mn = sum(b) / len(b), sum(n) / len(n)
            rows["/".join(path)] = {"base": b, "new": n, "base_mean": mb,
                                    "new_mean": mn,
                                    "new_over_base": mn / mb if mb else None}
        print(json.dumps({section: rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

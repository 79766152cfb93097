"""Cells of ``BENCHMARK.json`` at a size the CPU runs in a second: 128 x 72
sources to 64 x 36 (2:1 on both axes, as the cells), 2-frame calls, a pool
of 2; the port on the CPU runs its plain versions."""

from __future__ import annotations

import copy

from vrbench import spec

W, H, OW, OH = 128, 72, 64, 36


def shrink(cell: spec.Cell) -> spec.Cell:
    cell.config = copy.deepcopy(cell.config)
    cell.config["video_source"].update(width=W, height=H)
    cell.config["output"].update(width=OW, height=OH)
    cell.traffic = dict(cell.traffic, batch=2, pool=2, check_from=8,
                        warmup_calls=min(int(cell.traffic["warmup_calls"]), 5))
    return cell


def patch_small(monkeypatch) -> None:
    load = spec.load_cell
    monkeypatch.setattr(spec, "load_cell",
                        lambda name, bench=spec.BENCHMARK:
                        shrink(load(name, bench)))


def cells() -> list[str]:
    return [w["name"] for w in spec.load_json(spec.BENCHMARK)["workloads"]]

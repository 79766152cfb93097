#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once, on one NVIDIA card.

    python3 vrbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``: a
configuration (``vrbench/configs/<config>.json``: the deployment and the
entry that drives it) under a traffic mix (``vrbench/traffic/<mix>.json``).
Set-up imports the port, makes the pool of inputs on the card from the
seed, builds the system under test and warms it up on the cell's own
shapes (the first run in a checkout also builds the port's kernels into
``videorenderer_tpu_torch/_build/``).  The window then keeps the mix's
calls in flight for ``--seconds``.  With ``--trace 1`` ``torch.profiler``
records the window and the line carries the per-layer metrics, ``busy_s``,
``window_s`` and a ``breakdown``; with ``--trace 0`` the end-to-end
metrics.  After the window the outputs of calls drawn from the seed, and of
the window's last complete call, are compared with the plain reference
(``vrbench/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit
(also the last lines of standard error).  Exits non-zero without a result
when CUDA is not available, when the card count is short of the cell's, or
when ``jax``, ``jaxlib``, ``flax`` or ``videorenderer_tpu`` is loaded once
the window has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from vrbench import check, gen, loop, spec  # noqa: E402
from vrbench.trace import read_profile  # noqa: E402
from videorenderer_tpu_torch.kernels import resize as rk  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "videorenderer_tpu"})


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def smi() -> str:
    """The card's name, power limit, clocks, power and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.mem,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


@dataclass
class Context:
    """What a metric's reader reads."""
    cell: object
    window: object
    setup_s: float
    trace: object
    costs: dict


def say(out, **kw) -> None:
    print(json.dumps(kw), file=out, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             clock, start: float = START, info=sys.stdout) -> dict:
    """One run of cell ``name``: set-up, the window, the metrics and the
    check.  Returns the result line's object."""
    cell = spec.load_cell(name)
    config, traffic = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    pool = gen.make_pool(traffic, config, seed, device)
    entry = spec.module("entries", config["entry"]).build(config, traffic,
                                                          device)
    # as many outputs held at once as the window holds (the calls in
    # flight, the newest, the kept ones), so that the allocator's blocks
    # are all there before it
    held = collections.deque(maxlen=int(traffic["depth"]) + 2
                             + int(traffic["checked_calls"]))
    for k in range(int(traffic["warmup_calls"])):
        held.append(entry.call(pool[k % len(pool)], k))
    clock.sync()
    del held
    say(info, phase="setup", smi=smi() if on_card else None)

    prof, span = None, loop.no_span
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
        span = record_function
    entry.span = span
    keep = gen.checked_calls(traffic, seed)
    rk.reset_launches()
    setup_s = time.perf_counter() - start
    try:
        window = loop.run(entry, pool, traffic, seconds, clock, keep, span)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    launches = {k: v / max(len(window.calls), 1)
                for k, v in rk.launches.items() if v}
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    traced = read_profile(prof, len(window.calls)) if trace else None
    del entry, prof
    if on_card:
        torch.cuda.empty_cache()
    costs = spec.module("costs", config["chain"]).stages(config, cell.batch)
    say(info, phase="window", calls=len(window.calls),
        completed=len(window.completed), launches_per_call=launches,
        memory_peak_bytes=memory_peak, smi=smi() if on_card else None,
        costs={k: {"bytes": b, "flops": f} for k, (b, f) in costs.items()})

    ctx = Context(cell=cell, window=window, setup_s=setup_s, trace=traced,
                  costs=costs)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t = time.perf_counter()
    verdict = check.compare(window.kept, pool, config, traffic, cell.limits)
    say(info, phase="check", seconds=time.perf_counter() - t,
        **verdict["info"])
    result = {"correct": verdict["correct"],
              "attempted": len(window.calls), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card
                         else "cpu",
                         "count": cell.chips,
                         "memory_peak_bytes": memory_peak}}
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["checks"] = verdict["numbers"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = spec.load_cell(args.workload).chips
    if not torch.cuda.is_available():
        print("vrbench: CUDA is not available; the benchmark runs on an "
              "NVIDIA card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"vrbench: {args.workload} needs {chips} card(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda"), loop.CudaClock())
    found = forbidden_modules()
    if found:
        print(f"vrbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, n in result["checks"].items():
        print(f"check {k} = {n['value']!r} (limit {n['limit']!r})",
              file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

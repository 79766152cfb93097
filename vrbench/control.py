#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on one NVIDIA card.

    python3 vrbench/control.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 2]

For each of ``--seeds`` it runs the cell as ``run.py`` does (set-up, a
window of ``--seconds`` at the cell's load, the check) in this one process
and prints the numbers the check compared.  For each of
``--control-seeds`` it then puts the control in the program's place: the
plain reference in the nearest precision below the configuration's (float32
with every matrix product's operands rounded to TF32), on the same frames
of the same calls as a run compares, packed into the surface's words, and
prints the same numbers.  The limits go between the program's largest
reading and the control's smallest (``limits/<cell>.json``).
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_outputs(cell, pool, calls) -> dict:
    """The control's surfaces of ``calls``: every frame through the
    reference in float32 with TF32 products, packed as the configuration's
    surface."""
    import torch

    from vrbench import check, gen, spec
    from vrbench.reference import oracle

    ar = oracle.Arith(torch.float32, tf32=True)
    surface = spec.module("surfaces", cell.config["surface"])
    out = {}
    for call in calls:
        planes = pool[gen.planes_of(cell.traffic, call)]
        out[call] = torch.stack([
            surface.pack(check.reference_frame(cell.config, cell.traffic,
                                               planes, f, call, ar))
            for f in range(cell.batch)])
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    import vrbench.run as run
    from vrbench import check, gen, loop, spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vrbench: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",") if s):
        lines = io.StringIO()
        r = run.run_cell(args.workload, seed, args.seconds, False, dev,
                         loop.CudaClock(), start=time.perf_counter(),
                         info=lines)
        info = [json.loads(ln) for ln in lines.getvalue().splitlines()]
        print(json.dumps({"workload": args.workload, "side": "program",
                          "seed": seed, "correct": r["correct"],
                          "checks": r["checks"],
                          "info": next(d for d in info
                                       if d.get("phase") == "check")}),
              flush=True)
        torch.cuda.empty_cache()
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        pool = gen.make_pool(cell.traffic, cell.config, seed, dev)
        calls = gen.checked_calls(cell.traffic, seed)
        t = time.perf_counter()
        outs = control_outputs(cell, pool, calls)
        verdict = check.compare(outs, pool, cell.config, cell.traffic,
                                cell.limits)
        print(json.dumps({"workload": args.workload, "side": "control",
                          "seed": seed, "correct": verdict["correct"],
                          "checks": verdict["numbers"],
                          "info": verdict["info"],
                          "seconds": time.perf_counter() - t}), flush=True)
        del pool, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

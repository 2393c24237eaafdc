#!/usr/bin/env python3
"""Readings for the limits of `correct`: one set-up of a cell, then for
each seed a short window and its comparison, printed as one JSON line
each; the same for the control (the program's bfloat16 field storage).

    python3 navbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 8

The numbers' limits (limits/<cell>.json) are set between the sound runs'
largest reading and the control's smallest.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _num(v):
    return v if np.isfinite(v) else str(v)


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from navbench import compare, harness, run, spec

    run.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    config, mix = spec.config(bench, cell["config"], ROOT), spec.traffic(cell["traffic"])
    t0 = time.perf_counter()
    setup = harness.Setup(config, mix, device, ROOT)
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    ref = compare.Reference(setup.path, config, ROOT)
    if hasattr(setup.kind, "control_readings"):
        print(json.dumps({"control_without_a_run": setup.kind.control_readings(ref)}),
              flush=True)
    for control, seeds in ((None, args.seeds), ("bf16", args.control_seeds)):
        for seed in seeds:
            drv = setup.driver(seed, control)
            drv.warm(1)
            out = drv.window(args.seconds)
            answers = setup.answers(out)
            t = time.perf_counter()
            nums = harness.numbers(setup, answers, ref)
            line = {"seed": seed, "control": control, "steps": out["steps"],
                    "e2e": out["e2e"], "failed": out["failed"],
                    "reference_s": time.perf_counter() - t,
                    "numbers": {k: _num(v) for k, v in nums.items()}}
            if hasattr(setup.kind, "readings"):
                # each sampled answer's readings, the finite ones (a walk
                # that is no chain to the goal, a command with no direction,
                # read inf)
                perm = compare.program_order(ref.mesh, answers["vertices"])
                per = setup.kind.readings(ref, answers, perm, mix, config)
                line["finite_max"] = {k: max([x for x in v if np.isfinite(x)], default=None)
                                      for k, v in per.items()}
                line["inf_count"] = {k: int(sum(not np.isfinite(x) for x in v))
                                     for k, v in per.items()}
            print(json.dumps(line), flush=True)
            del drv, out, answers
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

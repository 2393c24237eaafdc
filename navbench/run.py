#!/usr/bin/env python3
"""Run one cell of the benchmark once, on one CUDA card.

    python3 navbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and
limits are found by name (navbench/spec.py). The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
`device` and, traced, `breakdown`; last in it `checks`, each number the
comparison compared with its limit, which are also the last lines of
standard error. Without a CUDA card, with fewer cards than the cell asks
for, or where JAX or the JAX package was loaded, it prints no result and
exits non-zero. The comparison's control runs through calibrate.py.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "mesh_navigation_tpu")


def set_cache_dirs(root: str) -> None:
    """Kernel caches at fixed places inside the checkout. The program's own
    nvcc builds go to mesh_navigation_torch/build/, inside it too."""
    cache = os.path.join(root, ".navbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _num(x):
    return x if math.isfinite(x) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_cache_dirs(ROOT)
    sys.path.insert(0, ROOT)
    from navbench import harness, spec
    from navbench.reference import imports

    imports.check()
    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"navbench: the cell needs {cell['chips']} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, cards "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run_cell(
        cell=cell, config=spec.config(bench, cell["config"], ROOT),
        mix=spec.traffic(cell["traffic"]), limits=spec.limits(cell["name"]),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), t_start=T_START, root=ROOT,
        bench=bench)
    bad = loaded_forbidden()
    if bad:
        print(f"navbench: the run loaded {bad}", file=sys.stderr)
        return 3
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"], "device": result["device"]}
    for key in ("breakdown", "launches"):
        if key in result:
            line[key] = result[key]
    line["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                      for k, c in result["checks"].items()}
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

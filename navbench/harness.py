"""One run of one cell: set-up, the measured window, then the comparison.

Set-up (counted in setup_s from the process's start): the map file (made
once), the program's load of it, the navigation server of the
configuration, the driver of the mix's kind (kinds/<kind>.py) and the
warm-up steps of the cell's own shapes.
The window runs the driver for `seconds`; with `trace` it runs under
torch.profiler with the program's stage spans on, and the per-layer
metrics are read from that by metrics/<metric>.py. After the window the device's peak memory is
read, the program's state freed, and the sampled answers compared with
the reference.
"""

from __future__ import annotations

import time

from . import compare, devtrace, drivers, maps, spec


def _host(x):
    import torch

    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


class Setup:
    """The program as a cell's configuration serves it: the map file, the
    program's mesh and navigation server, the map file's arrays that the
    traffic is drawn on, and the mix's kind."""

    def __init__(self, config: dict, mix: dict, device, root: str = spec.ROOT):
        self.config, self.mix, self.device, self.root = config, mix, device, root
        self.kind = spec.kind(mix, root)
        self.path = maps.ensure_map(root, config)
        self.mesh = maps.load_mesh(root, self.path, config, device)
        self.server = maps.build_server(self.mesh, config, device)
        self.v_file, self.f_file = compare.read_ply(self.path)

    def driver(self, seed: int, control: str | None = None):
        traffic = self.kind.Traffic(self.mix, self.v_file, self.f_file, seed)
        return self.kind.Driver(self.server, traffic, self.mix, self.device, seed, control)

    def answers(self, out: dict) -> dict:
        """What the comparison reads of the program: its vertices, its
        costs, its plan's row layout, the sampled answers on the host and
        what else the window handed over (`out["answers"]`)."""
        from mesh_navigation_torch.mesh.arrays import host_array

        plan = self.server.banded_plan
        records = [{k: _host(v) for k, v in r.items()} for r in out["records"]]
        return dict(out.get("answers", {}), vertices=host_array(self.mesh, "vertices"),
                    costs=_host(self.server.vertex_costs), records=records,
                    plan_cols=(plan.n_cols, plan.n_cols_pad) if plan is not None else None)

    def trace(self, out: dict, spans, kt, launches: dict) -> dict:
        """What the per-layer metrics read of a traced window."""
        Rp, Cp, Bp = out.get("field_shape", (0, 0, 0))
        return {"kind": self.mix["kind"], "steps": out["steps"], "stages_ms": spans.totals(),
                "rounds": out["rounds"], "kernels": kt.kernels, "window_s": kt.window_s(),
                "busy_s": kt.busy_s(), "launches": launches,
                "shape": {"Rp": Rp, "Cp": Cp, "Bp": Bp, "V": self.mesh.num_vertices,
                          "B": self.mix["lanes"]}}


def numbers(setup: Setup, answers: dict, ref: compare.Reference) -> dict:
    """Each number the comparison reads off a window's answers."""
    return setup.kind.numbers(ref, answers, setup.mix, setup.config)


def e2e_value(e2e: dict, name: str) -> float:
    """A window's end-to-end number: the driver's `name`, or for a metric
    named `<quantity>.<group>` (one quantity split by cells' bounds) its
    `<quantity>`."""
    return e2e[name] if name in e2e else e2e[name.split(".")[0]]


def judge(numbers_: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): each number within its limit."""
    if set(numbers_) != set(limits):
        raise KeyError(f"numbers {sorted(numbers_)} and limits {sorted(limits)} differ")
    return (all(numbers_[k] <= limits[k] for k in numbers_),
            {k: {"value": numbers_[k], "limit": limits[k]} for k in numbers_})


def run_cell(*, cell: dict, config: dict, mix: dict, limits: dict, seed: int,
             seconds: float, trace: bool, device, t_start: float, bench: dict,
             root: str = spec.ROOT, control: str | None = None) -> dict:
    import torch
    from mesh_navigation_torch.ops import kernels

    cuda = torch.device(device).type == "cuda"
    if trace and not cuda:
        raise RuntimeError("a traced run reads the card's trace: it needs a CUDA device")
    setup = Setup(config, mix, device, root)
    drv = setup.driver(seed, control)
    drv.warm(mix["warmup"])
    drivers.sync(device)
    setup_s = time.perf_counter() - t_start

    launches0 = dict(kernels.LAUNCHES)
    if trace:
        spans = devtrace.make_spans(device)
        with devtrace.KernelTrace(device) as kt:
            out = drv.window(seconds, spans)
    else:
        out = drv.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    result = {"attempted": out["attempted"], "failed": out["failed"], "device": {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        launches = {k: n - launches0[k] for k, n in kernels.LAUNCHES.items()}
        tr = setup.trace(out, spans, kt, launches)
        metrics = {}
        for m in spec.metrics_of(bench, cell["name"], "per_layer"):
            value = spec.reader(m["name"], root)(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = kt.breakdown(spans.host)
        result["launches"] = {k: n for k, n in launches.items() if n}
        del spans, kt, tr
    else:
        e2e = dict(out["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e_value(e2e, m["name"]), "unit": m["unit"]}
                   for m in spec.metrics_of(bench, cell["name"], "end_to_end")}
    result["metrics"] = metrics

    answers = setup.answers(out)
    kind, path = setup.kind, setup.path
    del drv, setup, out
    if cuda:
        torch.cuda.empty_cache()
    ref = compare.Reference(path, config, root)
    nums = kind.numbers(ref, answers, mix, config)
    result["correct"], result["checks"] = judge(nums, limits)
    return result

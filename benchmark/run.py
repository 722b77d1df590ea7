"""Run one cell of BENCHMARK.json on the card and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--fault <name>]

The cell names its configuration (``configs/<config>.json``, whose
``driver`` names ``drivers/<driver>.py``) and its traffic mix
(``traffic/<traffic>.json``). With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
each read by ``metrics/<metric>.py`` from the traced slice and the
program's counters. ``--fault`` breaks the timed path underneath (the
driver's ``Faults``) to show that ``correct`` comes out false; no
benchmark run passes it. The last line of standard output is the
result; the numbers compared, each with its limit, close standard error.

Without a CUDA device, or with fewer than the cell asks for, it exits
with code 2 and prints no result: it never measures the CPU.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_module(path: str, name: str):
    """A file of the benchmark as a module (metric files carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, root: str = ROOT) -> tuple:
    """(benchmark, cell, configuration, traffic mix) by the cell's name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(has {sorted(cells)})")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    return bench, cell, cfg, mix


def reported(bench: dict, cell: dict) -> tuple:
    """(end-to-end, per-layer) metrics this cell reports: an end-to-end
    one in the cells its ``workloads`` key lists (every cell without the
    key), a per-layer one wherever the end-to-end metric it moves is."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    moved = {m["name"] for m in e2e}
    return e2e, [m for m in bench["per_layer"] if m["moves"] in moved]


def run_cell(bench: dict, cell: dict, cfg: dict, mix: dict, *, seed: int,
             seconds: float, trace: bool, fault=None, device,
             t_start: float = T_START, marks=None) -> tuple:
    """Run the cell's driver; (result line, check lines)."""
    import torch
    from benchmark import common
    driver = load_module(os.path.join(HERE, "drivers", cfg["driver"] + ".py"),
                         f"benchmark_driver_{cfg['driver']}")
    ctx = SimpleNamespace(cfg=cfg, mix=mix, cell=cell, seed=seed,
                          seconds=seconds, trace=trace, fault=fault,
                          device=torch.device(device), t_start=t_start,
                          marks=dict(marks or {},
                                     driver=time.time() - t_start))
    got = driver.run(ctx)
    e2e, per_layer = reported(bench, cell)
    metrics = {}
    if not trace:
        values = dict(got["metrics"], setup_s=got["setup_s"])
        for m in e2e:
            v = values.get(m["name"])
            if v is None:
                raise RuntimeError(f"{cell['name']}: the driver measured "
                                   f"no {m['name']}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in per_layer:
            reader = load_module(os.path.join(HERE, "metrics",
                                              m["name"] + ".py"),
                                 "benchmark_metric_" + m["name"]
                                 .replace(".", "_"))
            v = reader.read(got["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": got["memory_peak_bytes"]}
    if trace:
        info["busy_s"] = got.get("busy_s")
        info["window_s"] = got.get("window_s")
    checks = got["checks"]
    line = {"correct": checks.ok, "attempted": got["attempted"],
            "failed": got["failed"], "metrics": metrics, "device": info}
    if trace and got.get("breakdown"):
        line["breakdown"] = got["breakdown"]
    line["notes"] = got.get("notes", {})
    line["checks"] = checks.as_dict()
    return line, checks.lines(), common.forbidden_modules()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", "benchmark",
                                                sub))
    bench, cell, cfg, mix = load_cell(args.workload)
    marks = {"args": time.time() - T_START}
    import torch
    marks["torch"] = time.time() - T_START
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload}: needs {cell['chips']} CUDA device(s), "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    line, check_lines, forbidden = run_cell(
        bench, cell, cfg, mix, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), fault=args.fault, device="cuda",
        marks=dict(marks, cuda=time.time() - T_START))
    if forbidden:
        print(f"{args.workload}: loaded {forbidden} in the measuring "
              f"process: no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    for s in check_lines:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

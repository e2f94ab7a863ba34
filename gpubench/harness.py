"""One run of one cell: set-up, the measured or traced window, the check
against the plain reference, and the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the cell's configuration file (``configs[].file``),
its traffic mix ``traffic/<traffic>.json``, whose ``driver`` names the
module under ``drivers/`` that drives the program with it, and one reader
``metrics/<name>.py`` per per-layer metric.  A later cell, configuration
or metric is new files and new entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lk_tpu")


@dataclasses.dataclass
class Spec:
    """What a run of one cell needs, read from BENCHMARK.json."""

    workload: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_spec(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"
              ) -> Spec:
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())

    def mine(m):
        return workload in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if mine(m) is not False]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (mine(m) if "workloads" in m else m["moves"] in names)]
    return Spec(workload, cell["chips"], config, traffic, e2e, per_layer)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run must not load."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def load_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class ReaderContext:
    """What a per-layer reader sees: the reduced trace, the work the
    traced window completed (``units``), the cell's configuration and
    traffic."""

    trace: object
    units: dict
    config: dict
    traffic: dict


def make_cell(spec: Spec, seed: int, device: str):
    driver = importlib.import_module(f"gpubench.drivers.{spec.traffic['driver']}")
    return driver.Cell(spec.config, spec.traffic, seed, device)


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """Set-up, window, check; returns the result line as a dict."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = make_cell(spec, seed, device)
    cell.setup()
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    tr = None
    if trace:
        from gpubench.tracing import Trace

        tr = Trace.record(cell.traced_window)
        print(f"gpubench: traced window {tr.window_s:.3f} s, "
              f"{len(tr.device)} device operations, trace reduced in "
              f"{tr.reduce_s:.1f} s", file=sys.stderr)
    else:
        cell.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)

    if trace:
        ctx = ReaderContext(tr, cell.units(), spec.config, spec.traffic)
        metrics = {}
        for m in spec.per_layer:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = cell.metrics()
        values["setup_s"] = setup_s
        metrics = {}
        for m in spec.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"the {spec.traffic['driver']} driver "
                                   f"reports no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    cell.release()
    compared = finite(cell.compare())
    limits = spec.traffic["check"]["limits"]
    correct = all(v <= limits[k] for k, v in compared.items())
    out = {"correct": bool(correct), "attempted": cell.attempted,
           "failed": cell.failed, "metrics": metrics,
           "device": device_info(spec.chips, peak, tr, cuda)}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["compared"] = {k: {"value": v, "limit": limits[k]}
                       for k, v in compared.items()}
    return out


def run_control(spec: Spec, seed: int, device: str = "cuda") -> dict:
    """The control: the reference in the precision below the
    configuration's, put in the program's place, on the inputs and the
    sample a run of this seed compares."""
    cell = make_cell(spec, seed, device)
    cell.make_inputs()
    compared = finite(cell.compare(control=True))
    limits = spec.traffic["check"]["limits"]
    return {"control": True, "seed": seed,
            "correct": all(v <= limits[k] for k, v in compared.items()),
            "compared": {k: {"value": v, "limit": limits[k]}
                         for k, v in compared.items()}}


def finite(compared: dict) -> dict:
    """The compared numbers with NaN and infinity read as 1e308: a
    non-finite answer fails every limit, and JSON has no word for it."""
    return {k: v if math.isfinite(v) else 1e308 for k, v in compared.items()}


class ForbiddenImport(RuntimeError):
    pass


def device_info(chips: int, peak: int, tr, cuda: bool) -> dict:
    import torch

    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": chips, "memory_peak_bytes": int(peak)}
    if tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="gpubench/run.py",
        description="Run one cell of BENCHMARK.json once on this machine's "
                    "GPU and print its result as the last line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="print the control's comparison instead of a run")
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("gpubench: torch.cuda.is_available() is False: this benchmark "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < spec.chips:
        print(f"gpubench: {args.workload} needs {spec.chips} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    if args.control:
        print(json.dumps(run_control(spec, args.seed)))
        return 0
    try:
        out = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                       t_start=t_start)
    except ForbiddenImport as e:
        print(f"gpubench: the run loaded {e.args[0]}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {found}", file=sys.stderr)
        return 4
    print(f"gpubench: card {card_line()}", file=sys.stderr)
    for k, v in out["compared"].items():
        print(f"gpubench: compared {k} = {v['value']!r} (limit "
              f"{v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0

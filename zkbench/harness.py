"""One run of one cell: resolve it by name from BENCHMARK.json, set up,
measure or trace, judge the outputs, and assemble the result line.

Everything that belongs to one configuration, traffic mix, job loop or
per-layer metric is a file found by its name:

  configs/<config>.json     the deployment: its source, sizes, `reduced`
                            and `assumed`
  traffic/<traffic>.json    the mix: `job`, the job loop that runs it,
                            and the loop's settings
  loops/<job>.py            a job loop (`Loop`) with its `control` and
                            `FAULTS` (jobs.py holds what loops share)
  metrics/<metric>.py       a per-layer metric's reader: read(run) returns
                            its value, or None where it finds nothing.  One
                            reader may serve a family of names:
                            metrics/<family>.py every `<family>.<any>`,
                            metrics/_<suffix>.py every `<any>_<suffix>`

End-to-end metrics are the harness's own, from the host clock, by rule:
`setup_s`; `job_p<q>_ms`, the q-th percentile of all the window's job
latencies; and a rate `<unit>/s`, the units the job loop counts completed
in the window over the time from its start to the last completion.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import statistics
import time
from pathlib import Path

import torch

from . import jobs, tracing, work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    loop: object          # the module loops/<traffic's job>.py
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list
    base: Path            # the checkout the files were found in


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_of_cell if "moves" in metric else True


def resolve(name: str, base: Path = ROOT) -> Cell:
    """The cell `name` of `base`/BENCHMARK.json with its configuration,
    traffic and metrics, each found by name under `base`/zkbench."""
    bench = load_json(base / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(base / configs[w["config"]]["file"])
    traffic = load_json(base / HERE.name / "traffic" / f"{w['traffic']}.json")
    loop = _load(base / HERE.name / "loops" / f"{traffic['job']}.py", "loop")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), cfg, traffic, loop, e2e, per_layer, base)


def _load(path: Path, kind: str):
    """The module of the file `path`, loaded by its path."""
    if not path.is_file():
        raise KeyError(f"no {kind} {path}")
    spec = importlib.util.spec_from_file_location(f"zkbench_{kind}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, base: Path = ROOT):
    """The read(run) function of the metric's reader under
    `base`/zkbench/metrics: <metric>.py, else its family's, <family>.py
    for a name <family>.<any> or _<suffix>.py for a name <any>_<suffix>."""
    d = base / HERE.name / "metrics"
    names = [metric, metric.split(".")[0]]
    if "_" in metric:
        names.append("_" + metric.rsplit("_", 1)[1])
    path = next((d / f"{n}.py" for n in names if (d / f"{n}.py").is_file()),
                d / f"{metric}.py")
    return _load(path, "metric").read


@dataclasses.dataclass
class Run:
    """What a per-layer reader sees of a traced run."""

    cell: Cell
    job: jobs.Job                 # the cell's Loop
    records: list                 # one dict per job: submit, done, ...
    trace: tracing.Trace | None
    peaks: work.Peaks | None      # None off the card: no device metric then


def percentile(values: list, q: float) -> float:
    """The nearest-rank q-th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def end_to_end(metric: dict, job: jobs.Job, records: list, setup_s: float) -> float:
    name, unit = metric["name"], metric["unit"]
    if name == "setup_s":
        return setup_s
    m = re.fullmatch(r"job_p(\d+)_ms", name)
    if m:
        return 1e3 * percentile([r["done"] - r["submit"] for r in records], float(m[1]))
    if unit == f"{job.unit}/s":
        return job.units_per_job * len(records) / records[-1]["done"]
    raise KeyError(f"no rule for end-to-end metric {name!r} ({unit}) in a "
                   f"{type(job).__name__} cell")


def latency_line(records: list) -> str:
    lat = sorted(1e3 * (r["done"] - r["submit"]) for r in records)
    qs = {q: percentile(lat, q) for q in (50, 90, 95, 99)}
    first = " ".join(f"{1e3 * (r['done'] - r['submit']):.3f}" for r in records[:5])
    return (f"job latency ms over {len(lat)} jobs: median {statistics.median(lat)!r} "
            + " ".join(f"p{q} {v!r}" for q, v in qs.items()) + f" max {lat[-1]!r}"
            + f"; the first jobs {first}")


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        fault=None):
    """One run: returns (the result dict, stderr lines to print).  `fault`,
    a context manager factory, plants a fault or the control under the
    timed path (the tests and control.py; never the benchmark's runs)."""
    from blaze_tpu_torch import _build

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    job = cell.loop.Loop(cell.config, cell.traffic, seed, dev)
    if on_card:
        _build.build_all(job.libs)
    plant = fault(job) if fault else None
    if plant:
        plant.__enter__()
    try:
        job.setup()
        setup_s = time.perf_counter() - t_start
        tr = None
        if traced:
            count = int(cell.traffic["traced_jobs"])
            records, tr = tracing.profile(lambda: job.window(lambda j, _: j >= count),
                                          _build.LAUNCHES, on_card)
        else:
            records = job.window(lambda j, elapsed: j >= job.sets and elapsed >= seconds)
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        t_check = time.perf_counter()
        job.finish()
        if on_card:
            torch.cuda.empty_cache()
        checks, bad = job.check()
        check_s = time.perf_counter() - t_check
    finally:
        if plant:
            plant.__exit__(None, None, None)
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    peaks = work.peaks_for(kind) if on_card else None
    if traced:
        r = Run(cell, job, records, tr, peaks)
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"], cell.base)(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": end_to_end(m, job, records, setup_s),
                               "unit": m["unit"]} for m in cell.end_to_end}
    devinfo = {"platform": "gpu" if on_card else "cpu", "kind": kind,
               "count": 1, "memory_peak_bytes": peak}
    if traced:
        devinfo.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(records), "failed": len(bad), "metrics": metrics,
              "device": devinfo}
    if traced:
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    lines = [latency_line(records), f"setup_s {setup_s!r}; drain and reference {check_s!r} s"]
    lines += [f"check {k}: {v} (limit {lim})" for k, (v, lim) in checks.items()]
    return result, lines

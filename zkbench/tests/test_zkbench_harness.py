"""The harness on the CPU: BENCHMARK.json against the contract, every name
resolved to its file, a cell added by new files alone, the result line's
keys, the import check, the refusals, and the frozen work counts."""
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from zkbench import harness, work
from zkbench.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == KEYS["top"]
    assert BENCH["paths"] == ["zkbench"] and BENCH["command"][1] == "zkbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"]) and _line(c["why"])
        assert c["file"].startswith("zkbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and all(k in cfg for k in c["reduced"])
        assert c["source"].startswith("https://") and _line(c["source"])
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"]) and _line(w["why"])
        assert w["chips"] == 1 and w["config"] in {c["name"] for c in BENCH["configs"]}
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert set(m) - {"workloads"} == KEYS[kind]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", CELLS)) <= set(CELLS)
            names.add(m["name"])
    assert len(names) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", CELLS))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_by_name(name):
    cell = harness.resolve(name)
    job = cell.loop.Loop(cell.config, cell.traffic, 7, "cpu")
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    records = [{"submit": 0.0, "done": 1.0}, {"submit": 1.0, "done": 2.0}]
    for m in cell.end_to_end:
        assert harness.end_to_end(m, job, records, 3.0) > 0
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


NEW_LOOP = '''"""FusedNTT.ntt into a buffer the caller keeps per input set."""
import torch

from zkbench import faults, jobs


class Loop(jobs.NTTJob):
    libs = ("montmul", "field_ew", "ntt_kernels")

    def setup(self):
        from blaze_tpu_torch.fields import FIELDS
        from blaze_tpu_torch.ntt import FusedNTT

        self.plan = FusedNTT(FIELDS[self.field], self.logn, device=self.device)
        self.x = [self.make_input(s) for s in range(self.sets)]
        self.out = [torch.empty_like(x) for x in self.x]
        self.rows = []

    def window(self, stop):
        def job(j):
            s = j % self.sets
            self.out[s].copy_(self.plan.ntt(self.x[s]))
            self.rows.append(self.out[s][self.idx[s]].numpy())

        return jobs.closed_loop(job, stop)

    def finish(self):
        del self.plan

    def check(self):
        last = {len(self.rows) - self.sets + s: self.out[s] for s in range(self.sets)}
        return self.judge(lambda s: self.x[s], self.rows, last)


def _plan():
    from blaze_tpu_torch.ntt import FusedNTT

    return FusedNTT


def control(job):
    return faults.wrap(_plan(), "ntt", lambda y, _: faults.lazy(y, job.p))


FAULTS = {"half": lambda job: faults.wrap(_plan(), "ntt", lambda y, _: y[:len(y) // 2].repeat(2, 1))}
'''


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A new configuration, job loop (with its control and fault), traffic
    mix and per-layer metric: four new files under zkbench/ and new
    entries in BENCHMARK.json; no file that is there changes.  The new
    cell runs correct and reports the new metric, its control and fault
    come out not correct, and a metric of an existing family
    (idle_pct.<cell>) needs no file at all."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "zkbench", tmp_path / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "zkbench")
    z = tmp_path / "zkbench"
    cfg = json.loads((z / "configs" / "blaze_bls12_381.json").read_text())
    cfg.update(name="small_ntt", ntt_log_size=6, reduced=["ntt_log_size"])
    (z / "configs" / "small_ntt.json").write_text(json.dumps(cfg))
    (z / "loops" / "ntt_kept.py").write_text(NEW_LOOP)
    (z / "traffic" / "three_sets.json").write_text(json.dumps(
        {"job": "ntt_kept", "input_sets": 3, "traced_jobs": 3, "sampled_points": 4,
         "whole_checks_among_first": 1, "inverse_points": 2}))
    (z / "metrics" / "jobs_traced.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "small_ntt", "source": "https://example.org/ntt",
                             "file": "zkbench/configs/small_ntt.json",
                             "reduced": ["ntt_log_size"], "why": "a test"})
    bench["workloads"].append({"name": "small_ntt.three_sets", "config": "small_ntt",
                               "traffic": "three_sets", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "ntt_elements_per_s":
            m["workloads"].append("small_ntt.three_sets")
    for name in ("jobs_traced", "idle_pct.small"):
        bench["per_layer"].append({"name": name, "unit": "jobs", "better": "higher",
                                   "source": "program_counter", "layer": "a test",
                                   "moves": "ntt_elements_per_s",
                                   "workloads": ["small_ntt.three_sets"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(z)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/small_ntt.json", "loops/ntt_kept.py",
                                        "traffic/three_sets.json", "metrics/jobs_traced.py"}
    cell = harness.resolve("small_ntt.three_sets", tmp_path)
    assert cell.config["ntt_log_size"] == 6 and cell.loop.Loop.unit == "elements"
    assert [m["name"] for m in cell.per_layer] == ["jobs_traced", "idle_pct.small"]
    assert harness.reader("idle_pct.small", tmp_path)
    res, _ = harness.run(cell, 2**31 + 5, 0.01, False, "cpu", time.perf_counter())
    assert res["correct"] and res["attempted"] >= 3
    assert set(res["metrics"]) == {"ntt_elements_per_s", "setup_s"}
    res, _ = harness.run(cell, 2**31 + 6, 0.01, True, "cpu", time.perf_counter())
    assert res["correct"] and res["metrics"]["jobs_traced"]["value"] == 3.0
    for plant in (cell.loop.control, cell.loop.FAULTS["half"]):
        res, _ = harness.run(cell, 2**31 + 7, 0.01, False, "cpu", time.perf_counter(),
                             fault=plant)
        assert not res["correct"] and res["failed"] >= 1


@pytest.mark.parametrize("metric, file", [
    ("msm.glue_ms", "msm.glue_ms.py"), ("idle_pct.msm", "idle_pct.py"),
    ("idle_pct.any_new_cell", "idle_pct.py"), ("ntt_roofline", "_roofline.py"),
    ("k9_roofline", "_roofline.py"),
])
def test_a_reader_serves_its_family_of_names(metric, file):
    read = harness.reader(metric)
    assert Path(read.__code__.co_filename).name == file
    with pytest.raises(KeyError):
        harness.reader("no_such.metric")


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line_has_the_contract_keys(traced, small_cell):
    cell = small_cell("blaze_bls12_381.ntt_resident")
    res, lines = harness.run(cell, 3_000_000_019, 0.05, traced, "cpu", time.perf_counter())
    keys = list(harness.RESULT_KEYS) + (["breakdown"] if traced else []) + ["checks"]
    assert list(res) == keys
    json.dumps(res)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"ntt_elements_per_s", "job_p95_ms", "setup_s"}
        assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert res["checks"] == {"ntt_values_wrong": {"value": 0, "limit": 0}}
    assert lines[-1].startswith("check ntt_values_wrong: 0")


@pytest.mark.parametrize("module, found", [
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]),
    ("flax", ["flax"]), ("blaze_tpu", ["blaze_tpu"]), ("blaze_tpu.msm", ["blaze_tpu"]),
    ("blaze_tpu_torch", []), ("blaze_tpu_torch.msm", []), ("jaxtyping", []),
])
def test_the_import_check_compares_top_level_names(monkeypatch, module, found):
    for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                          "blaze_tpu")]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, module, object())
    assert forbidden_modules() == found


def _command(cwd: Path):
    return subprocess.run([sys.executable, "zkbench/run.py", "--workload",
                           "blaze_bls12_381.ntt_resident", "--seed", "3000000000",
                           "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_the_command_fails_and_prints_no_result(card_absent):
    out = _command(ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_without_the_program_the_command_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "zkbench", tmp_path / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_work_counts_equal_hand_counts():
    n, W = 1 << 24, 12
    products = 16 * (13 * n + 14 * 2 * 65535) + 14 * 15 * 17
    assert work.msm_work(n, 16, W, 255, 16) == (n * (96 + 32), products * (4 * 144 + 12))
    assert work.product_imads(8) == 264 and work.product_imads(12) == 588
    m = 1 << 27
    assert work.ntt_work(27, 8) == (2 * m * 32, ((m // 2) * 27 - (m - 1)) * 264)
    leaf = {"t": 12, "r_f": 8, "r_p": 60}
    node = {"t": 9, "r_f": 8, "r_p": 63}
    full, unr, redc = 264, 128, 136
    per_leaf = ((3 * (96 + 60) + 12) * full + 96 * (12 * unr + redc)
                + 60 * (12 * unr + redc + 11 * full))
    per_node = (3 * (72 + 63) * full + 72 * (9 * unr + redc)
                + 63 * (9 * unr + redc + 8 * full))
    leaves, nodes = 8 ** 8, (8 ** 8 - 1) // 7
    assert work.poseidon_imads(12, 8, 60, 1, 8) == per_leaf
    assert work.tree_work(9, 8, 11, 8, leaf, node) == (
        leaves * 12 * 32, leaves * per_leaf + nodes * per_node + (leaves + nodes) * full)
    peaks = work.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks.imad_per_s == 132 * 64 * 1980e6
    s, by = work.bound_s(work.ntt_work(27, 8), peaks)
    assert by == "operations" and s == pytest.approx(0.02650, rel=1e-3)
    with pytest.raises(ValueError):
        work.peaks_for("cpu")


def test_work_counts_equal_the_programs_own():
    """The frozen copies against the program's bench/profile.py at the
    cells' shapes (the program may change them later; the copies stay)."""
    from blaze_tpu_torch.bench import profile
    from blaze_tpu_torch.curves import CURVES
    from blaze_tpu_torch.fields import FIELDS
    from blaze_tpu_torch.hash import generate_params

    fr = FIELDS["bls12_381_fr"]
    assert work.msm_work(1 << 24, 16, 12, 255, 16) == profile.msm_work(
        CURVES["bls12_381"], 1 << 24, 16)
    assert work.ntt_work(27, 8) == profile.ntt_work(fr, 27)
    leaf, node = generate_params(fr, 12), generate_params(fr, 9)
    assert work.tree_work(9, 8, 11, 8, {"t": 12, "r_f": 8, "r_p": leaf.r_p},
                          {"t": 9, "r_f": 8, "r_p": node.r_p}) == profile.poseidon_work(
        fr, 9, leaf, node)


def test_the_tree_check_takes_a_whole_subtree_and_its_path_to_the_root():
    """At the cell's height the tree's judgement reads a whole subtree of
    `subtree_height` layers drawn from the seed, every node on its path to
    the root, and the sampled leaves and nodes besides."""
    import random

    cell = harness.resolve("filecoin_treec_32gib.build_resident")
    job = cell.loop.Loop(cell.config, cell.traffic, 11, "cpu")
    a, h, sub = job.arity, job.height, cell.traffic["subtree_height"]
    picks, leaves = job._picks(random.Random(3))
    # the subtree's root: a node of layer `sub` whose whole block of leaves is read
    roots = [r for r in picks[sub] if set(range(r * a ** sub, (r + 1) * a ** sub)) <= set(leaves)]
    assert roots
    r = roots[0]
    for l in range(sub + 1):
        span = a ** (sub - l)
        assert set(range(r * span, (r + 1) * span)) <= set(picks[l])
    for l in range(sub + 1, h):
        assert r // a ** (l - sub) in picks[l]
    assert len(leaves) > a ** sub + cell.traffic["sampled_leaves"] // 2
    assert all(len(picks[l]) >= min(a ** (h - 1 - l), cell.traffic["sampled_nodes"])
               for l in range(h))

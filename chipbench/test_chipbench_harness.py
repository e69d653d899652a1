"""The harness on the CPU: discovery by name, the traffic's determinism,
the benchmark file's shape, and the refusal to run without a card."""

import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from chipbench import harness, traffic

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    suite = harness.Suite()
    workload = harness.check_cell(suite, cell)
    entry = suite.cell(cell)
    assert suite.data("configs", entry["config"])["name"] == entry["config"]
    tr = traffic.check(suite.data("traffic", entry["traffic"]))
    assert callable(suite.module("drivers", tr["driver"]).run)
    assert workload["why"] == entry["why"]
    assert set(workload["check"]["limits"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.Suite().module("metrics", metric).read)


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    suite = harness.Suite()
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in suite.metrics(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert suite.metrics(w["name"], "per_layer")


def _digest(root: Path) -> dict:
    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_in_another_directory_needs_no_edit(tmp_path):
    before = _digest(harness.HERE)
    (tmp_path / "workloads").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "traffic" / "prefill-64x256.json").write_text(json.dumps(
        {"driver": "prefill", "rows": 64, "seq_len": 256, "ids": "uniform"}))
    cell = {"name": "mixtral-8x7b.prefill-64x256", "config": "mixtral-8x7b",
            "traffic": "prefill-64x256", "chips": 1,
            "why": "shorter prompts"}
    (tmp_path / "workloads" / f"{cell['name']}.json").write_text(
        json.dumps({**{k: cell[k] for k in ("config", "traffic", "chips",
                                             "why")},
                    "check": {"requests_per_rank": 1, "tie_margin": 0.2,
                              "limits": {"rank_logit_err": 1.0}}}))
    (tmp_path / "metrics" / "hit_share.prefill.py").write_text(
        "def read(record):\n    return None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(cell)
    for m in bench["end_to_end"]:
        if m["name"] in ("prefill_tokens_per_s", "ttft_p90_ms"):
            m["workloads"].append(cell["name"])
    bench["per_layer"].append(
        {"name": "hit_share.prefill", "unit": "%", "better": "higher",
         "source": "program_counter", "layer": "cache",
         "moves": "prefill_tokens_per_s",
         "workloads": ["mixtral-8x7b.prefill-64x256"]})
    suite = harness.Suite([tmp_path, harness.HERE], bench)
    assert harness.check_cell(suite, cell["name"])["traffic"] == \
        "prefill-64x256"
    assert suite.data("configs", "mixtral-8x7b")["model"]["d_model"] == 4096
    assert suite.module("metrics", "hit_share.prefill").read({}) is None
    assert {m["name"] for m in suite.metrics(cell["name"], "per_layer")} \
        == {"mfu.prefill", "idle_share.prefill", "hit_share.prefill"}
    assert _digest(harness.HERE) == before


def test_cell_disagreeing_with_its_file_is_refused(tmp_path):
    (tmp_path / "workloads").mkdir()
    name = BENCH["workloads"][0]["name"]
    data = json.loads((harness.HERE / "workloads" /
                       f"{name}.json").read_text())
    data["chips"] = 4
    (tmp_path / "workloads" / f"{name}.json").write_text(json.dumps(data))
    with pytest.raises(ValueError, match="chips"):
        harness.check_cell(harness.Suite([tmp_path, harness.HERE]), name)


@pytest.mark.parametrize("rows,seq_len", [(4, 16), (3, 33)])
def test_traffic_is_the_seeds(rows, seq_len):
    tr = traffic.check({"driver": "train", "rows": rows, "seq_len": seq_len,
                        "ids": "uniform", "labels": True})
    seed = 2 ** 31 + 12345
    a = traffic.batch(tr, 1000, seed, 7, "cpu")
    b = traffic.batch(tr, 1000, seed, 7, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], b["labels"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].shape == (rows, seq_len)
    assert a["tokens"].dtype == torch.int64
    assert int(a["tokens"].max()) < 1000 and int(a["tokens"].min()) >= 0
    assert not torch.equal(a["tokens"],
                           traffic.batch(tr, 1000, seed, 8, "cpu")["tokens"])
    assert not torch.equal(
        a["tokens"], traffic.batch(tr, 1000, seed + 1, 7, "cpu")["tokens"])


def test_traffic_refuses_unknown_keys():
    with pytest.raises(ValueError, match="unknown traffic keys"):
        traffic.check({"driver": "prefill", "rows": 1, "seq_len": 1,
                       "rate": 3})


def test_traffic_refuses_unknown_id_laws():
    with pytest.raises(ValueError, match="unknown id law"):
        traffic.check({"driver": "prefill", "rows": 1, "seq_len": 1,
                       "ids": "zipf"})


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert set(c["reduced"]) <= set(
            json.loads((ROOT / c["file"]).read_text())["model"]) | {
                "rms_norm_eps"}
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert all(p == "chipbench" for p in BENCH["paths"])


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not proc.stdout.strip()


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro.core" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert "jaxlib" in harness.forbidden_modules()

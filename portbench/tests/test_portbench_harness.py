"""The harness reads cells, mixes and metrics as data; the isolation check;
the result line's schema. CPU only, at the tiny sizes of ``conftest``."""
from __future__ import annotations

import json
import math
import subprocess
import sys

import pytest
from conftest import BENCH, CELLS, ROOT, tiny_cell

import run as bench
from pbench import harness, traffic


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_in_the_benchmark_has_its_files():
    b = _bench()
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    for conf in b["configs"]:
        assert (ROOT / conf["file"]).is_file()
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        assert harness.reference(cell).leaves(cell.model)
        assert callable(harness.driver(cell).run)
        assert set(cell.limits) - {k for k in cell.limits if k.startswith("_")}
    for m in b["per_layer"]:
        assert harness.metric_file(m["name"]).is_file()
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_is_found_by_name(name):
    cell = harness.load_cell(name)
    assert cell.spec["name"] == name
    assert cell.traffic["kind"] in ("train", "prefill")
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    cfg = harness.program_config(cell.model)
    assert cfg.n_layers == cell.model["n_layers"] and cfg.d_model == cell.model["d_model"]


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A later cell adds entries and files; the harness finds them by name."""
    b = _bench()
    b["workloads"].append({"name": "internlm2-1.8b.prefill_short", "config": "internlm2-1.8b",
                           "traffic": "prefill_2k-32k", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    for sub in ("configs",):
        (tmp_path / "portbench" / sub).mkdir(parents=True)
    for conf in b["configs"]:
        (tmp_path / conf["file"]).write_text((ROOT / conf["file"]).read_text())
    limits = BENCH / "limits" / "internlm2-1.8b.prefill_short.json"
    limits.write_text('{"logits": 1.0}')
    try:
        cell = harness.load_cell("internlm2-1.8b.prefill_short", root=tmp_path)
        assert cell.limits == {"logits": 1.0} and cell.traffic["kind"] == "prefill"
    finally:
        limits.unlink()


def test_prompts_are_the_same_set_for_every_seed_and_the_same_inputs_for_one():
    mix = tiny_cell("internlm2-1.8b.prefill_2k-32k").traffic
    a = traffic.prompts(mix, 256, 2**31 + 17, "cpu")
    b = traffic.prompts(mix, 256, 2**31 + 17, "cpu")
    c = traffic.prompts(mix, 256, 5, "cpu")
    assert [n for n, _ in a] == [n for n, _ in b]
    assert all(bool((x == y).all()) for (_, x), (_, y) in zip(a, b))
    assert sorted(n for n, _ in a) == sorted(n for n, _ in c)
    full = json.loads((BENCH / "traffic" / "prefill_2k-32k.json").read_text())
    lengths = traffic.prompt_lengths(full)
    assert min(lengths) >= 2048 and max(lengths) <= 32768 and len(set(lengths)) == 16


def test_the_loader_copy_gives_the_programs_rows():
    from repro_torch.data import ShardedLoader, SyntheticTokens

    seed = 2**31 + 5
    loader = ShardedLoader(SyntheticTokens(256, 32, seed=seed), 8, 8)
    for step in range(2):
        theirs = loader.next_batch()
        ours = traffic.train_batch(256, 32, seed, 8, 8, step)
        assert all((theirs[k] == ours[k]).all() for k in ("tokens", "labels"))


def test_forbidden_modules_are_judged_by_their_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.lease_array", sys)
    assert "repro" in harness.loaded_forbidden()


def test_a_run_loads_neither_jax_nor_the_reference_package():
    """A whole (tiny, CPU) run in a fresh process, then its top-level modules."""
    code = ("import sys; sys.argv = ['x']; "
            "sys.path[:0] = ['src', 'portbench', 'portbench/tests']; "
            "import run; run._environment(); from conftest import tiny_cell; "
            "name = 'rwkv6-3b.train_4k'; "
            "run.run(name, 7, 0.05, False, device='cpu', cell=tiny_cell(name)); "
            "from pbench import harness; print('FOUND', harness.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert "FOUND []" in out.stdout, out.stdout + out.stderr


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_the_result_line_schema(name, trace):
    cell = tiny_cell(name, dtype="float32")
    r = bench.run(name, 123, 0.05, bool(trace), device="cpu", cell=cell)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"} and math.isfinite(v["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_no_card_means_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "internlm2-1.8b.train_4k", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""

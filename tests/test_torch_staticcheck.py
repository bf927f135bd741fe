"""The port's leaselint (``repro_torch.analysis.staticcheck``) on the CPU.

The tree is clean (the interval checker first); every seeded mutant is
caught and its clean twin passes; the traced-core purity rule flags a
``.sum()`` that widens to int64 and exempts only gather indices, in the
``legs_gather`` cores; the launch plans are clean at every lease geometry ``chip_smoke.py``
launches and at the reference's audit default (N 4096, A 5, P 8, T 64);
each plan's geometry is the one the C launchers used to work out for
themselves (block threads, grid, staging bytes: the product the old
``_check_geometry`` took); the port's plane table equals the reference's
and the docs'; the CLI writes its JSON artifact. The reference's
``repro.analysis.staticcheck`` is not imported (it needs a jax with
``jax.core.Literal``); its plane table comes from ``repro.lease_array.
scenario``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import staticcheck as sc
from repro_torch.analysis.staticcheck.fixtures import FIXTURES
from repro_torch.analysis.staticcheck.launch import (
    LAUNCHERS,
    check_launch_plan,
    eval_words,
    launcher_words,
    thread_cells,
)
from repro_torch.analysis.staticcheck.purity import LEASE_CU
from repro_torch.lease_array import kernel as K
from repro_torch.lease_array.scenario import plane_table_md

ROOT = Path(__file__).resolve().parents[1]

#: the lease launches of chip_smoke.py, one geometry a phase: every entry
#: and plane-group variant at each (window_launch_plans' arguments)
SMOKE_GEOMETRIES = {
    "phase2-a5-w1": dict(n_cells=1000, n_ticks=384, window=1, batch=1),
    "phase2-a5-w3": dict(n_cells=1000, n_ticks=128, window=3, batch=1),
    "phase2-a5-w16": dict(n_cells=1000, n_ticks=96, window=16, batch=1),
    "phase2-a3": dict(n_cells=1000, n_acceptors=3, n_proposers=5, n_ticks=96,
                      window=3, batch=1),
    "phase3-renewal": dict(n_cells=1 << 20, n_ticks=256, batch=1),
    "phase5-sync": dict(n_cells=1 << 20, n_ticks=128, batch=1),
    "phase6-step": dict(n_cells=1 << 20, n_ticks=1, batch=1),
    "phase18-referee": dict(n_cells=16, n_proposers=4, n_ticks=1000, batch=1),
    "phase19a-bench-sweep": dict(n_cells=32, n_acceptors=3, n_proposers=4,
                                 n_ticks=16, batch=1024),
    "phase19b-chaos-sweep": dict(n_cells=1 << 14, n_ticks=128, batch=64),
    "phase20-shrinker": dict(n_cells=4, n_acceptors=3, n_proposers=4,
                             n_ticks=16, batch=1),
    "phase21-directory": dict(n_cells=1024, n_ticks=1, batch=1),
    "reference-default": dict(),
}


def test_tree_is_clean():
    assert sc.run_all() == []


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_mutant_is_caught_and_clean_twin_passes(name):
    mutant, want, clean = FIXTURES[name]
    assert want <= {f.rule for f in mutant()}
    assert clean() == []


@pytest.mark.parametrize("geometry", sorted(SMOKE_GEOMETRIES))
def test_plans_are_clean_at_the_smoke_geometries(geometry):
    assert sc.check_window_launches(**SMOKE_GEOMETRIES[geometry]) == []


def _old_words(A, P, variant, delayed):
    """The per-tick staging words of the C launchers before the plan
    (lease_window.cu's launch_delayed and launch_sync), and of the old
    _check_geometry."""
    if not delayed:
        return 2 * A + P
    return (2 * A + P + P * A + (2 * A if "corrupt" in variant else 0)
            + (2 * A + 2 * P if "restart" in variant else 0))


@pytest.mark.parametrize("A,P", [(1, 1), (3, 4), (5, 8), (15, 64)])
@pytest.mark.parametrize("N", [1, 31, 32, 100, 128, 1000, 4096])
def test_plan_geometry_equals_the_old_launchers(A, P, N):
    for T, window in ((1, 16), (16, 16), (37, 3), (64, 100)):
        tw = max(1, min(window, T))
        threads = (N + 31) // 32 * 32 if N < 128 else 128
        for what, plan in sc.window_launch_plans(N, A, P, T, window=window,
                                                 batch=5):
            if plan.index_map == K.WARP_TILE_MAP:
                assert plan.threads == 32 * K.SYNC_BATCH_WARPS
                assert plan.grid == (-(-5 * -(-N // 32) // K.SYNC_BATCH_WARPS), 1)
                assert plan.smem_bytes == (K.SYNC_BATCH_WARPS * (2 * A + P)
                                           * K.BATCH_SUB * 4), what
                continue
            delayed = plan.entry.startswith("lease_window_delayed")
            if plan.index_map == K.LANE_MAP:
                # G lanes a cell; a warp a tile (four a block) while a
                # scenario's lanes fill less than a block, else the block
                G = plan.lanes
                tile = 32 if (N * G + 31) // 32 < 4 else 128
                assert plan.threads == 128, what
                assert plan.grid == (-(-5 * -(-N // (tile // G)) // (128 // tile)), 1), what
                assert plan.tw == min(tw, K.BATCH_SUB)
                assert plan.smem_bytes == (128 // tile * _old_words(
                    A, P, plan.variant, True) * plan.tw * 4), what
                continue
            assert plan.threads == threads, what
            assert plan.grid == (-(-N // threads), plan.batch), what
            assert plan.tw == tw
            assert plan.smem_bytes == (_old_words(A, P, plan.variant, delayed)
                                       * tw * 4), what


def test_every_thread_owns_one_cell():
    """thread_cells, the index maps the audit enumerates: each (b, n) cell
    has exactly one writing thread."""
    for _, plan in sc.window_launch_plans(1000, 3, 5, 16, batch=5):
        b, n, writes = thread_cells(plan)
        cells = sorted(zip(b[writes].tolist(), n[writes].tolist()))
        assert cells == [(i, j) for i in range(plan.batch) for j in range(1000)]


def test_a_plan_without_its_guard_is_out_of_bounds():
    plan = K.delayed_launch_plan(5, 1000, 8, 16)
    assert {f.rule for f in check_launch_plan(plan._replace(guards=()))} == {
        "out-of-bounds"}
    # the batched delayed kernel's lane groups: five one-warp tiles (N 20,
    # G 1) in two blocks of four leave three warps past the batch, which
    # write out of bounds unguarded; a cell's G lanes all write without
    # the lane-0 guard
    batched = K.delayed_batched_launch_plan(5, 20, 8, 16, 5, lanes=1)
    assert batched.grid == (2, 1) and check_launch_plan(batched) == []
    unguarded = batched._replace(guards=("n < N", "lane == 0"))
    assert {f.rule for f in check_launch_plan(unguarded)} == {"out-of-bounds"}
    for lanes in (2, 4, 8):
        group = K.delayed_batched_launch_plan(5, 20, 8, 16, 5, lanes=lanes)
        assert check_launch_plan(group) == []
        every_lane = group._replace(guards=("tile < B * tiles", "n < N"))
        assert {f.rule for f in check_launch_plan(every_lane)} == {"write-race"}


@pytest.mark.parametrize("A", [1, 3, 5, 15])
@pytest.mark.parametrize("N", [1, 4, 31, 37, 300])
def test_one_writer_a_cell_at_every_lane_count(A, N):
    """At every lane count the batched delayed kernel is built for, each
    (b, n) cell has exactly one writing lane, and the plan is clean."""
    assert K.lane_counts(A) == {1: (1,), 3: (1, 2, 4), 5: (1, 2, 4, 8),
                                15: (1, 2, 4, 8)}[A]
    for lanes in K.lane_counts(A):
        plan = K.delayed_batched_launch_plan(A, N, A + 1, 20, 3, lanes=lanes)
        assert plan.lanes == lanes and check_launch_plan(plan) == []
        b, n, writes = thread_cells(plan)
        cells = sorted(zip(b[writes].tolist(), n[writes].tolist()))
        assert cells == [(i, j) for i in range(3) for j in range(N)], lanes


#: (A, scenarios, cells a scenario, the lanes a cell that ran fastest) on an
#: NVIDIA H100 (132 SMs), every G timed in turns by ``python3
#: tools/lease_batched_time.py --lanes``: the falsifier's shrinker, the
#: bench sweep and its first scenarios, the chaos sweep, its first
#: scenarios and its first scenario cut to fewer cells
MEASURED_FASTEST_LANES = [
    (3, 1, 4, 4),
    (3, 1, 32, 4), (3, 8, 32, 4), (3, 32, 32, 4), (3, 128, 32, 4),
    (3, 256, 32, 4), (3, 512, 32, 2), (3, 1024, 32, 1),
    (5, 1, 4, 8), (5, 1, 256, 8), (5, 1, 1024, 8), (5, 1, 4096, 8),
    (5, 1, 16384, 2), (5, 4, 16384, 1), (5, 64, 16384, 1),
]


@pytest.mark.parametrize("A, B, N, fastest", MEASURED_FASTEST_LANES)
def test_the_plan_takes_the_lanes_that_ran_fastest(A, B, N, fastest):
    """On an H100's 132 SMs the plan's G is the one that ran fastest at
    each timed shape (the rule's FILL_LANES_PER_SM is taken from these)."""
    plan = K.delayed_batched_launch_plan(A, N, A + 1, 16, B, sms=132)
    assert plan.lanes == fastest


@pytest.mark.parametrize("how", ["unbuilt", "too-many", "tiling"])
def test_a_plan_with_a_wrong_lane_count(how):
    """A lane count the kernel is not built for at A, or a tiling that
    is not the one its layout gives at that G and N, is refused by the plan
    function or found by the audit."""
    if how == "unbuilt":  # 3 is no power of two
        with pytest.raises(ValueError, match="lanes a cell"):
            K.delayed_batched_launch_plan(5, 100, 8, 16, 4, lanes=3)
        return
    if how == "too-many":  # 8 lanes at A 3: past the first power of two >= A
        with pytest.raises(ValueError, match="lanes a cell"):
            K.delayed_batched_launch_plan(3, 100, 4, 16, 4, lanes=8)
        plan = K.delayed_batched_launch_plan(5, 100, 8, 16, 4, lanes=8)
        bad = plan._replace(n_acceptors=3, n_proposers=4,
                            staged=K.delayed_batched_launch_plan(
                                3, 100, 4, 16, 4, lanes=4).staged)
    else:  # G 8 at N 20 takes whole blocks, G 4 one-warp tiles
        plan = K.delayed_batched_launch_plan(5, 20, 8, 16, 4, lanes=8)
        assert plan.stage_copies == 1
        bad = plan._replace(lanes=4)
    assert "thread-limit" in {f.rule for f in check_launch_plan(bad)}


def test_smem_optin_is_marked_above_48_kib():
    """A plan over 48 KiB is marked for the opt-in, and the launchers'
    allow_smem asks for it above the same 48 KiB."""
    small = K.delayed_launch_plan(5, 1000, 8, 64)
    big = K.delayed_launch_plan(5, 1000, 64, 256, window=64)
    assert not small.smem_optin and big.smem_optin
    assert big.smem_bytes > K.SMEM_NO_OPTIN >= small.smem_bytes
    for plan in (small, big):
        assert check_launch_plan(plan) == []
    text = (ROOT / LEASE_CU).read_text()
    assert sc.check_kernel_constants(text) == []
    moved = text.replace("bytes <= 48 * 1024", "bytes <= 64 * 1024")
    assert moved != text
    assert {f.rule for f in sc.check_kernel_constants(moved)} == {"smem-optin"}


def test_plane_accounting_reads_the_launchers_words():
    """Every launcher's words expression, evaluated at a plan's A, P and
    plane groups, is the plan's staged words; a launcher that loses a
    plane's columns is found for exactly the plans that carry it."""
    words = launcher_words((ROOT / LEASE_CU).read_text())
    assert set(words) == set(LAUNCHERS.values())
    for what, plan in sc.window_launch_plans(1000, 3, 5, 16, batch=5):
        assert eval_words(words[LAUNCHERS[plan.entry]], plan) == \
            plan.stage_words, what
    text = (ROOT / LEASE_CU).read_text().replace("(CORRUPT ? 2 * A : 0)",
                                                 "(CORRUPT ? A : 0)")
    for what, plan in sc.window_launch_plans(1000, 3, 5, 16, batch=5):
        rules = {f.rule for f in check_launch_plan(plan, cu_text=text)}
        assert rules == ({"plane-accounting"} if "corrupt" in plan.variant
                         else set()), what


def test_thread_and_grid_limits():
    plan = K.sync_launch_plan(5, 1000, 8, 16)
    for bad, rule in ((plan._replace(threads=96 + 16), "thread-limit"),
                      (plan._replace(threads=2048, grid=(1, 1)), "thread-limit")):
        assert rule in {f.rule for f in check_launch_plan(bad)}
    big = K.delayed_batched_launch_plan(5, 4, 8, 4, 70000)
    assert "grid-limit" in {f.rule for f in check_launch_plan(big)}
    # the batched delayed kernel: blocks of kBlock lanes, windows of at most
    # kSub ticks
    lanes = K.delayed_batched_launch_plan(5, 1000, 8, 16, 4)
    for bad in (lanes._replace(threads=2 * K.BLOCK_THREADS),
                lanes._replace(tw=K.BATCH_SUB + 1)):
        assert "thread-limit" in {f.rule for f in check_launch_plan(bad)}


def test_plane_table_equals_the_reference_and_the_docs():
    from repro.lease_array.scenario import plane_table_md as ref_table

    table = plane_table_md()
    assert table == ref_table()
    assert table in (ROOT / "docs" / "scenario_api.md").read_text()
    assert sc.check_plane_docs() == []


def test_write_plane_table_writes_under_the_root_it_is_given(tmp_path):
    docs = tmp_path / "docs"
    docs.mkdir()
    stale = ("intro\n<!-- plane-table:begin -->\n| plane |\n"
             "<!-- plane-table:end -->\noutro\n")
    (docs / "scenario_api.md").write_text(stale)
    before = (ROOT / "docs" / "scenario_api.md").read_text()
    path = sc.write_plane_table(tmp_path)
    assert path == docs / "scenario_api.md"
    text = path.read_text()
    assert text.startswith("intro\n") and text.endswith("outro\n")
    assert sc.check_plane_docs(text) == []
    assert (ROOT / "docs" / "scenario_api.md").read_text() == before


def test_cli_writes_its_json_artifact(tmp_path):
    out = tmp_path / "findings.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.staticcheck", "--json",
         str(out)], capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["n_findings"] == 0
    assert doc["checkers"] == ["intervals", "purity", "launch", "conventions",
                               "mutation"]


def test_cli_exits_1_on_findings(monkeypatch, capsys):
    from repro_torch.analysis.staticcheck import cli

    bad = sc.Finding("launch", "write-race", "here", "two threads")
    monkeypatch.setattr(cli, "_CHECKERS", (("launch", lambda: [bad]),))
    assert cli.main([]) == 1
    assert "[launch:write-race] here" in capsys.readouterr().out


def test_cli_skip_mutation_leaves_the_mutation_checker_out(monkeypatch, capsys):
    from repro_torch.analysis.staticcheck import cli

    ran = []
    monkeypatch.setattr(cli, "_CHECKERS", tuple(
        (name, (lambda name=name: ran.append(name) or []))
        for name, _ in cli._CHECKERS))
    assert cli.main(["--skip-mutation"]) == 0
    assert ran == ["intervals", "purity", "launch", "conventions"]
    assert "clean (intervals, purity, launch, conventions)" in \
        capsys.readouterr().out


def test_traced_tick_cores_are_pure():
    assert sc.check_tick_cores() == []
    assert sc.check_tick_cores(n_proposers=3, n_acceptors=3) == []


def _trace(fn, *args):
    from torch.fx.experimental.proxy_tensor import make_fx

    return make_fx(fn, tracing_mode="real")(*args)


def test_purity_flags_a_sum_without_dtype_and_passes_gather_indices():
    import torch

    from repro_torch.lease_array.netplane import legs_gather

    i32 = torch.int32
    votes = torch.zeros((5, 8), dtype=i32)
    widened = _trace(lambda v: v.sum(dim=0, keepdim=True) + 1, votes)
    kept = _trace(lambda v: v.sum(dim=0, keepdim=True, dtype=i32) + 1, votes)
    for index_exempt in (False, True):
        rules = {f.rule for f in sc.check_graph_purity(
            widened, gather_index=index_exempt)}
        assert rules == {"int64-promotion"}
        assert sc.check_graph_purity(kept, gather_index=index_exempt) == []
    link, prop = torch.zeros((4, 5), dtype=i32), torch.zeros((1, 8), dtype=i32)
    gathered = _trace(lambda lk, p: legs_gather(lk, p)[0], link, prop)
    assert any(n.meta["val"].dtype == torch.int64 for n in gathered.graph.nodes
               if "val" in n.meta)
    assert sc.check_graph_purity(gathered, gather_index=True) == []
    assert {f.rule for f in sc.check_graph_purity(gathered)} == {
        "int64-promotion"}
    # an int64 index that also feeds arithmetic is no longer index-only
    leaky = _trace(lambda lk, p: (lk.T.gather(1, p.long().expand(5, 8)),
                                  p.long() + 1), link, prop)
    assert {f.rule for f in sc.check_graph_purity(
        leaky, gather_index=True)} == {"int64-promotion"}


def test_honest_strip_clean_and_a_strip_that_keeps_a_default_plane():
    """The all-default extends plane stripped leaves the traced honest
    dispatch and its launch plan as without the plane; a strip that keeps
    every plane trips all three checks (the plane survives, the graphs
    differ, the kernel path plans the extend variant)."""
    from repro_torch.analysis.staticcheck.purity import check_honest_strip

    assert check_honest_strip() == []
    found = check_honest_strip(strip=dict, n_ticks=1)
    assert {f.rule for f in found} == {"honest-strip"}
    assert [f.where for f in found] == ["ops.strip_default_planes",
                                        "ops._window_scan_impl",
                                        "kernel.delayed_launch_plan"]
    assert "extends" in found[2].detail


def test_deprecated_shim_rule_allows_only_its_allowlist():
    """The shims may be named in ops.py and the deprecation tests only; a
    call from any other port module or test is a finding."""
    from repro_torch.analysis.staticcheck.conventions import check_source_text

    src = "from .ops import lease_plane_step_delayed\nlease_plane_step_delayed(s, n)\n"
    for ok in ("src/repro_torch/lease_array/ops.py", "tests/test_torch_deprecations.py"):
        assert check_source_text(src, ok) == []
    for bad in ("src/repro_torch/lease_array/engine.py", "src/repro_torch/lease_array/directory.py",
                "tests/test_torch_lease_engine.py"):
        assert {f.rule for f in check_source_text(src, bad)} == {"deprecated-shim"}, bad

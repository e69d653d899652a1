"""The port's analysis package (``repro_torch.analysis``) against the
reference's cases: ``tests/test_analysis_lint.py``'s, run on the port's
``astlint``, ``planlint`` and ``corpus`` and its tree (each AST rule fires
on a seeded violation, suppression works, the port's ``core/``, ``comm/``
and ``serving/`` are clean, the plan verifier catches injected defects,
the CLI gate exits 0 on a fresh corpus and 1 on an injected incast), and
the guard cases of ``tests/test_analysis_locks.py`` on the port's
``guards`` and serving classes."""

import ast
import dataclasses
import importlib
import inspect
import json
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.analysis import astlint, guards, locks, planlint
from repro_torch.analysis.corpus import emit_corpus
from repro_torch.core.plan import PermutationBlock, PermutationStage
from repro_torch.core.schedulers import get_scheduler
from repro_torch.core.traffic import ClusterSpec, balanced_workload

SRC_ROOT = "src"


def _rules(findings):
    return [f.rule for f in findings]


# -- LCK001 ---------------------------------------------------------------

def test_lck001_raw_lock():
    src = "import threading\nlock = threading.Lock()\n"
    assert _rules(astlint.lint_source(src)) == ["LCK001"]


def test_lck001_raw_rlock_and_condition():
    src = ("import threading\n"
           "a = threading.RLock()\n"
           "b = threading.Condition()\n")
    assert _rules(astlint.lint_source(src)) == ["LCK001", "LCK001"]


def test_lck001_bare_import_form():
    src = "from threading import Lock\nlock = Lock()\n"
    assert _rules(astlint.lint_source(src)) == ["LCK001"]


def test_lck001_event_not_flagged():
    src = "import threading\nev = threading.Event()\n"
    assert astlint.lint_source(src) == []


def test_lck001_noqa_suppression():
    src = "import threading\nlock = threading.Lock()  # noqa: LCK001\n"
    assert astlint.lint_source(src) == []
    src2 = "import threading\nlock = threading.Lock()  # noqa\n"
    assert astlint.lint_source(src2) == []


def test_factory_call_not_flagged():
    src = ("from repro_torch.analysis.locks import make_lock\n"
           "lock = make_lock('X._lock')\n")
    assert astlint.lint_source(src) == []


# -- LCK002 ---------------------------------------------------------------

_SPEC = {"Telemetry": ("_lock", frozenset({"_counters", "_count"}))}


def _lck002(src):
    return astlint.lint_source(src, guard_specs=_SPEC,
                               check_lck001=False)


def test_lck002_unlocked_write_flagged():
    src = ("class Telemetry:\n"
           "    def bump(self):\n"
           "        self._counters['x'] = 1\n")
    assert _rules(_lck002(src)) == ["LCK002"]


def test_lck002_locked_write_clean():
    src = ("class Telemetry:\n"
           "    def bump(self):\n"
           "        with self._lock:\n"
           "            self._counters['x'] = 1\n")
    assert _lck002(src) == []


def test_lck002_init_exempt():
    src = ("class Telemetry:\n"
           "    def __init__(self):\n"
           "        self._counters = {}\n")
    assert _lck002(src) == []


def test_lck002_locked_suffix_exempt():
    src = ("class Telemetry:\n"
           "    def _bump_locked(self):\n"
           "        self._counters['x'] = 1\n")
    assert _lck002(src) == []


def test_lck002_mutator_call_flagged():
    src = ("class Telemetry:\n"
           "    def bump(self):\n"
           "        self._counters.update(a=1)\n")
    assert _rules(_lck002(src)) == ["LCK002"]


def test_lck002_augassign_flagged():
    src = ("class Telemetry:\n"
           "    def bump(self):\n"
           "        self._count += 1\n")
    assert _rules(_lck002(src)) == ["LCK002"]


def test_lck002_delete_flagged():
    src = ("class Telemetry:\n"
           "    def drop(self):\n"
           "        del self._counters['x']\n")
    assert _rules(_lck002(src)) == ["LCK002"]


def test_lck002_unregistered_attr_clean():
    src = ("class Telemetry:\n"
           "    def bump(self):\n"
           "        self._other = 1\n")
    assert _lck002(src) == []


def test_lck002_unregistered_class_clean():
    src = ("class Whatever:\n"
           "    def bump(self):\n"
           "        self._counters['x'] = 1\n")
    assert _lck002(src) == []


# -- EXC001 ---------------------------------------------------------------

def test_exc001_swallow_flagged():
    src = ("try:\n    pass\nexcept Exception:\n    pass\n")
    assert _rules(astlint.lint_source(src)) == ["EXC001"]


def test_exc001_bare_except_flagged():
    src = ("try:\n    pass\nexcept:\n    x = 1\n")
    assert _rules(astlint.lint_source(src)) == ["EXC001"]


def test_exc001_reraise_clean():
    src = ("try:\n    pass\nexcept BaseException:\n    raise\n")
    assert astlint.lint_source(src) == []


def test_exc001_telemetry_count_clean():
    src = ("try:\n    pass\nexcept Exception:\n"
           "    tel.count('errors')\n")
    assert astlint.lint_source(src) == []


def test_exc001_capture_clean():
    src = ("err = None\ntry:\n    pass\nexcept BaseException as e:\n"
           "    err = e\n")
    assert astlint.lint_source(src) == []


def test_exc001_narrow_except_clean():
    src = ("try:\n    pass\nexcept ValueError:\n    pass\n")
    assert astlint.lint_source(src) == []


# -- DET001 ---------------------------------------------------------------

def test_det001_wall_clock_flagged():
    src = "import time\nt = time.time()\n"
    fs = astlint.lint_source(src, check_det001=True, check_lck001=False)
    assert _rules(fs) == ["DET001"]


def test_det001_unseeded_np_random_flagged():
    src = "import numpy as np\nx = np.random.rand(3)\n"
    fs = astlint.lint_source(src, check_det001=True, check_lck001=False)
    assert _rules(fs) == ["DET001"]


def test_det001_seeded_rng_and_perf_counter_clean():
    src = ("import time\nimport numpy as np\n"
           "rng = np.random.default_rng(0)\n"
           "t = time.perf_counter()\nm = time.monotonic()\n")
    assert astlint.lint_source(src, check_det001=True,
                               check_lck001=False) == []


def test_det001_off_outside_core():
    src = "import time\nt = time.time()\n"
    assert astlint.lint_source(src, check_det001=False) == []


# -- the repo itself is clean --------------------------------------------

def test_repo_tree_clean():
    findings = astlint.lint_tree(SRC_ROOT)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_comm_in_scope_with_det001():
    """comm/ rides the DET001 determinism contract: the plan lowering
    (comm/plan_exec.py) bakes plans into traced programs, so wall-clock /
    unseeded-random use there is as replay-hostile as in core/."""
    import os

    path = os.path.join(SRC_ROOT, "repro_torch", "comm", "plan_exec.py")
    # in scope and clean as shipped
    assert astlint.lint_file(path, SRC_ROOT) == []
    # DET001 actually armed for a comm module path
    dirty = "import time\nt = time.time()\n"
    findings = astlint.lint_source(
        dirty, path=path, module="repro_torch.comm.plan_exec",
        check_det001=True)
    assert [f.rule for f in findings] == ["DET001"]
    # models/ (for example) stays out of scope
    other = os.path.join(SRC_ROOT, "repro_torch", "models", "moe.py")
    assert astlint.lint_file(other, SRC_ROOT) == []


# -- planlint -------------------------------------------------------------

C = ClusterSpec(4, 2)


def _plan():
    return get_scheduler("flash").synthesize(balanced_workload(C, 1e6))


def _codes(issues):
    return [i["code"] for i in issues]


def test_planlint_clean_plan():
    assert planlint.check_plan(_plan()) == []


def test_planlint_all_schedulers_clean():
    w = balanced_workload(C, 1e6)
    from repro_torch.core.schedulers import SCHEDULERS
    for name in sorted(SCHEDULERS):
        plan = get_scheduler(name).synthesize(w)
        issues = planlint.check_plan(plan, source=name)
        assert issues == [], issues


def test_planlint_injected_incast():
    plan = _plan()
    bad_stage = PermutationStage(perm=(1, 0, 0, -1), size=10.0,
                                 sent=(10.0, 10.0, 10.0, 0.0))
    bad = dataclasses.replace(plan, phases=plan.phases + (bad_stage,))
    issues = planlint.check_plan(bad)
    assert "PLAN-STRUCT" in _codes(issues)
    assert any("incast" in i["message"] for i in issues)


def test_planlint_injected_self_traffic():
    plan = _plan()
    bad_stage = PermutationStage(perm=(0, 2, 1, -1), size=10.0,
                                 sent=(10.0, 10.0, 10.0, 0.0))
    bad = dataclasses.replace(plan, phases=plan.phases + (bad_stage,))
    issues = planlint.check_plan(bad)
    assert any("self-traffic" in i["message"] for i in issues)


def test_planlint_injected_slot_overflow():
    plan = _plan()
    bad_stage = PermutationStage(perm=(1, 2, 3, 0), size=5.0,
                                 sent=(10.0, 1.0, 1.0, 1.0))
    bad = dataclasses.replace(plan, phases=plan.phases + (bad_stage,))
    issues = planlint.check_plan(bad)
    assert any("exceeds slot size" in i["message"] for i in issues)


def test_planlint_descending_stage_order():
    plan = _plan()
    s1 = PermutationStage(perm=(1, 2, 3, 0), size=100.0, sent=(100.0,) * 4)
    s2 = PermutationStage(perm=(2, 3, 0, 1), size=10.0, sent=(10.0,) * 4)
    bad = dataclasses.replace(plan, phases=(s1, s2))
    issues = planlint.check_plan(bad)
    assert "PLAN-ORDER" in _codes(issues)


def test_planlint_block_exempt_from_order():
    """Repair blocks keep stored order by design: no PLAN-ORDER issue."""
    plan = _plan()
    block = PermutationBlock(
        perms=np.array([[1, 2, 3, 0], [2, 3, 0, 1]]),
        sizes=np.array([100.0, 10.0]),
        sent=np.array([[100.0] * 4, [10.0] * 4]))
    bad = dataclasses.replace(plan, phases=(block,))
    assert "PLAN-ORDER" not in _codes(planlint.check_plan(bad))


def test_planlint_shape_mismatch():
    plan = _plan()
    short = PermutationStage(perm=(1, 0), size=1.0, sent=(1.0, 1.0))
    bad = dataclasses.replace(plan, phases=plan.phases + (short,))
    issues = planlint.check_plan(bad)
    assert "PLAN-SHAPE" in _codes(issues)


def test_planlint_file_roundtrip(tmp_path):
    plan = _plan()
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan.to_dict()))
    assert planlint.check_file(str(path)) == []


def test_planlint_file_with_bad_plan(tmp_path):
    plan = _plan()
    bad_stage = PermutationStage(perm=(1, 0, 0, -1), size=10.0,
                                 sent=(10.0, 10.0, 10.0, 0.0))
    bad = dataclasses.replace(plan, phases=plan.phases + (bad_stage,))
    path = tmp_path / "plans.json"
    path.write_text(json.dumps([plan.to_dict(), bad.to_dict()]))
    issues = planlint.check_file(str(path))
    assert issues and all("[1]" in i["source"] for i in issues)


def test_planlint_unreadable_file(tmp_path):
    path = tmp_path / "garbage.json"
    path.write_text("{not json")
    issues = planlint.check_file(str(path))
    assert _codes(issues) == ["PLAN-IO"]


def test_audit_cache_clean_and_family_mismatch():
    from repro_torch.core.plan import PlanCache, plan_family_key

    cache = PlanCache(capacity=8)
    plan = _plan()
    cache.insert("k1", plan)
    rep = planlint.audit_cache(cache)
    assert rep["clean"] and rep["plans"] == 1

    # Corrupt the family index: point a foreign family key at the plan.
    with cache._lock:
        cache._family["deadbeef" * 4] = "k1"
        cache._family_count["deadbeef" * 4] = 1
    rep = planlint.audit_cache(cache)
    assert not rep["clean"]
    assert any(i["code"] == "CACHE-FAMILY" for i in rep["issues"])
    assert plan_family_key(plan) != "deadbeef" * 4


# -- corpus + CLI gate ----------------------------------------------------

def test_corpus_emission_and_check(tmp_path):
    out = tmp_path / "corpus"
    written = emit_corpus(str(out), algorithms=["flash", "fanout"])
    assert len(written) == 5
    result = planlint.check_paths([str(out)])
    assert result["clean"], result["issues"]
    assert result["plans"] == 10  # 5 workloads x 2 algorithms


def test_cli_gate_exits_zero_on_clean_corpus(tmp_path):
    out = tmp_path / "corpus"
    emit_corpus(str(out), algorithms=["flash"])
    report = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--planlint",
         "--corpus", str(out), "--json", str(report)],
        capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(report.read_text())
    assert data["clean"] is True
    assert data["passes"]["planlint"]["plans"] == 5


def test_cli_gate_fails_on_injected_incast(tmp_path):
    plan = _plan()
    bad_stage = PermutationStage(perm=(1, 0, 0, -1), size=10.0,
                                 sent=(10.0, 10.0, 10.0, 0.0))
    bad = dataclasses.replace(plan, phases=plan.phases + (bad_stage,))
    out = tmp_path / "corpus"
    out.mkdir()
    (out / "bad.json").write_text(json.dumps([bad.to_dict()]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--planlint",
         "--corpus", str(out)],
        capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 1
    assert "incast" in proc.stdout


def test_cli_astlint_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--astlint"],
        capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- the CLI's --all on a fresh corpus ------------------------------------------

def test_cli_all_exits_zero_on_a_fresh_corpus(tmp_path):
    report = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all", "--json",
         str(report)],
        capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
             "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(report.read_text())
    assert data["schema"] == 1 and data["clean"] is True
    assert data["passes"]["astlint"]["clean"] is True
    assert data["passes"]["planlint"]["plans"] > 0


def test_lint_tree_walks_the_port_alone():
    """lint_tree walks repro_torch/{core,comm,serving}, none of the
    reference's modules."""
    import os

    seen = []
    real = astlint.lint_paths
    try:
        astlint.lint_paths = lambda paths, root: seen.extend(paths) or []
        astlint.lint_tree(SRC_ROOT)
    finally:
        astlint.lint_paths = real
    subs = {os.path.relpath(os.path.dirname(p), SRC_ROOT) for p in seen}
    assert subs == {os.path.join("repro_torch", s)
                    for s in ("core", "comm", "serving")}


# -- the guarded-state registry (tests/test_analysis_locks.py's cases) -------

@pytest.fixture
def _clean_locks():
    locks.reset()
    locks.disable()
    yield
    locks.reset()
    locks.disable()


def test_registry_covers_serving_classes():
    classes = {(s.module, s.cls_name) for s in guards.REGISTRY}
    assert ("repro_torch.serving.server", "PlanServer") in classes
    assert ("repro_torch.core.plan", "PlanCache") in classes
    assert ("repro_torch.serving.queue", "TieredQueue") in classes
    assert ("repro_torch.serving.telemetry", "Telemetry") in classes


def test_registry_names_the_reference_classes_in_the_port():
    from repro.analysis import guards as ref_guards

    assert [(s.module.replace("repro.", "repro_torch.", 1), s.cls_name,
             s.lock_attr, s.attrs) for s in ref_guards.REGISTRY] == [
        (s.module, s.cls_name, s.lock_attr, s.attrs)
        for s in guards.REGISTRY]


@pytest.mark.parametrize("spec", guards.REGISTRY,
                         ids=lambda s: s.cls_name)
def test_registry_entry_exists_in_the_port(spec):
    """Each entry's class is in the port's module and its ``__init__``
    sets the lock attribute and every guarded attribute."""
    module = importlib.import_module(spec.module)
    assert isinstance(getattr(module, spec.cls_name), type)
    tree = ast.parse(inspect.getsource(module))
    cls = next(n for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef) and n.name == spec.cls_name)
    init = next(f for f in cls.body
                if isinstance(f, ast.FunctionDef) and f.name == "__init__")
    assigned = {e.attr for n in ast.walk(init)
                if isinstance(n, (ast.Assign, ast.AnnAssign))
                for t in (n.targets if isinstance(n, ast.Assign)
                          else [n.target])
                for e in ast.walk(t)
                if isinstance(e, ast.Attribute)
                and isinstance(e.value, ast.Name) and e.value.id == "self"}
    assert {spec.lock_attr, *spec.attrs} <= assigned


def test_guard_violation_on_unlocked_write(_clean_locks):
    from repro_torch.serving.telemetry import Telemetry

    locks.enable()
    guards.install()
    try:
        tel = Telemetry()
        tel.count("ok")  # locked write: clean
        assert guards.guard_violations() == []
        # Unlocked write to a registered attribute from outside.
        tel._counters = {}
        vs = guards.guard_violations()
        assert len(vs) == 1
        assert vs[0].cls_name == "Telemetry"
        assert vs[0].attr == "_counters"
    finally:
        guards.uninstall()
        guards.reset_violations()


def test_guard_init_writes_exempt(_clean_locks):
    from repro_torch.serving.telemetry import Telemetry

    locks.enable()
    guards.install()
    try:
        Telemetry()  # constructor writes all registered attrs, unlocked
        assert guards.guard_violations() == []
    finally:
        guards.uninstall()
        guards.reset_violations()


def test_guard_normal_serving_flow_clean(_clean_locks):
    from repro_torch.core.traffic import ClusterSpec, balanced_workload
    from repro_torch.serving.queue import PlanRequest, TieredQueue

    locks.enable()
    guards.install()
    try:
        q = TieredQueue(max_depth=8)
        w = balanced_workload(ClusterSpec(2, 2), 1e3)
        q.put(PlanRequest(workload=w, algorithm="flash"))
        assert q.get(timeout=1.0) is not None
        q.close()
        assert guards.guard_violations() == []
    finally:
        guards.uninstall()
        guards.reset_violations()


def test_guard_uninstall_restores(_clean_locks):
    from repro_torch.serving.telemetry import Telemetry

    locks.enable()
    guards.install()
    guards.uninstall()
    guards.reset_violations()
    tel = Telemetry()
    tel._counters = {"raw": 1}  # no longer instrumented
    assert guards.guard_violations() == []


def test_guard_report_names_the_port():
    rep = guards.report()
    assert {c["module"] for c in rep["classes"]} == {
        s.module for s in guards.REGISTRY}
    assert all(m.startswith("repro_torch.") for m in
               (c["module"] for c in rep["classes"]))

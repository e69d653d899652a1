"""The plan-serving daemon in the port (``serving/``, copied from the
reference) and ``launch/serve.py --plan-server``.

* ``_plan_dispatch_schedules(16, use_plan_server=True)`` against the
  reference's on the handoff line: schedules, lowered, memoized and stage
  counts, and the daemon's ``hits`` and ``warm + cold``.  The daemon's
  ``warm``, ``cold`` and ``upgrades`` apart, and the mean completion time
  that follows them, are racy in the reference itself (a background
  upgrade may or may not land before a repeat: ``warm=0 cold=13
  upgrades=0`` or ``warm=1 cold=12 upgrades=1`` from one run to the next
  on the same code), so they are not compared one by one.
* ``PlanClient.get_device_schedule`` lowers through the port's own
  ``comm.plan_exec``, to the same stage tables as the reference's lowering
  of the same workload.
* The CLI routes ``--plan-server`` through the daemon and refuses an
  encoder-decoder arch.
"""

import re

import pytest

from repro.comm import plan_exec as ref_plan_exec
from repro.launch import serve as ref_serve
from repro.serving import PlanClient as RefPlanClient
from repro.serving import PlanServer as RefPlanServer
from repro_torch.comm import plan_exec
from repro_torch.core.traffic import ClusterSpec, moe_workload
from repro_torch.launch import serve
from repro_torch.serving import PlanClient, PlanServer

_HANDOFF = re.compile(r"device handoff: (\d+) schedules, (\d+) lowered "
                      r"\((\d+) memoized\); stage counts \[([\d, ]*)\]")
_ROUTE = re.compile(r"plan-server: hits=(\d+) warm=(\d+) cold=(\d+) "
                    r"upgrades=(\d+)")


def _counts(text):
    handoff = _HANDOFF.search(text)
    route = _ROUTE.search(text)
    assert handoff and route, text
    n, lowered, memo, stages = handoff.groups()
    hits, warm, cold, _ = (int(v) for v in route.groups())
    return {"schedules": int(n), "lowered": int(lowered),
            "memoized": int(memo),
            "stage_counts": [int(v) for v in stages.split(",")],
            "hits": hits, "warm+cold": warm + cold}


def test_plan_server_handoff_matches_reference(capsys):
    ref_serve._plan_dispatch_schedules(16, True)
    ref = _counts(capsys.readouterr().out)
    out = serve._plan_dispatch_schedules(16, True)
    got = _counts(capsys.readouterr().out)
    assert got == ref
    assert ref["schedules"] == 16 and ref["memoized"] > 0
    # the returned summary is the printed line's
    assert {k: out[k] for k in ("schedules", "lowered", "memoized",
                                "stage_counts")} == {
        k: got[k] for k in ("schedules", "lowered", "memoized",
                            "stage_counts")}
    assert out["counters"]["hits"] == got["hits"]


def test_inline_planning_matches_reference(capsys):
    ref_serve._plan_dispatch_schedules(8, False)
    ref = capsys.readouterr().out
    out = serve._plan_dispatch_schedules(8, False)
    got = capsys.readouterr().out
    pattern = re.compile(r"\[(inline: [^\]]*)\].*completion ([\d.]+)us")
    assert pattern.search(got).groups() == pattern.search(ref).groups()
    assert out["route"] == pattern.search(got).group(1)


def test_device_schedule_lowers_through_the_port():
    w = moe_workload(ClusterSpec(n_servers=4, m_gpus=8), tokens_per_gpu=2048,
                     bytes_per_token=2, seed=3)
    with PlanServer(workers=1) as srv:
        client = PlanClient(srv, algorithm="flash")
        answer, sched = client.get_device_schedule(w)
        again, sched2 = client.get_device_schedule(w)
    assert isinstance(sched, plan_exec.DeviceSchedule)
    assert sched2 is sched and client.counters["lowered"] == 1
    assert plan_exec.is_lowered(answer.plan)

    from repro.core.traffic import ClusterSpec as RefClusterSpec
    from repro.core.traffic import moe_workload as ref_moe_workload
    rw = ref_moe_workload(RefClusterSpec(n_servers=4, m_gpus=8),
                          tokens_per_gpu=2048, bytes_per_token=2, seed=3)
    with RefPlanServer(workers=1) as srv:
        _, ref_sched = RefPlanClient(srv, algorithm="flash") \
            .get_device_schedule(rw)
    assert isinstance(ref_sched, ref_plan_exec.DeviceSchedule)
    for field in ("n_pods", "pairs", "dst_of", "src_of", "n_plan_stages",
                  "n_fallback_stages", "plan_fingerprint", "algorithm"):
        assert getattr(sched, field) == getattr(ref_sched, field), field


def test_cli_routes_through_the_daemon(capsys):
    serve.main(["--arch", "xlstm-125m", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "4", "--gen-len", "4",
                "--plan-server"])
    out = capsys.readouterr().out
    assert "arch=xlstm-125m-smoke" in out
    assert _counts(out)["schedules"] == 4


def test_cli_refuses_an_encoder_decoder(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu"])
    assert exc.value.code == 2
    assert "encoder-decoder" in capsys.readouterr().err

"""CI gate: ``python -m repro_torch.analysis --all``.

Runs the static passes and exits nonzero on any finding:

  * ``--astlint``  -- the LCK001/LCK002/EXC001/DET001 rules over every
    ``core/`` and ``serving/`` module (analysis/astlint.py).
  * ``--planlint`` -- the workload-independent plan verifier over a
    golden plan corpus (analysis/planlint.py).  ``--corpus DIR`` points
    at an existing corpus (e.g. one emitted by
    ``python -m benchmarks.emit_corpus``); without it, a fresh corpus is
    synthesized into a temporary directory first.
  * ``--all``      -- both.

``--json PATH`` additionally writes the full machine-readable report
(uploaded as a CI artifact alongside the benchmark JSON).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from . import astlint, planlint

ANALYSIS_SCHEMA_VERSION = 1


def _src_root() -> str:
    """The directory containing the ``repro_torch`` package."""
    # .../repro_torch/analysis
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(pkg_dir))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static concurrency & plan-IR analysis gate.")
    ap.add_argument("--astlint", action="store_true",
                    help="run the AST rules over core/, comm/ and serving/")
    ap.add_argument("--planlint", action="store_true",
                    help="verify a plan corpus (see --corpus)")
    ap.add_argument("--all", action="store_true",
                    help="every pass (what CI runs)")
    ap.add_argument("--corpus", default=None, metavar="DIR",
                    help="plan-corpus directory for --planlint; "
                    "synthesized fresh into a temp dir when omitted")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable report here")
    args = ap.parse_args(argv)

    run_ast = args.astlint or args.all
    run_plan = args.planlint or args.all
    if not (run_ast or run_plan):
        ap.error("pick at least one of --astlint / --planlint / --all")

    report = {"schema": ANALYSIS_SCHEMA_VERSION, "passes": {}}
    failed = False

    if run_ast:
        findings = astlint.lint_tree(_src_root())
        report["passes"]["astlint"] = {
            "findings": [f.to_dict() for f in findings],
            "clean": not findings,
        }
        for f in findings:
            print(f.format())
        print(f"astlint: {len(findings)} finding(s) over core/, "
              "comm/ and serving/")
        failed = failed or bool(findings)

    if run_plan:
        tmp = None
        corpus_dir = args.corpus
        if corpus_dir is None:
            from . import corpus as corpus_mod
            tmp = tempfile.TemporaryDirectory(prefix="plan_corpus_")
            corpus_dir = tmp.name
            print(f"planlint: synthesizing golden corpus in {corpus_dir}")
            corpus_mod.emit_corpus(corpus_dir)
        result = planlint.check_paths([corpus_dir])
        report["passes"]["planlint"] = result
        for issue in result["issues"]:
            print(f"{issue['source']}: {issue['code']} "
                  f"{issue['message']}")
        print(f"planlint: {result['plans']} plan(s) in "
              f"{result['files']} file(s), "
              f"{len(result['issues'])} issue(s)")
        failed = failed or not result["clean"]
        if tmp is not None:
            tmp.cleanup()

    report["clean"] = not failed
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"report written to {args.json}")

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

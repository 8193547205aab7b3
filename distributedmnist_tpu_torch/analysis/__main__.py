"""The port's check CLI: ``python -m distributedmnist_tpu_torch.analysis``
(≙ ``python -m distributedmnist_tpu.analysis``).

Exit status is the CI gate: 0 when every finding is baselined (or the
tree is clean), 1 when any non-baselined finding exists, 2 when the
baseline names findings that no longer fire (stale entries must be
pruned so the file stays an honest ledger).

The default roots are the port's own files: the package,
``tests/test_torch_*.py`` and ``tests/_torch_*.py`` (the reference's
tests are the reference's checks' business).

Typical runs::

    python -m distributedmnist_tpu_torch.analysis                  # text
    python -m distributedmnist_tpu_torch.analysis --format json    # CI
    python -m distributedmnist_tpu_torch.analysis --checkers schema,config
    python -m distributedmnist_tpu_torch.analysis --write-baseline # accept
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .core import (CHECKERS, baseline_to_json, iter_sources,
                   load_baseline, run_checkers)


def default_roots(repo_root: Path) -> list[str]:
    """The port's package and the port's own test files."""
    tests = repo_root / "tests"
    return ([str(repo_root / "distributedmnist_tpu_torch")]
            + [str(p) for pattern in ("test_torch_*.py", "_torch_*.py")
               for p in sorted(tests.glob(pattern))])


def main(argv: list[str] | None = None) -> int:
    repo_root = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(
        prog="python -m distributedmnist_tpu_torch.analysis",
        description="the port's contract-aware static checks")
    ap.add_argument("roots", nargs="*", default=default_roots(repo_root),
                    help="files/directories to analyze (default: the "
                         "port's package and its test files)")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    ap.add_argument("--output", default=None,
                    help="also write the findings JSON here (the CI "
                         "artifact)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: the checked-in "
                         "analysis/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the baseline "
                         "skeleton to stdout and exit 0")
    ap.add_argument("--checkers", default=None,
                    help="comma-separated subset (default: all)")
    args = ap.parse_args(argv)

    # resolve checker names BEFORE any analysis work: a typo'd
    # --checkers must fail as a usage error (argparse's own exit
    # path), not after parsing the whole tree
    names = (set(args.checkers.split(",")) if args.checkers else None)
    if names is not None:
        from . import (config_check, durability_check,  # noqa: F401
                       net_check, paged_check, schema_check,
                       threads_check, torch_check)
        unknown = names - set(CHECKERS)
        if unknown:
            ap.error(f"unknown checker(s): "
                     f"{', '.join(sorted(unknown))}; available: "
                     f"{', '.join(sorted(CHECKERS))}")
    sources = iter_sources(args.roots, repo_root=repo_root)
    findings = run_checkers(sources, names)

    if args.write_baseline:
        sys.stdout.write(baseline_to_json(findings))
        return 0

    baseline = ({} if args.no_baseline
                else load_baseline(args.baseline))
    # staleness is only judgeable for entries this run could have
    # reproduced: the checker must have run AND the file must be among
    # the analyzed sources — a targeted invocation (subset roots or
    # --checkers) must not read untested suppressions as stale
    # run_checkers emits "parse" findings unconditionally, so their
    # baseline entries are always judgeable for staleness
    ran = (names or set(CHECKERS)) | {"parse"}
    analyzed = {s.path for s in sources}
    new = [f for f in findings if f.key not in baseline]
    fired = {f.key for f in findings}
    stale = sorted(
        k for k in baseline
        if k not in fired
        and k.split(":", 2)[0] in ran
        and (k.split(":", 2) + [""])[1] in analyzed)

    report = {
        "checkers": sorted(ran),
        "files_analyzed": len(sources),
        "findings": [f.to_dict() for f in findings],
        "new": [f.to_dict() for f in new],
        "baselined": sorted(fired & set(baseline)),
        "stale_baseline": stale,
        "ok": not new and not stale,
    }
    if args.output:
        Path(args.output).write_text(json.dumps(report, indent=2))
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        for f in findings:
            mark = " (baselined)" if f.key in baseline else ""
            print(f"{f.path}:{f.line}: [{f.checker}]{mark} {f.message}")
        for k in stale:
            print(f"STALE baseline entry (no longer fires): {k}")
        print(f"analysis: {len(findings)} finding(s), "
              f"{len(new)} new, "
              f"{len(fired & set(baseline))} baselined, "
              f"{len(stale)} stale baseline entr(ies) "
              f"over {len(sources)} files")
    if new:
        return 1
    if stale:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())

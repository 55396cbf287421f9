"""``python -m trino_tpu_torch.analysis`` — run qlint over a package
(default: ``trino_tpu_torch/``).

Exit codes: 0 clean (every finding baselined), 1 non-baselined
findings OR stale baseline entries (the baseline may only shrink),
2 usage error. The analysis package itself is pure stdlib ``ast``
(never imports the analyzed code or torch; the ``-m`` entry loads the
parent package's ``__init__``, which imports nothing eagerly).

``--changed-since <rev>`` is the pre-commit gate shape: the FULL
index is still built (call graphs are whole-program — a pass run on a
file subset would silently lose interprocedural findings), but only
findings located in files the git diff touched are reported. Stale-
baseline enforcement is skipped in that mode (a partial view cannot
prove an entry dead).

``--json`` emits a SARIF 2.1.0 document (one run, one result per
non-baselined finding, baselined findings carried with an external
suppression) so editors/CI ingest it directly; qlint's native payload
rides in ``runs[0].properties``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from . import (PASSES, ProjectIndex, apply_baseline, default_baseline_path,
               load_baseline, run_passes)

_SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                 "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def _git_toplevel(start_dir: str):
    """The git working-tree root governing ``start_dir`` — diff paths
    are relative to THIS, not to the analyzed package's parent (a
    package nested below the git root would otherwise never
    intersect the diff and the gate would silently pass)."""
    try:
        out = subprocess.run(
            ["git", "-C", start_dir, "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    top = out.stdout.strip()
    return top or None


def _changed_files(git_root: str, rev: str):
    """git-root-relative paths changed since ``rev`` (committed +
    working tree + UNTRACKED — a brand-new module's findings must not
    silently skip the pre-commit gate before `git add`), or None on
    git failure (caller reports rc 2)."""
    try:
        diff = subprocess.run(
            ["git", "-C", git_root, "diff", "--name-only", rev, "--"],
            capture_output=True, text=True, timeout=30)
        untracked = subprocess.run(
            ["git", "-C", git_root, "ls-files", "--others",
             "--exclude-standard"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if diff.returncode != 0 or untracked.returncode != 0:
        return None
    return {line.strip()
            for out in (diff.stdout, untracked.stdout)
            for line in out.splitlines() if line.strip()}


def _module_paths(index: ProjectIndex, repo_root: str):
    """module name -> repo-relative source path. Both sides resolve
    symlinks: `git rev-parse --show-toplevel` reports the PHYSICAL
    path, so a checkout reached through a symlink (macOS /tmp, linked
    worktrees) would otherwise never intersect the diff and the gate
    would silently pass."""
    root = os.path.realpath(repo_root)
    out = {}
    for name, mod in index.modules.items():
        if mod.path and mod.path != "<memory>":
            rel = os.path.relpath(os.path.realpath(mod.path), root)
            # git (and SARIF artifact URIs) always use forward
            # slashes; a Windows os.sep would never intersect the
            # diff and silently pass the gate
            out[name] = rel.replace(os.sep, "/")
    return out


def to_sarif(package_path: str, passes, new, suppressed, stale,
             module_paths) -> dict:
    """SARIF 2.1.0 shape: new findings as plain results, baselined
    ones as results with an external suppression; the legacy qlint
    payload rides in run properties."""
    rule_ids = sorted({f"{f.pass_id}/{f.rule}"
                       for f in list(new) + list(suppressed)})

    def result(f, suppressed_entry: bool) -> dict:
        uri = module_paths.get(f.module,
                               f.module.replace(".", "/") + ".py")
        out = {
            "ruleId": f"{f.pass_id}/{f.rule}",
            "level": "error",
            "message": {"text": f.render()},
            "locations": [{"physicalLocation": {
                "artifactLocation": {"uri": uri},
                "region": {"startLine": f.line}}}],
            "partialFingerprints": {"qlintKey": f.key},
        }
        if suppressed_entry:
            out["suppressions"] = [{"kind": "external",
                                    "justification": "baselined"}]
        return out

    return {
        "$schema": _SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "qlint",
                "rules": [{"id": r} for r in rule_ids],
            }},
            "results": [result(f, False) for f in new]
            + [result(f, True) for f in suppressed],
            "properties": {
                "package": package_path,
                "passes": list(passes),
                "new": [f.to_dict() for f in new],
                "suppressed": [f.to_dict() for f in suppressed],
                "stale_baseline_keys": list(stale),
            },
        }],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m trino_tpu_torch.analysis",
        description="qlint: repo-native static analysis "
                    "(trace-purity, lock-order, recompile, "
                    "session-props, taxonomy, blocked-protocol, "
                    "cache-coherence, resource-lifecycle, "
                    "guarded-by)")
    parser.add_argument("path", nargs="?", default=None,
                        help="package directory to analyze "
                             "(default: the trino_tpu_torch package)")
    parser.add_argument("--passes", default=None,
                        help="comma-separated pass subset "
                             f"(default: all of {','.join(PASSES)})")
    parser.add_argument("--json", action="store_true",
                        help="SARIF 2.1.0 on stdout (qlint payload in "
                             "runs[0].properties)")
    parser.add_argument("--changed-since", default=None, metavar="REV",
                        help="report only findings in files the git "
                             "diff since REV touched (full-index "
                             "analysis, diff-filtered report — the "
                             "fast pre-commit gate)")
    parser.add_argument("--baseline", default=None,
                        help="suppression file "
                             "(default: the scanned package's "
                             "analysis/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, ignore the "
                             "baseline")
    parser.add_argument("--write-baseline", action="store_true",
                        help="bootstrap/retriage: write ALL current "
                             "findings to the baseline file (each "
                             "entry still needs a hand-written triage "
                             "note before it is reviewable)")
    args = parser.parse_args(argv)

    package_path = args.path or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    if not os.path.isdir(package_path):
        print(f"not a directory: {package_path}", file=sys.stderr)
        return 2
    passes = None
    if args.passes:
        passes = [p.strip() for p in args.passes.split(",") if p.strip()]
        unknown = [p for p in passes if p not in PASSES]
        if unknown:
            print(f"unknown passes: {', '.join(unknown)} "
                  f"(expected from {', '.join(PASSES)})",
                  file=sys.stderr)
            return 2
        if args.write_baseline:
            # a subset run would rewrite the file WITHOUT the other
            # passes' triaged entries — silently destroying them
            print("--write-baseline requires a full run "
                  "(drop --passes)", file=sys.stderr)
            return 2
    if args.write_baseline and args.changed_since:
        print("--write-baseline requires a full report "
              "(drop --changed-since)", file=sys.stderr)
        return 2

    repo_root = os.path.dirname(os.path.abspath(package_path))
    changed = None
    if args.changed_since:
        # the git probe runs BEFORE the index build: a docs-only diff
        # must not pay the full multi-second analysis in a pre-commit
        # hook just to discover there was nothing to analyze. Diff
        # paths are relative to the GIT top-level, which is not
        # necessarily the package's parent directory
        git_root = _git_toplevel(repo_root) or repo_root
        changed = _changed_files(git_root, args.changed_since)
        if changed is None:
            print(f"git diff --name-only {args.changed_since} failed "
                  f"under {git_root}", file=sys.stderr)
            return 2
        repo_root = git_root
        if not any(p.endswith(".py") for p in changed):
            # a docs/config-only diff is NOT the same log line as an
            # empty-findings clean run: say so explicitly so CI logs
            # distinguish "nothing to analyze" from "analyzed, clean"
            print(f"qlint: no analyzable changes — the diff since "
                  f"{args.changed_since} touches no Python files "
                  f"({len(changed)} file(s) changed)", file=sys.stderr)
            if args.json:
                print(json.dumps(to_sarif(
                    package_path, passes or list(PASSES), [], [], [],
                    {}), indent=1))
            return 0

    cpu0 = time.process_time()
    index = ProjectIndex.from_package(package_path)
    findings = run_passes(index, passes)
    cpu_s = time.process_time() - cpu0
    module_paths = _module_paths(index, repo_root)

    changed_note = ""
    if changed is not None:
        before = len(findings)
        findings = [f for f in findings
                    if module_paths.get(f.module) in changed]
        changed_note = (f" [changed-since {args.changed_since}: "
                        f"{len(changed)} file(s), "
                        f"{before - len(findings)} finding(s) outside "
                        f"the diff]")

    baseline_path = args.baseline or default_baseline_path(package_path)
    baseline = {} if args.no_baseline else load_baseline(baseline_path)
    if passes is not None:
        # a pass subset can neither fire nor prove dead the other
        # passes' entries: they are out of this run's view
        selected = set(passes) | {"pragma"}
        baseline = {k: v for k, v in baseline.items()
                    if k.split(":", 1)[0] in selected}
    new, suppressed, stale = apply_baseline(findings, baseline)
    if args.changed_since:
        # a diff-filtered run cannot prove a baseline entry dead
        stale = []

    if args.write_baseline:
        # preserve existing triage notes even under --no-baseline
        # (which only affects reporting, not the file's contents)
        notes = load_baseline(baseline_path)
        payload = {"comment": "qlint suppressions — pre-existing "
                              "findings only; this file may only "
                              "shrink",
                   "findings": [{"key": f.key,
                                 "note": notes.get(f.key,
                                                   "TODO: triage")}
                                for f in findings]}
        with open(baseline_path, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=False)
            fh.write("\n")
        print(f"wrote {len(findings)} entries to {baseline_path}",
              file=sys.stderr)

    if args.json:
        print(json.dumps(to_sarif(
            package_path, passes or list(PASSES), new, suppressed,
            stale, module_paths), indent=1))
    else:
        for f in new:
            print(f.render())
        for key in stale:
            print(f"STALE baseline entry no longer fires "
                  f"(remove it): {key}")
        print(f"qlint: {len(new)} finding(s), "
              f"{len(suppressed)} baselined, {len(stale)} stale "
              f"baseline entr{'y' if len(stale) == 1 else 'ies'} "
              f"over {len(index.modules)} modules in {cpu_s:.2f} CPU s"
              f"{changed_note}", file=sys.stderr)
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())

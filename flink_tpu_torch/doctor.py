"""``python -m flink_tpu_torch.doctor`` — the pipeline doctor CLI, a copy
of flink_tpu/doctor.py with its names changed.

Runs the ranked-findings rule engine (flink_tpu_torch/metrics/doctor.py)
over a telemetry snapshot and reports what to change. The snapshot is
either a JSON file (a saved ``env._doctor_report()`` payload, or one
assembled by hand / in tests) or fetched from a web monitor's doctor
endpoint with ``--url`` (the reference serves one; the port has none
yet, ROADMAP queue 1, item 15).

Exit codes mirror ``tools.lint``: 0 the pipeline is clean, 1 findings
were reported, 2 the doctor itself failed (unreadable snapshot, bad
URL, malformed JSON) — so CI and cron wrappers can tell "healthy"
from "sick" from "the check is broken".

Usage:
    python -m flink_tpu_torch.doctor snapshot.json
    python -m flink_tpu_torch.doctor snapshot.json --json
    python -m flink_tpu_torch.doctor --url http://host:8081/jobs/<jid>/doctor
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict

from flink_tpu_torch.metrics.doctor import diagnose

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_ERROR = 2


def _load_snapshot(args) -> Dict[str, Any]:
    if args.url:
        from urllib.request import urlopen

        with urlopen(args.url, timeout=args.timeout) as resp:
            data = json.loads(resp.read().decode("utf-8"))
    else:
        with open(args.snapshot, "r", encoding="utf-8") as f:
            data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError("snapshot must be a JSON object")
    return data


def _render_text(payload: Dict[str, Any]) -> str:
    lines = []
    findings = payload.get("findings", [])
    if not findings:
        lines.append("doctor: pipeline is clean "
                     f"({len(payload.get('rules', []))} rules checked)")
        return "\n".join(lines)
    lines.append(f"doctor: {len(findings)} finding(s), ranked:")
    for i, f in enumerate(findings, 1):
        lines.append(
            f"\n{i}. [{f['severity'].upper()}] {f['rule']} "
            f"(score {f['score']})"
        )
        lines.append(f"   {f['summary']}")
        ev = f.get("evidence") or {}
        if ev:
            lines.append("   evidence: " + json.dumps(ev, sort_keys=True))
        rem = f.get("remedy") or {}
        if rem:
            lines.append(
                f"   remedy: {rem.get('key')} — {rem.get('suggestion')}"
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flink_tpu_torch.doctor",
        description="rank pipeline-health findings from a telemetry "
                    "snapshot (exit 0 clean / 1 findings / 2 error)",
    )
    ap.add_argument("snapshot", nargs="?",
                    help="path to a snapshot JSON (a saved "
                         "/jobs/<jid>/doctor payload with its "
                         "'snapshot' block, or a hand-assembled one)")
    ap.add_argument("--url",
                    help="fetch the snapshot live from a web-monitor "
                         "doctor endpoint instead of a file")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the stable machine-readable payload")
    ap.add_argument("--timeout", type=float, default=10.0,
                    help="HTTP timeout for --url (seconds)")
    args = ap.parse_args(argv)
    if bool(args.snapshot) == bool(args.url):
        ap.print_usage(sys.stderr)
        print("doctor: pass exactly one of <snapshot> or --url",
              file=sys.stderr)
        return EXIT_ERROR
    try:
        data = _load_snapshot(args)
    except Exception as exc:
        print(f"doctor: cannot load snapshot: {exc}", file=sys.stderr)
        return EXIT_ERROR
    # accept either a raw snapshot (telemetry planes at top level) or a
    # served doctor payload that embeds one under "snapshot"
    snap = data.get("snapshot", data)
    thresholds = data.get("thresholds")
    try:
        payload = diagnose(snap, thresholds)
    except Exception as exc:
        print(f"doctor: rule engine failed: {exc}", file=sys.stderr)
        return EXIT_ERROR
    if args.as_json:
        print(json.dumps(payload, indent=1, sort_keys=True))
    else:
        print(_render_text(payload))
    return EXIT_CLEAN if payload["clean"] else EXIT_FINDINGS


if __name__ == "__main__":
    sys.exit(main())

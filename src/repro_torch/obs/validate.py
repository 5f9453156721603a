"""Schema checker for exported Chrome traces (CI gate).

``python -m repro.obs.validate out.json [--min-coverage 0.9]`` exits 0 iff
the file is a loadable Chrome/Perfetto trace whose events carry the
required keys and whose embedded ``repro_summary`` shows the per-stage
spans covering the step wall time.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Tuple

from .tracer import STAGE_CATS

__all__ = ["check_trace", "main"]

_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def check_trace(obj: Dict[str, Any], *, min_coverage: float = 0.0,
                require_stages: bool = True) -> Tuple[bool, List[str]]:
    problems: List[str] = []
    events = obj.get("traceEvents")
    if not isinstance(events, list) or not events:
        return False, ["traceEvents missing or empty"]
    cats = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        for key in _REQUIRED:
            if key not in ev:
                problems.append(f"event {i} ({ev.get('name')!r}) missing {key!r}")
        if ev.get("ph") == "X":
            cats.add(ev.get("cat"))
            if "dur" not in ev:
                problems.append(f"span {i} ({ev.get('name')!r}) missing dur")
    if require_stages and not (cats & set(STAGE_CATS)):
        problems.append(
            f"no span with a stage category {STAGE_CATS}; saw {sorted(map(str, cats))}")
    summ = obj.get("repro_summary")
    if min_coverage > 0:
        cov = (summ or {}).get("stage_coverage")
        if cov is None:
            problems.append("repro_summary.stage_coverage missing "
                            "(no step spans recorded?)")
        elif cov < min_coverage:
            problems.append(f"stage_coverage {cov:.3f} < {min_coverage}")
    return not problems, problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="trace JSON written by Tracer.write()")
    ap.add_argument("--min-coverage", type=float, default=0.0,
                    help="require stage spans to cover this fraction of "
                         "step wall time (acceptance criterion: 0.9)")
    ap.add_argument("--no-stages", action="store_true",
                    help="don't require plan/pack/kernel/decode spans")
    args = ap.parse_args(argv)
    with open(args.path) as fh:
        obj = json.load(fh)
    ok, problems = check_trace(obj, min_coverage=args.min_coverage,
                               require_stages=not args.no_stages)
    if ok:
        n = len(obj["traceEvents"])
        cov = (obj.get("repro_summary") or {}).get("stage_coverage")
        cov_s = f", stage_coverage={cov:.3f}" if cov is not None else ""
        print(f"OK: {args.path} ({n} events{cov_s})")
        return 0
    for p in problems:
        print(f"FAIL: {p}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())

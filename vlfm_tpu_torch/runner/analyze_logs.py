"""Aggregate episode JSON logs into SR/SPL tables and failure breakdowns:
the port's copy of ``vlfm_tpu/runner/analyze_logs.py``.

Parity target: scripts/parse_jsons.py — success/SPL/soft-SPL aggregates,
failure-cause frequencies, per-category failure rates.

Usage: ``python -m vlfm_tpu_torch.runner.analyze_logs [log_dir]``
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict
from pathlib import Path


def load_logs(log_dir: str):
    out = []
    for p in sorted(Path(log_dir).glob("*.json")):
        if p.stat().st_size == 0:
            continue
        with open(p) as f:
            out.append(json.load(f))
    return out


def summarize(episodes):
    n = len(episodes)
    if n == 0:
        return {"episodes": 0}
    mean = lambda k: sum(float(e.get(k, 0.0)) for e in episodes) / n  # noqa: E731
    causes = defaultdict(int)
    per_cat = defaultdict(lambda: [0, 0])  # target -> [fail, total]
    for e in episodes:
        cat = e.get("target_object", "?")
        per_cat[cat][1] += 1
        if not e.get("success", False):
            per_cat[cat][0] += 1
            causes[e.get("failure_cause", "unknown")] += 1
    return {
        "episodes": n,
        "success_rate": mean("success"),
        "spl": mean("spl"),
        "soft_spl": mean("soft_spl"),
        "failure_causes": dict(sorted(causes.items(), key=lambda kv: -kv[1])),
        "per_category_failure_rate": {
            k: round(f / t, 3) for k, (f, t) in sorted(per_cat.items())
        },
    }


def main():
    log_dir = sys.argv[1] if len(sys.argv) > 1 else os.environ.get("ZSOS_LOG_DIR", "episode_logs")
    print(json.dumps(summarize(load_logs(log_dir)), indent=2))


if __name__ == "__main__":
    main()

"""Benchmark corpus writer: per-run logs + CSV aggregates.

Reproduces the reference's `data/` corpus layout (SURVEY.md L7): one report
log per run plus `per_run.csv` and `avg_by_batch.csv` aggregates matching
the schema of `data/approach2/approach2/*.csv` (the
reference's aggregation script itself was never committed; this is its
framework-native replacement).
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict

from hipe_tpu.profiling.events import RunStats
from hipe_tpu.profiling.report import CSV_COLUMNS, render_report, to_csv_row

# Columns that average numerically in avg_by_batch.csv; the rest pass through
# from the first run of the group (or are replaced by the run count).
_NON_NUMERIC = {"file", "mode", "bottleneck", "wg_w", "wg_h"}


def write_corpus(stats_list: list[RunStats], out_dir: str,
                 accel_name: str = "GPU") -> tuple[str, str]:
    """Write logs + per_run.csv + avg_by_batch.csv; returns the CSV paths."""
    os.makedirs(out_dir, exist_ok=True)
    run_index: dict[int, int] = defaultdict(int)
    rows = []
    for s in stats_list:
        run_index[s.batch_size] += 1
        run = run_index[s.batch_size]
        log_name = f"{s.batch_size}_run_{run}.txt"
        with open(os.path.join(out_dir, log_name), "w") as f:
            f.write(render_report(s, accel_name=accel_name))
        rows.append(to_csv_row(s, run=run, file=log_name))

    per_run = os.path.join(out_dir, "per_run.csv")
    with open(per_run, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
        w.writeheader()
        w.writerows(rows)

    groups: dict[int, list[dict]] = defaultdict(list)
    for row in rows:
        groups[row["batch_size_file"]].append(row)
    avg_rows = []
    for bs in sorted(groups):
        grp = groups[bs]
        avg: dict = {}
        for col in CSV_COLUMNS:
            if col == "run":
                continue
            vals = [r[col] for r in grp]
            if col in _NON_NUMERIC or any(v == "" for v in vals):
                avg[col] = vals[0]
            else:
                avg[col] = round(sum(float(v) for v in vals) / len(vals), 4)
        avg["runs"] = len(grp)
        avg_rows.append(avg)
    avg_by_batch = os.path.join(out_dir, "avg_by_batch.csv")
    avg_cols = [c for c in CSV_COLUMNS if c != "run"]
    avg_cols.insert(1, "runs")
    with open(avg_by_batch, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=avg_cols)
        w.writeheader()
        w.writerows(avg_rows)
    return per_run, avg_by_batch

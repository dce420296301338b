"""Result sinks (counterpart of vlrlhf_tpu/eval/db.py): the json and
xlsx artifacts of a run and a sqlite experiment DB with one row per run,
columns created as metrics appear (the reference's tag -> columns MySQL
convention); `log_metrics_to_mysql` needs the optional pymysql.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time
from typing import Any, Sequence


def save_results_json(path: str, results: Sequence[dict]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(list(results), f, ensure_ascii=False, indent=1, default=str)


def save_results_xlsx(path: str, results: Sequence[dict]) -> None:
    """One worksheet of the result rows through eval/xlsx.py (vlrlhf_tpu
    goes through pandas' to_excel; the port has no pandas)."""
    from vlrlhf_torch.eval.xlsx import write_xlsx

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_xlsx(path, list(results))


def log_metrics_to_sqlite(
    db_path: str, table: str, metrics: dict[str, Any], tag: str | None = None
) -> None:
    """One row per eval run; columns created on demand (the reference's
    tag-parsing MySQL convention, eval/utils.py:181-216)."""
    os.makedirs(os.path.dirname(os.path.abspath(db_path)), exist_ok=True)
    row = {"tag": tag or "", "ts": time.strftime("%Y-%m-%d %H:%M:%S")}
    row.update({k.replace("-", "_"): v for k, v in metrics.items()})
    conn = sqlite3.connect(db_path)
    try:
        cols = ", ".join(f'"{k}"' for k in row)
        conn.execute(
            f'CREATE TABLE IF NOT EXISTS "{table}" '
            f'({", ".join(f_def(k, v) for k, v in row.items())})'
        )
        existing = {
            r[1] for r in conn.execute(f'PRAGMA table_info("{table}")').fetchall()
        }
        for k, v in row.items():
            if k not in existing:
                conn.execute(
                    f'ALTER TABLE "{table}" ADD COLUMN {f_def(k, v)}'
                )
        conn.execute(
            f'INSERT INTO "{table}" ({cols}) VALUES '
            f'({", ".join("?" for _ in row)})',
            list(row.values()),
        )
        conn.commit()
    finally:
        conn.close()


def f_def(name: str, value: Any) -> str:
    kind = "REAL" if isinstance(value, (int, float)) else "TEXT"
    return f'"{name}" {kind}'


def log_metrics_to_mysql(
    host: str,
    port: int,
    user: str,
    password: str,
    db: str,
    table: str,
    metrics: dict[str, Any],
    tag: str | None = None,
) -> None:
    """Optional MySQL sink with the reference's exact insert convention
    (eval/utils.py:181-216); requires pymysql (not a hard dependency)."""
    import pymysql  # noqa: F401 — optional

    row = {"tag": tag or ""}
    row.update({k.replace("-", "_"): v for k, v in metrics.items()})
    conn = pymysql.connect(
        host=host, port=port, user=user, password=password, database=db
    )
    try:
        with conn.cursor() as cur:
            cols = ", ".join(f"`{k}`" for k in row)
            ph = ", ".join(["%s"] * len(row))
            cur.execute(
                f"INSERT INTO `{table}` ({cols}) VALUES ({ph})",
                list(row.values()),
            )
        conn.commit()
    finally:
        conn.close()


def read_sqlite(db_path: str, table: str) -> list[dict]:
    conn = sqlite3.connect(db_path)
    conn.row_factory = sqlite3.Row
    try:
        return [dict(r) for r in conn.execute(f'SELECT * FROM "{table}"')]
    finally:
        conn.close()

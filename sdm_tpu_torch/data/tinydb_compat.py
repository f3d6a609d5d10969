"""Reader for TinyDB's JSON storage format, no tinydb dependency (the
port's own copy of sdm_tpu/data/tinydb_compat.py).

The reference's labelled datasets are TinyDB files: a JSON document of
`{"<table>": {"<doc_id>": {...row...}, ...}, ...}`. Rows come back in
doc-id order, as tinydb's `table.all()` gives them.
"""

from __future__ import annotations

import json
from typing import Dict, List


def read_tables(dataset_path: str) -> Dict[str, List[dict]]:
    with open(dataset_path, "r") as f:
        doc = json.load(f)
    tables: Dict[str, List[dict]] = {}
    for table_name, rows in doc.items():
        ordered = sorted(rows.items(), key=lambda kv: int(kv[0]))
        tables[table_name] = [row for _, row in ordered]
    return tables


def write_tables(dataset_path: str, tables: Dict[str, List[dict]]) -> None:
    """Inverse of read_tables: writes a TinyDB-compatible JSON document."""
    doc = {name: {str(i + 1): row for i, row in enumerate(rows)}
           for name, rows in tables.items()}
    with open(dataset_path, "w") as f:
        json.dump(doc, f)

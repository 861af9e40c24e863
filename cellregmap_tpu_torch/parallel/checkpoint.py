"""Scan checkpoint/resume (the JAX package's ``parallel/checkpoint.py``,
NumPy only).

A checkpointed scan dumps its accumulated result tables and a unit cursor
after each completed unit of work (a variant batch, or a gene tile); a
restarted scan with the same inputs resumes from the cursor.  Plain npz
plus a json cursor, each written to a temporary file and renamed into
place, so that a crash leaves either the previous state or the new one.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np


class ScanCheckpoint:
    """Cursor + result-table checkpoint for a batched scan."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self._meta = self.path / "cursor.json"
        self._data = self.path / "results.npz"

    def load(self) -> Optional[Dict]:
        """{'cursor': int, 'results': {name: array}, 'meta': dict}, or None
        when there is no complete checkpoint."""
        if not (self._meta.exists() and self._data.exists()):
            return None
        try:
            meta = json.loads(self._meta.read_text())
            with np.load(self._data) as z:
                results = {k: z[k] for k in z.files}
            return {"cursor": int(meta["cursor"]), "results": results,
                    "meta": meta}
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):
            return None

    def save(self, cursor: int, results: Dict[str, np.ndarray],
             extra_meta: Optional[Dict] = None) -> None:
        """Atomically persist the cursor and the accumulated results."""
        meta = {"cursor": int(cursor)}
        if extra_meta:
            meta.update(extra_meta)
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".npz")
        os.close(fd)
        try:
            np.savez(tmp, **results)
            os.replace(tmp, self._data)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        fd, tmpm = tempfile.mkstemp(dir=self.path, suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(meta, f)
        os.replace(tmpm, self._meta)

    def clear(self) -> None:
        for f in (self._meta, self._data):
            if f.exists():
                f.unlink()

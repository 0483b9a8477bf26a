"""Kaldi data-directory adapter (twin of a part of
``kaldi_cnn_tpu/recipes/datadir.py``): the key/value map reader that
``online2-wav-latgen`` reads its ``wav.scp`` with.  Validation,
splitting and writing of data directories are not ported yet.
"""

from __future__ import annotations

from typing import Dict


def read_key_value_file(path: str) -> Dict[str, str]:
    """Parse a Kaldi map file: one ``key rest-of-line`` entry per line,
    sorted-unique keys enforced downstream by validate()."""
    out: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split(None, 1)
            key = parts[0]
            out[key] = parts[1] if len(parts) > 1 else ""
    return out

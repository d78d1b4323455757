"""LOG text emission and best-epoch selection.

The reference selects its best epoch by re-parsing its own textual
validation logs with regexes (reference train.py:736-737, 777-825) —
3-line blocks per epoch:

    epoch:<n>
    TD: m (s), BD: m (s), DSC: m (s), Pre: m (s), Sen: m (s), Spe: m (s)
    <blank>

We keep the exact text contract (so reference tooling can read our
logs) AND store structured metrics alongside (jsonl) so selection
doesn't have to round-trip through text. Both selection paths are
provided; the scores match reference train.py:797-799 (stage 2),
821-822 (stage 3) and test.py:61-62.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

_LINE = (
    "TD: %0.4f (%0.4f), BD: %0.4f (%0.4f), DSC: %0.4f (%0.4f), "
    "Pre: %0.4f (%0.4f), Sen: %0.4f (%0.4f), Spe: %0.4f (%0.4f)"
)
_KEYS = ("TD", "BD", "DSC", "Pre", "Sen", "Spe")


def format_epoch_line(metrics_per_case: list[dict]) -> str:
    vals = []
    for k in _KEYS:
        arr = np.array([m[k] for m in metrics_per_case], np.float64)
        vals += [arr.mean(), arr.std()]
    return _LINE % tuple(vals)


def append_epoch(log_path: str, epoch: int, metrics_per_case: list[dict]):
    """Write the reference 3-line block + a structured jsonl sidecar."""
    line = format_epoch_line(metrics_per_case)
    with open(log_path, "a") as f:
        f.writelines([f"epoch:{epoch}\n", line + "\n", "\n"])
    side = log_path + ".jsonl"
    means = {
        k: float(np.mean([m[k] for m in metrics_per_case])) for k in _KEYS
    }
    with open(side, "a") as f:
        f.write(json.dumps({"epoch": epoch, **means}) + "\n")
    return line


def _parse_log(log_path: str) -> list[dict]:
    with open(log_path) as f:
        lines = f.readlines()
    out = []
    for i, line in enumerate(lines):
        if i % 3 != 1:
            continue
        rec = {}
        for k in _KEYS:
            m = re.findall(rf"{k}: (.*?) ", line)
            if m:
                rec[k] = float(m[0])
        out.append(rec)
    return out


def best_epoch_recall(log_path: str) -> int:
    """Stage-2 selection: 0.15(TD+BD)+0.2(DSC+Pre)+0.3Sen
    (reference train.py:777-802)."""
    recs = _parse_log(log_path)
    scores = [
        0.15 * (r["TD"] + r["BD"]) + 0.2 * (r["DSC"] + r["Pre"]) + 0.3 * r["Sen"]
        for r in recs
    ]
    return int(np.argmax(scores))


def best_epoch(log_path: str) -> int:
    """Stage-3 selection: 0.3TD+0.3BD+0.2DSC+0.2Pre
    (reference train.py:804-825)."""
    recs = _parse_log(log_path)
    scores = [
        0.3 * r["TD"] + 0.3 * r["BD"] + 0.2 * r["DSC"] + 0.2 * r["Pre"]
        for r in recs
    ]
    return int(np.argmax(scores))


def best_epoch_test(log_path: str) -> int:
    """Test selection: mean(TD, BD, DSC, Pre) (reference test.py:44-65)."""
    recs = _parse_log(log_path)
    scores = [np.mean([r["TD"], r["BD"], r["DSC"], r["Pre"]]) for r in recs]
    return int(np.argmax(scores))

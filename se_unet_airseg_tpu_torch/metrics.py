"""ATM22-style evaluation metrics, vectorized numpy on the host.

Re-implements the official challenge metric suite the reference
bundles (reference metrics.py:14-78): tree-length detected rate (TD),
branch-detected rate (BD), Dice (DSC), precision, sensitivity,
specificity — all scaled x100 and rounded to the reference's decimal
conventions so log lines compare 1:1.

`branch_detected` needs a per-branch-id histogram; it takes the branch
id map (`tree_parse` artifact) and the skeleton, exactly like the
reference. Implemented with `np.bincount` on host (the arrays arrive
host-side after sliding-window inference).
"""

from __future__ import annotations

import numpy as np


def tree_length_detected(pred, skeleton, smooth: float = 1e-5) -> float:
    p = pred.reshape(-1).astype(np.float64)
    s = skeleton.reshape(-1).astype(np.float64)
    return round(float((np.sum(p * s) + smooth) / (np.sum(s) + smooth) * 100), 2)


def branch_detected(pred, parse_map, skeleton, thresh: float = 0.8):
    """Returns (total_branches, detected, detected_ratio_pct).

    A branch counts as detected when >= `thresh` of its skeleton voxels
    are covered by the prediction (reference metrics.py:14-29).
    """
    label_branch = (skeleton.astype(np.int64) * parse_map.astype(np.int64)).reshape(-1)
    total = np.bincount(label_branch)[1:]
    n_total = total.shape[0]
    if n_total == 0:
        return 0, 0, 0.0
    covered = np.bincount(label_branch * pred.reshape(-1).astype(np.int64))[1:]
    if covered.shape[0] < n_total:
        covered = np.concatenate([covered, np.zeros(n_total - covered.shape[0])])
    ratio = covered / np.maximum(total, 1)
    detected = int(np.count_nonzero(ratio >= thresh))
    return n_total, detected, round(detected * 100 / n_total, 2)


def dice_score(pred, label, smooth: float = 1e-5) -> float:
    p = pred.reshape(-1).astype(np.float64)
    t = label.reshape(-1).astype(np.float64)
    return round(float((2 * np.sum(p * t) + smooth) / (np.sum(p) + np.sum(t) + smooth)) * 100, 2)


def false_positive_rate(pred, label, smooth: float = 1e-5) -> float:
    p = pred.reshape(-1).astype(np.float64)
    t = label.reshape(-1).astype(np.float64)
    fp = np.sum(p - p * t) + smooth
    return round(float(fp * 100 / (np.sum(1.0 - t) + smooth)), 3)


def false_negative_rate(pred, label, smooth: float = 1e-5) -> float:
    p = pred.reshape(-1).astype(np.float64)
    t = label.reshape(-1).astype(np.float64)
    fn = np.sum(t - p * t) + smooth
    return round(float(fn * 100 / (np.sum(t) + smooth)), 3)


def sensitivity(pred, label) -> float:
    return round(100 - false_negative_rate(pred, label), 3)


def specificity(pred, label) -> float:
    return round(100 - false_positive_rate(pred, label), 3)


def precision(pred, label, smooth: float = 1e-5) -> float:
    p = pred.reshape(-1).astype(np.float64)
    t = label.reshape(-1).astype(np.float64)
    tp = np.sum(p * t) + smooth
    return round(float(tp * 100 / (np.sum(p) + smooth)), 3)


def evaluation_suite(pred, label, parse_map, skeleton) -> dict[str, float]:
    """The 6-metric block printed per case (reference train.py:740-775)."""
    _, _, bd = branch_detected(pred, parse_map, skeleton)
    return {
        "TD": tree_length_detected(pred, skeleton),
        "BD": bd,
        "DSC": dice_score(pred, label),
        "Pre": precision(pred, label),
        "Sen": sensitivity(pred, label),
        "Spe": specificity(pred, label),
    }


# Model-selection scores (reference train.py:797-799, 821-822; test.py:61-62)


def stage2_selection_score(m: dict[str, float]) -> float:
    return 0.15 * (m["TD"] + m["BD"]) + 0.2 * (m["DSC"] + m["Pre"]) + 0.3 * m["Sen"]


def stage3_selection_score(m: dict[str, float]) -> float:
    return 0.3 * m["TD"] + 0.3 * m["BD"] + 0.2 * m["DSC"] + 0.2 * m["Pre"]


def test_selection_score(m: dict[str, float]) -> float:
    return float(np.mean([m["TD"], m["BD"], m["DSC"], m["Pre"]]))

"""Training losses of the 3-stage curriculum (reference train.py:51-76).

  * `dice_loss`: soft Dice, smooth 1.0, over the whole batch (stage 1).
  * `general_union_loss` (GUL): weighted union loss with alpha=0.2,
    beta=0.8, per-class smoothing sigma1=sigma2=1e-4, p-exponent 0.7
    (the main loss of stages 2 and 3).
  * `atr_loss`: skeleton-masked continuity (break) loss (stage 3).

Stage mixes (reference train.py:597-599, 432-435, 238-243):
  S1: dice(de) + dice(en)
  S2: 1.0 * GUL(de) + 0.5 * GUL(en)
  S3: 1.0 * GUL(de) + 0.5 * GUL(en) + 0.5 * (atr(en) + atr(de))

Every loss flattens the whole batch and sums in float32, whatever the
activation dtype, as the JAX package's `losses.py` does. Dice, GUL and
atr are ratios of sums: `*_sums` forms the sums, `*_from_sums` the
ratio. A loss over several ranks (`train/step.py` under a mesh) adds the
ranks' sums in between, in one collective with the step's other sums.
Inputs are post-sigmoid probabilities. `tversky_loss` /
`root_tversky_loss` exist in the reference (save_gradients.py:27-49) but
no stage uses them.
"""

import torch


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).to(torch.float32)


def dice_sums(pred, target):
    """Dice's sums (sum p*t, sum p, sum t): additive over the crops and voxels."""
    p, t = _flat(pred), _flat(target)
    return torch.sum(p * t), torch.sum(p), torch.sum(t)


def dice_from_sums(sums, smooth: float = 1.0):
    inter, sum_p, sum_t = sums
    return 1.0 - (2.0 * inter + smooth) / (sum_p + sum_t + smooth)


def dice_loss(pred, target, smooth: float = 1.0):
    return dice_from_sums(dice_sums(pred, target), smooth)


def general_union_sums(pred, target, weight, *, alpha: float = 0.2, sigma1: float = 1e-4,
                       sigma2: float = 1e-4, exponent: float = 0.7):
    """GUL's sums (intersection, union): additive over the crops and voxels."""
    p, t, w = _flat(pred), _flat(target), _flat(weight)
    beta = 1.0 - alpha
    wi = t * sigma1 + (1.0 - t) * sigma2
    return torch.sum(w * ((p + wi) ** exponent) * t), torch.sum(w * (alpha * p + beta * t))


def union_from_sums(sums, smooth: float = 1.0):
    """1 - (intersection + smooth) / (union + smooth): GUL and atr."""
    inter, union = sums
    return 1.0 - (inter + smooth) / (union + smooth)


def general_union_loss(pred, target, weight, *, alpha: float = 0.2,
                       sigma1: float = 1e-4, sigma2: float = 1e-4,
                       exponent: float = 0.7, smooth: float = 1.0):
    return union_from_sums(general_union_sums(pred, target, weight, alpha=alpha,
                                              sigma1=sigma1, sigma2=sigma2,
                                              exponent=exponent), smooth)


def atr_sums(pred, skel, weight):
    """atr's sums (intersection, union) on skeleton voxels: additive over
    the crops and voxels."""
    p, s, w = _flat(pred), _flat(skel), _flat(weight)
    ps = p * s
    return torch.sum(w * ps * s), torch.sum(w * (ps + s))


def atr_loss(pred, skel, weight, *, smooth: float = 1.0):
    """Airway-continuity loss on skeleton voxels only (the reference's
    target argument is overwritten by skel, reference train.py:70-76, so
    it is not taken)."""
    return union_from_sums(atr_sums(pred, skel, weight), smooth)


def tversky_loss(pred, target, *, alpha: float = 0.05, smooth: float = 1.0):
    p, t = _flat(pred), _flat(target)
    beta = 1.0 - alpha
    inter = torch.sum(p * t)
    denom = torch.sum(p * t) + alpha * torch.sum(p * (1 - t)) + beta * torch.sum((1 - p) * t)
    return 1.0 - (inter + smooth) / (denom + smooth)


def root_tversky_loss(pred, target, *, alpha: float = 0.05, exponent: float = 0.7,
                      smooth: float = 1.0):
    p, t = _flat(pred), _flat(target)
    beta = 1.0 - alpha
    inter = torch.sum((p ** exponent) * t)
    denom = torch.sum(p * t) + alpha * torch.sum(p * (1 - t)) + beta * torch.sum((1 - p) * t)
    return 1.0 - (inter + smooth) / (denom + smooth)


def stage1_loss(prob_en, prob_de, target):
    return dice_loss(prob_de, target) + dice_loss(prob_en, target)


def stage2_loss(prob_en, prob_de, target, weight):
    return general_union_loss(prob_de, target, weight) + 0.5 * general_union_loss(
        prob_en, target, weight)


def stage3_loss(prob_en, prob_de, target, weight, skel):
    gul = general_union_loss(prob_de, target, weight) + 0.5 * general_union_loss(
        prob_en, target, weight)
    atr = atr_loss(prob_en, skel, weight) + atr_loss(prob_de, skel, weight)
    return gul + 0.5 * atr

"""The benchmark's yardstick: the card's peaks, the operations and bytes of
the SE-UNet's layers counted from the frozen layer list, the least times
they allow, and the seeded CT phantom every cell's inputs start from.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit: 989 TFLOP/s in bfloat16, 3.35 TB/s of HBM3. Each
run prints the card's name and power limit beside its numbers.

Operations are counted by the taps of each conv as the published network
defines it (2 per multiply-add), whatever kernel runs it: an s2d lift or a
phase stack that multiplies zeros does not add to the count. Bytes are
counted once: each input, weight and output element read or written once.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.spec import BLOCKS, TAKES_INPUT, UNUSED

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card can take: the larger of the operations at
    the bf16 peak and the bytes at the memory rate."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def _voxels(level: int, crop: int) -> int:
    return (crop >> (level - 1)) ** 3


def conv_layers(crop: int, in_channels: int = 2, side: int = 2, n_classes: int = 1):
    """Every conv one forward of one crop runs: [(block, kind, cin, cout,
    taps, output voxels)], kind `main` (the block's 3x3x3 or 1x1x1 conv),
    `se`, `side` or `head`."""
    out = []
    for name, kind, (cin, cout), level, _ in BLOCKS:
        if name in UNUSED:
            continue
        cin = in_channels if cin < 0 else cin
        v = _voxels(level, crop)
        if kind == "cat":
            out.append((name, "main", cin, cout, 1, v))
            continue
        out.append((name, "main", cin, cout, 27, v))
        out += [(name, "se", cout, 1, 1, v)] * (2 if kind == "sse2" else 1)
        out.append((name, "side", cout, side, 1, v))
    v1 = _voxels(1, crop)
    out += [("dc0_0", "head", 12 * side, n_classes, 1, v1),
            ("dc0_1", "head", 6 * side, n_classes, 1, v1)]
    return out


def forward_flops(crop: int, only_3x3x3: bool = False) -> float:
    """Operations of one crop's forward through every conv (or the 3x3x3
    convs alone)."""
    return float(sum(2 * cin * cout * taps * v
                     for _, _, cin, cout, taps, v in conv_layers(crop)
                     if taps == 27 or not only_3x3x3))


def train_flops(crop: int, only_3x3x3: bool = False) -> float:
    """Operations of one crop's forward and backward: each conv's forward,
    its weight gradient, and its input gradient unless its input is the
    network's (remat's recomputed forwards are not counted)."""
    total = 0.0
    for name, _, cin, cout, taps, v in conv_layers(crop):
        if only_3x3x3 and taps != 27:
            continue
        f = 2.0 * cin * cout * taps * v
        total += f * (2 if name in TAKES_INPUT else 3)
    return total


def conv3_least_s(crop: int, batch: int, train: bool = False, elt: int = 2) -> float:
    """The least time of a batch's 3x3x3 convs, conv by conv: each one's
    operations at the bf16 peak against its bytes once (input, weight and
    output, `elt` bytes an element) at the memory rate, the larger of the
    two. With `train` each conv adds its weight gradient (reading the
    output gradient and the input, writing the weight's) and, unless its
    input is the network's, its input gradient (reading the output
    gradient and the weight, writing the input's)."""
    total = 0.0
    for name, _, cin, cout, taps, v in conv_layers(crop):
        if taps != 27:
            continue
        f = 2.0 * batch * cin * cout * taps * v
        x, w, y = batch * cin * v, cin * cout * taps, batch * cout * v
        total += least_s(f, (x + w + y) * elt)
        if train:
            total += least_s(f, (y + x + w) * elt)
            if name not in TAKES_INPUT:
                total += least_s(f, (y + w + x) * elt)
    return total


# The blocks the fused epilogues run, by launch name; gates per block.
EPILOGUE_BLOCKS = {
    "gathered_epilogue": ("ec1", "ec2", "ec3", "ec33", "x33", "ec5", "ec6", "ec63",
                          "x63", "dc42"),
    "phased_epilogue": ("ec4", "dc3", "dc4", "dc5", "dc6"),
    "phased_normalize": ("ec4", "dc3", "dc4", "dc5", "dc6"),
}


def epilogue_bytes(launch: str, batch: int, crop: int, elt: int = 2) -> float:
    """Bytes once of one pass of `launch` over its blocks for a batch: the
    conv output read and the result written (`elt` bytes an element), the
    per-(crop, channel) scale and shift (float32) and the SE gate vectors
    read once."""
    total = 0.0
    for name in EPILOGUE_BLOCKS[launch]:
        _, kind, (_, cout), level, _ = next(b for b in BLOCKS if b[0] == name)
        gates = 0 if launch == "phased_normalize" else {"sse1": 1, "sse2": 2}.get(kind, 0)
        n = batch * _voxels(level, crop) * cout
        c8 = 8 * cout
        total += (2 * n + gates * cout) * elt + 2 * batch * c8 * 4
    return total


def phantom(shape, gen: torch.Generator, device) -> tuple[np.ndarray, torch.Tensor]:
    """A synthetic chest CT of (D, H, W), int16 HU + 1024 on the host, and
    its airway lumen (bool, on `device`): a body of soft tissue, two lungs,
    a 7-segment airway tree (lumen -1000 HU, wall +50 HU) and noise of 30 HU.
    The tree's branch points move by up to 4% of the extents with the
    generator's draws; everything else is fixed by the shape."""
    d, h, w = (int(s) for s in shape)
    z, y, x = torch.meshgrid(*(torch.arange(s, device=device, dtype=torch.float32)
                               for s in (d, h, w)), indexing="ij")
    hu = torch.full((d, h, w), -1000.0, device=device)
    lumen = torch.zeros((d, h, w), dtype=torch.bool, device=device)
    body = ((y - h / 2) / (0.45 * h)) ** 2 + ((x - w / 2) / (0.47 * w)) ** 2 < 1
    hu[body] = 40.0
    for cx in (0.3 * w, 0.7 * w):
        lung = (((z - 0.55 * d) / (0.4 * d)) ** 2 + ((y - h / 2) / (0.3 * h)) ** 2
                + ((x - cx) / (0.17 * w)) ** 2) < 1
        hu[lung] = -850.0
    base = {"t0": (0, 0.5, 0.5), "t1": (0.4, 0.5, 0.5), "l": (0.6, 0.5, 0.3),
            "r": (0.6, 0.5, 0.7), "l1": (0.85, 0.35, 0.25), "l2": (0.8, 0.65, 0.2),
            "r1": (0.85, 0.35, 0.75), "r2": (0.8, 0.65, 0.8)}
    jitter = (torch.rand((len(base), 3), generator=gen, device=device) - 0.5) * 0.08
    ext = torch.tensor([d, h, w], device=device, dtype=torch.float32)
    pts = {k: (torch.tensor(v, device=device) + jitter[i]).clamp(0, 1) * ext
           for i, (k, v) in enumerate(base.items())}
    segs = [("t0", "t1", 9.0), ("t1", "l", 6.0), ("t1", "r", 6.0), ("l", "l1", 3.5),
            ("l", "l2", 3.5), ("r", "r1", 3.5), ("r", "r2", 3.5)]
    for a, b, r in segs:
        p0, v = pts[a], pts[b] - pts[a]
        t = (((z - p0[0]) * v[0] + (y - p0[1]) * v[1] + (x - p0[2]) * v[2]) / (v @ v)).clamp(0, 1)
        dist = torch.sqrt((z - p0[0] - t * v[0]) ** 2 + (y - p0[1] - t * v[1]) ** 2
                          + (x - p0[2] - t * v[2]) ** 2)
        hu[(dist >= r) & (dist < r + 2)] = 50.0
        hu[dist < r] = -1000.0
        lumen |= dist < r
    hu += 30.0 * torch.randn((d, h, w), generator=gen, device=device)
    stored = (hu + 1024.0).clamp(0, 4000).to(torch.int16).cpu().numpy()
    return stored, lumen


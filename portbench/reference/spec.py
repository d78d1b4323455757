"""The SE-UNet's layers, frozen: names, kinds, widths and where each runs.

A copy of the published network (reference SE_UNet.py:9-242, arXiv
2410.18456), written down once for the benchmark: the plain reference
forward (`reference/seunet.py`), the weights every run makes from its seed
(`make_weights`) and the operation counts (`portbench/counts.py`) all read
it. It imports nothing of the program under test.

Each block is (name, kind, (cin, cout), level, dilation): kind `sse1` /
`sse2` is a 3x3x3 conv, InstanceNorm, LeakyReLU and one or two spatial SE
gates, with a 2-channel 1x1x1 side conv; `cat` is a 1x1x1 conv, InstanceNorm
and LeakyReLU. A cin of -1 is the network's input channels. `level` is the
block's grid: 1 full resolution, 2 a half, 3 a quarter, 4 an eighth.
"""

from __future__ import annotations

import math

import torch

BLOCKS: list[tuple[str, str, tuple[int, int], int, int]] = [
    ("ec1", "sse1", (-1, 8), 1, 1), ("ec2", "sse1", (8, 16), 1, 1),
    ("ec3", "sse1", (16, 32), 1, 2),
    ("ec33", "cat", (56, 32), 1, 1), ("x33", "cat", (-1, 32), 1, 1),
    ("ec4", "sse2", (32, 32), 2, 1), ("ec5", "sse2", (32, 32), 2, 2),
    ("ec6", "sse2", (32, 64), 2, 2),
    ("ec63", "cat", (128, 64), 2, 1), ("x63", "cat", (-1, 64), 2, 1),
    ("ec7", "sse2", (64, 64), 3, 1), ("ec8", "sse2", (64, 64), 3, 2),
    ("ec9", "sse2", (64, 64), 3, 2),
    ("ec93", "cat", (192, 64), 3, 1), ("x93", "cat", (-1, 64), 3, 1),
    ("ec10", "sse2", (64, 64), 4, 1), ("ec11", "sse2", (64, 64), 4, 1),
    ("ec12", "sse2", (64, 64), 4, 1),
    ("ec123", "cat", (192, 64), 4, 1),
    ("dc1", "sse2", (128, 64), 3, 1), ("dc2", "sse2", (64, 64), 3, 1),
    ("dc22", "cat", (128, 64), 3, 1),
    ("dc3", "sse2", (128, 64), 2, 1), ("dc4", "sse2", (64, 32), 2, 1),
    ("dc42", "cat", (96, 32), 2, 1),
    ("dc5", "sse1", (64, 32), 1, 1), ("dc6", "sse1", (32, 16), 1, 1),
    ("dc62", "cat", (48, 16), 1, 1),
]

# dc62's output feeds nothing in the published forward, so no forward runs it
UNUSED = ("dc62",)
# blocks whose input is the network's input (or it pooled): no input gradient
TAKES_INPUT = ("ec1", "x33", "x63", "x93")
ENCODER_SIDES = ("ec1", "ec2", "ec3", "ec4", "ec5", "ec6", "ec7", "ec8", "ec9",
                 "ec10", "ec11", "ec12")
DECODER_SIDES = ("dc1", "dc2", "dc3", "dc4", "dc5", "dc6")


def block(name: str):
    return next(b for b in BLOCKS if b[0] == name)


def leaf_shapes(in_channels: int = 2, side: int = 2, n_classes: int = 1) -> list:
    """Every parameter under the published state_dict names, in the
    published module order: [(name, OIDHW shape, fan_in)]."""
    out = []
    for name, kind, (cin, cout), _, _ in BLOCKS:
        cin = in_channels if cin < 0 else cin
        if kind == "cat":
            out.append((f"{name}.conv1.weight", (cout, cin, 1, 1, 1), cin))
            continue
        out += [(f"{name}.conv1.weight", (cout, cin, 3, 3, 3), cin * 27),
                (f"{name}.conv1.bias", (cout,), cin * 27),
                (f"{name}.conv2.weight", (side, cout, 1, 1, 1), cout),
                (f"{name}.conv2.bias", (side,), cout),
                (f"{name}.conv_se.weight", (1, cout, 1, 1, 1), cout)]
        if kind == "sse2":
            out.append((f"{name}.conv_se2.weight", (1, cout, 1, 1, 1), cout))
    for head, k in (("dc0_0", 12), ("dc0_1", 6)):
        out += [(f"{head}.weight", (n_classes, k * side, 1, 1, 1), k * side),
                (f"{head}.bias", (n_classes,), k * side)]
    return out


def make_weights(seed: int, device, in_channels: int = 2, side: int = 2,
                 n_classes: int = 1) -> dict:
    """The state_dict of a randomly initialised SE-UNet, float32 on
    `device`: PyTorch's default conv init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn in one call from a generator on `device` seeded with `seed`."""
    shapes = leaf_shapes(in_channels, side, n_classes)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    sd, at = {}, 0
    for name, shape, fan_in in shapes:
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(fan_in)
        sd[name] = (flat[at:at + n] * (2 * bound) - bound).reshape(shape)
        at += n
    return sd

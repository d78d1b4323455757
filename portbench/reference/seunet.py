"""Plain float32 SE-UNet: forward, stage-1 loss and its gradient, in
PyTorch's own NCDHW operations, from the frozen layer list in `spec.py`.

It reads the published state_dict names and takes no weight, table or
layout from the program under test. `quant` computes every conv in a lower
precision: `bf16` runs it in bfloat16 (operands and output rounded, float32
accumulation), `fp8` puts its input and weight through float8 e4m3 with one
scale per tensor (the step below bfloat16), with the gradient passing the
rounding unchanged, so a backward sees the rounded operands.

On the GPU a float32 conv may run in TF32 unless cuDNN's and cuBLAS's TF32
switches are off: `no_tf32()` turns both off for a block.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .spec import BLOCKS, DECODER_SIDES, ENCODER_SIDES

FP8_MAX = 448.0  # largest finite float8 e4m3 value


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale (amax to 448), back in
    float32; the gradient passes unchanged."""
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x.detach())


QUANT = {None: None, "bf16": "bf16", "fp8": fp8_round}


def _conv(x, w, b=None, pad=0, dil=1, q=None):
    if q == "bf16":
        y = F.conv3d(x.to(torch.bfloat16), w.to(torch.bfloat16), padding=pad,
                     dilation=dil).to(torch.float32)
        return y if b is None else y + b.view(1, -1, 1, 1, 1)
    if q is not None:
        x, w = q(x), q(w)
    return F.conv3d(x, w, b, padding=pad, dilation=dil)


def _norm_act(x):
    return F.leaky_relu(F.instance_norm(x, eps=1e-5), 0.01)


def _up(x, factor: int):
    if factor == 1:
        return x
    return F.interpolate(x, scale_factor=factor, mode="trilinear", align_corners=True)


def _drop(x, r, threshold: float, rows):
    """DropLayer: channel mask r >= threshold scaled by C / (mask sum + 0.01),
    the sum over the whole batch's draws r (B, C); `rows` of it for x."""
    mask = (r >= threshold).to(torch.float32)
    scale = mask * (r.shape[-1] / (mask.sum() + 0.01))
    return x * scale[rows][:, :, None, None, None]


def forward(sd: dict, x: torch.Tensor, *, drop=None, rows=slice(None),
            drop_threshold: float = 0.3, quant: str | None = None):
    """Logits (pred_en, pred_de) of NCDHW float32 input x. `drop`: the
    batch's DropLayer draws [r_en (B, 24), r_de (B, 12)] (train mode), of
    which x holds the rows `rows`."""
    q = QUANT[quant]
    sides = {}
    pooled = {}

    def sse(name, inp):
        _, kind, _, level, dil = next(b for b in BLOCKS if b[0] == name)
        e = _norm_act(_conv(inp, sd[f"{name}.conv1.weight"], sd[f"{name}.conv1.bias"],
                            pad=dil, dil=dil, q=q))
        gates = ("conv_se", "conv_se2") if kind == "sse2" else ("conv_se",)
        for g in gates:
            e = e * torch.sigmoid(_conv(e, sd[f"{name}.{g}.weight"], q=q))
        side = _conv(e, sd[f"{name}.conv2.weight"], sd[f"{name}.conv2.bias"], q=q)
        sides[name] = _up(side, 2 ** (level - 1))
        return e

    def cat_block(name, *inp):
        return _norm_act(_conv(torch.cat(inp, 1), sd[f"{name}.conv1.weight"], q=q))

    pooled[2] = F.max_pool3d(x, 2)
    pooled[3] = F.max_pool3d(pooled[2], 2)
    e0 = sse("ec1", x)
    e1 = sse("ec2", e0)
    e1_1 = sse("ec3", e1)
    e1 = cat_block("ec33", e1_1, e0, e1) + cat_block("x33", x)
    e2 = sse("ec4", F.max_pool3d(e1, 2))
    e3 = sse("ec5", e2)
    e3_1 = sse("ec6", e3)
    e3 = cat_block("ec63", e3_1, e2, e3) + cat_block("x63", pooled[2])
    e4 = sse("ec7", F.max_pool3d(e3, 2))
    e5 = sse("ec8", e4)
    e5_1 = sse("ec9", e5)
    e5 = cat_block("ec93", e5_1, e4, e5) + cat_block("x93", pooled[3])
    e6 = sse("ec10", F.max_pool3d(e5, 2))
    e7 = sse("ec11", e6)
    e7_1 = sse("ec12", e7)
    e7 = cat_block("ec123", e7_1, e6, e7)
    d0 = sse("dc1", torch.cat([_up(e7, 2), e5], 1))
    d0_1 = sse("dc2", d0)
    d0 = cat_block("dc22", d0_1, d0)
    d1 = sse("dc3", torch.cat([_up(d0, 2), e3], 1))
    d1_1 = sse("dc4", d1)
    d1 = cat_block("dc42", d1_1, d1)
    d2 = sse("dc5", torch.cat([_up(d1, 2), e1], 1))
    sse("dc6", d2)  # dc62 would read dc6; its output feeds nothing, so it is not run
    s_en = torch.cat([sides[n] for n in ENCODER_SIDES], 1)
    s_de = torch.cat([sides[n] for n in DECODER_SIDES], 1)
    if drop is not None:
        s_en = _drop(s_en, drop[0].float(), drop_threshold, rows)
        s_de = _drop(s_de, drop[1].float(), drop_threshold, rows)
    pred_en = _conv(s_en, sd["dc0_0.weight"], sd["dc0_0.bias"], q=q)
    pred_de = _conv(s_de, sd["dc0_1.weight"], sd["dc0_1.bias"], q=q)
    return pred_en, pred_de


def dual_window(hu: torch.Tensor) -> torch.Tensor:
    """HU (..., D, H, W) -> (..., 2, D, H, W): the lung and mediastinal
    windows, float32 in [0, 1] (reference data.py:286-299)."""
    hu = hu.to(torch.float32)
    c0 = (torch.clamp(hu, -1024.0, 1024.0) + 1024.0) / 2048.0
    c1 = (torch.clamp(hu, -1000.0, 500.0) + 1000.0) / 1500.0
    return torch.stack([c0, c1], dim=-4)


def dice_sums(p, t):
    p, t = p.reshape(-1), t.reshape(-1).to(torch.float32)
    return torch.stack([torch.sum(p * t), torch.sum(p), torch.sum(t)])


def dice(s, smooth: float = 1.0):
    return 1.0 - (2.0 * s[0] + smooth) / (s[1] + s[2] + smooth)


def stage1_grads(sd: dict, image: torch.Tensor, label: torch.Tensor, drop,
                 quant: str | None = None, rows_per_block: int = 1) -> float:
    """The stage-1 loss dice(de) + dice(en) of the whole batch (NDHWC image
    (B, D, H, W, 2), label (B, D, H, W)), its gradient accumulated into
    the leaves' `.grad`, row block by row block: Dice is a ratio of sums
    over the batch, so each block's backward takes the other blocks' sums
    as constants. Returns the loss."""
    b = image.shape[0]
    blocks = [slice(i, min(i + rows_per_block, b)) for i in range(0, b, rows_per_block)]

    def sums(rows):
        x = image[rows].permute(0, 4, 1, 2, 3).to(torch.float32)
        en, de = forward(sd, x, drop=drop, rows=rows, quant=quant)
        t = label[rows]
        return torch.stack([dice_sums(torch.sigmoid(de[:, 0]), t),
                            dice_sums(torch.sigmoid(en[:, 0]), t)])

    with torch.no_grad():
        parts = [sums(rows) for rows in blocks]
    total = torch.stack(parts).sum(0)
    for k, rows in enumerate(blocks):
        others = sum((parts[j] for j in range(len(blocks)) if j != k),
                     torch.zeros_like(total))
        s = sums(rows) + others
        (dice(s[0]) + dice(s[1])).backward()
    return float(dice(total[0]) + dice(total[1]))


def make_adamw(leaves):
    """AdamW as the reference trains stage 1 (train.py:567-572)."""
    return torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)

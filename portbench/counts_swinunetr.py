"""Swin UNETR's operations and bytes, counted from its configuration (the
configuration file's keys), for the Swin UNETR cell's per-layer metrics.

Operations are 2 per multiply-add of the model as MONAI defines it: every
conv (patch embedding, 3x3x3 and 1x1x1 convs of the res blocks, the
transposed convs, the logits), every linear layer (qkv and the attention's
output projection over the padded windows, as the model computes them; the
MLP over the real tokens; patch merging), and the two attention products
QK^T and PV over the padded windows. Norms, softmax, GELU and adds are not
counted. Bytes are bfloat16 elements counted once: a conv's input, weight
and output; the attention's q, k, v and output, and its bias (in a shifted
block the bias with the shift mask, one per window) read once a tile batch,
since it is the same for every tile; K7's input read and output written.
Peaks as `counts.py`.
"""

from __future__ import annotations

from .counts import least_s

ELT = 2  # bfloat16


def _cfg(conf: dict) -> tuple:
    return (conf["in_channels"], conf["out_channels"], conf["feature_size"],
            tuple(conf["depths"]), tuple(conf["num_heads"]), conf["window_size"],
            conf.get("mlp_ratio", 4.0))


def convs(conf: dict, crop: int) -> list:
    """Every conv of one tile's forward: [(name, cin, cout, taps, output
    voxels, input voxels, kernel volume)]; a transposed conv's taps are 1 an
    output voxel."""
    cin0, cout0, f = _cfg(conf)[:3]
    v = [(crop >> k) ** 3 for k in range(6)]  # voxels at 1, 1/2, ... 1/32
    out = [("patch_embed", cin0, f, 8, v[1], v[0], 8)]
    res = [("encoder1", cin0, f, 0), ("encoder2", f, f, 1), ("encoder3", 2 * f, 2 * f, 2),
           ("encoder4", 4 * f, 4 * f, 3), ("encoder10", 16 * f, 16 * f, 5),
           ("decoder5", 16 * f, 8 * f, 4), ("decoder4", 8 * f, 4 * f, 3),
           ("decoder3", 4 * f, 2 * f, 2), ("decoder2", 2 * f, f, 1), ("decoder1", 2 * f, f, 0)]
    ups = {"decoder5": (16 * f, 8 * f), "decoder4": (8 * f, 4 * f), "decoder3": (4 * f, 2 * f),
           "decoder2": (2 * f, f), "decoder1": (f, f)}
    for name, ci, co, lvl in res:
        if name in ups:
            a, b = ups[name]
            out.append((name + ".transp_conv", a, b, 1, v[lvl], v[lvl + 1], 8))
        out.append((name + ".conv1", ci, co, 27, v[lvl], v[lvl], 27))
        out.append((name + ".conv2", co, co, 27, v[lvl], v[lvl], 27))
        if ci != co:
            out.append((name + ".conv3", ci, co, 1, v[lvl], v[lvl], 1))
    out.append(("out", f, cout0, 1, v[0], v[0], 1))
    return out


def blocks(conf: dict, crop: int) -> list:
    """Each Swin block of one tile: [(stage, channels, heads, real tokens,
    padded tokens, window tokens N, windows, shifted)]."""
    _, _, f, depths, heads, w, _ = _cfg(conf)
    out = []
    for i in range(4):
        e = crop >> (i + 1)
        win = min(e, w)
        pad = -(-e // win) * win
        for j in range(depths[i]):
            shifted = j % 2 == 1 and e > w
            out.append((i, f * 2 ** i, heads[i], e ** 3, pad ** 3, win ** 3,
                        (pad // win) ** 3, shifted))
    return out


def conv_flops(conf: dict, crop: int) -> float:
    return sum(2.0 * ci * co * taps * vo for _, ci, co, taps, vo, _, _ in convs(conf, crop))


def linear_flops(conf: dict, crop: int) -> float:
    """qkv and proj over the padded tokens, the MLP over the real ones,
    patch merging over each stage's output."""
    mlp = _cfg(conf)[6]
    total = 0.0
    for _, c, _, t, tp, _, _, _ in blocks(conf, crop):
        total += 2.0 * tp * c * 4 * c + 2.0 * t * c * 2 * int(mlp * c)
    f = _cfg(conf)[2]
    for i in range(4):
        c, t = f * 2 ** i, (crop >> (i + 1)) ** 3
        total += 2.0 * (t // 8) * 8 * c * 2 * c
    return total


def attn_flops(conf: dict, crop: int) -> float:
    """QK^T and PV over the padded windows of one tile."""
    return sum(4.0 * tp * n * c for _, c, _, _, tp, n, _, _ in blocks(conf, crop))


def forward_flops(conf: dict, crop: int) -> float:
    """The model's operations of one tile's forward."""
    return conv_flops(conf, crop) + linear_flops(conf, crop) + attn_flops(conf, crop)


def conv_least_s(conf: dict, crop: int, batch: int) -> float:
    """Every conv's least time over a tile batch, conv by conv."""
    return sum(least_s(2.0 * ci * co * taps * vo * batch,
                       ELT * (batch * (ci * vi + co * vo) + ci * co * k))
               for _, ci, co, taps, vo, vi, k in convs(conf, crop))


def attn_bytes(conf: dict, crop: int, batch: int) -> list:
    """Each block's attention bytes over a tile batch: q, k, v and the
    output of every tile, and the bias (heads x N x N; one a window in a
    shifted block) once."""
    out = []
    for _, c, heads, _, tp, n, nw, shifted in blocks(conf, crop):
        bias = (nw if shifted else 1) * heads * n * n
        out.append(ELT * (4.0 * batch * tp * c + bias))
    return out


def attn_least_s(conf: dict, crop: int, batch: int) -> float:
    """The window attention's least time over a tile batch, block by block."""
    return sum(least_s(batch * 4.0 * tp * n * c, nbytes)
               for (_, c, _, _, tp, n, _, _), nbytes in zip(blocks(conf, crop),
                                                             attn_bytes(conf, crop, batch)))


def norm_leaky_bytes(conf: dict, crop: int, batch: int) -> float:
    """K7's bytes over a tile batch: each res block's first InstanceNorm +
    LeakyReLU reads its conv's output and writes its own, once."""
    return sum(2.0 * ELT * batch * co * vo
               for name, _, co, _, vo, _, _ in convs(conf, crop) if name.endswith(".conv1"))


K7_LAUNCHES = 10  # one a res block, a tile batch

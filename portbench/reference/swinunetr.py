"""Plain float32 Swin UNETR: forward and whole-volume prediction, in
PyTorch's own NCDHW operations.

Hatamizadeh et al., arXiv:2201.01266, with UNETR's decoder blocks
(arXiv:2103.10504), as MONAI's `SwinUNETR` (`use_v2=False`, drop rates 0)
computes it, written again from those equations: the patch embedding (k=2,
s=2 conv with bias) and weightless LayerNorm of every hidden state handed
on; four stages of Swin blocks (pre-norm window attention over window^3
tokens with a relative-position bias, shifted by window // 2 in every second
block with MONAI's -100 region mask, padded with zeros after the norm up to
a multiple of the window, the padded tokens attended as keys; a GELU MLP of
4C) each followed by patch merging; UNETR's res blocks and transposed-conv
up blocks; a 1x1x1 conv with bias for the logits. One departure from MONAI:
patch merging concatenates the 2x2x2 cell's tokens in the order of
`itertools.product(range(2), repeat=3)` over (d, h, w) (the paper's and
MONAI's `PatchMergingV2`), not MONAI's default `"merging"`, which repeats two
of them.

It reads the published state_dict names (MONAI's) and takes no weight,
table or layout from the program under test. Attention runs a chunk of
windows at a time (`WINDOW_CHUNK`), so that a stage of a thousand windows
fits on the card. `quant` rounds the inputs of every conv, linear layer and
attention product (q and k, the softmax and v): `bf16` to bfloat16 (the
configuration's precision), `fp8` through float8 e4m3 with a per-tensor
scale (the step below it); the products themselves accumulate in float32.
`predict_scores` turns TF32 off (`seunet.no_tf32`); call `forward` inside it
on the GPU.
"""

from __future__ import annotations

import itertools
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .seunet import dual_window, fp8_round, no_tf32
from .volume import positions

WINDOW_CHUNK = 128  # windows attended at once
LN_EPS = 1e-5
IN_EPS = 1e-5
SLOPE = 0.01


class Spec(NamedTuple):
    in_channels: int = 2
    out_channels: int = 1
    feature_size: int = 48
    depths: tuple = (2, 2, 2, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 2
    mlp_ratio: float = 4.0
    normalize: bool = True

    @classmethod
    def from_config(cls, conf: dict) -> "Spec":
        return cls(**{k: tuple(conf[k]) if isinstance(conf[k], list) else conf[k]
                      for k in cls._fields})


# ---------------------------------------------------------------- weights


def shapes(spec: Spec) -> dict:
    """{state_dict name: shape}, in the order the weights are drawn."""
    f, p, w = spec.feature_size, spec.patch_size, spec.window_size
    out = {"swinViT.patch_embed.proj.weight": (f, spec.in_channels, p, p, p),
           "swinViT.patch_embed.proj.bias": (f,)}
    for i in range(4):
        c, heads = f * 2 ** i, spec.num_heads[i]
        hid = int(c * spec.mlp_ratio)
        layer = f"swinViT.layers{i + 1}.0."
        for j in range(spec.depths[i]):
            blk = f"{layer}blocks.{j}."
            for name, shape in (("norm1.weight", (c,)), ("norm1.bias", (c,)),
                                ("attn.relative_position_bias_table",
                                 ((2 * w - 1) ** 3, heads)),
                                ("attn.qkv.weight", (3 * c, c)), ("attn.qkv.bias", (3 * c,)),
                                ("attn.proj.weight", (c, c)), ("attn.proj.bias", (c,)),
                                ("norm2.weight", (c,)), ("norm2.bias", (c,)),
                                ("mlp.linear1.weight", (hid, c)), ("mlp.linear1.bias", (hid,)),
                                ("mlp.linear2.weight", (c, hid)), ("mlp.linear2.bias", (c,))):
                out[blk + name] = shape
        out[layer + "downsample.norm.weight"] = (8 * c,)
        out[layer + "downsample.norm.bias"] = (8 * c,)
        out[layer + "downsample.reduction.weight"] = (2 * c, 8 * c)
    for name, cin, cout in _res_blocks(spec):
        out[name + "conv1.conv.weight"] = (cout, cin, 3, 3, 3)
        out[name + "conv2.conv.weight"] = (cout, cout, 3, 3, 3)
        if cin != cout:
            out[name + "conv3.conv.weight"] = (cout, cin, 1, 1, 1)
    for k, (cin, cout) in _up_blocks(spec).items():
        out[f"decoder{k}.transp_conv.conv.weight"] = (cin, cout, 2, 2, 2)
    out["out.conv.conv.weight"] = (spec.out_channels, f, 1, 1, 1)
    out["out.conv.conv.bias"] = (spec.out_channels,)
    return out


def _res_blocks(spec: Spec):
    f = spec.feature_size
    return [("encoder1.layer.", spec.in_channels, f), ("encoder2.layer.", f, f),
            ("encoder3.layer.", 2 * f, 2 * f), ("encoder4.layer.", 4 * f, 4 * f),
            ("encoder10.layer.", 16 * f, 16 * f)] + [
        (f"decoder{k}.conv_block.", 2 * cout, cout) for k, (_, cout) in _up_blocks(spec).items()]


def _up_blocks(spec: Spec) -> dict:
    """{decoder k: (channels in, channels out)} of the transposed convs."""
    f = spec.feature_size
    return {5: (16 * f, 8 * f), 4: (8 * f, 4 * f), 3: (4 * f, 2 * f), 2: (2 * f, f), 1: (f, f)}


def make_weights(seed: int, device, spec: Spec) -> dict:
    """Random weights from `seed`, drawn on `device`: linear layers and the
    relative-position tables trunc-normal with std 0.02, their biases 0,
    LayerNorm 1 and 0; convs PyTorch's default U(+-1/sqrt(fan_in)), fan_in
    from the weight's second dimension as PyTorch counts it (for a
    transposed conv that is its output channels)."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    out = {}
    conv_bias = {"swinViT.patch_embed.proj.bias": "swinViT.patch_embed.proj.weight",
                 "out.conv.conv.bias": "out.conv.conv.weight"}
    every = shapes(spec)
    for name, shape in every.items():
        if name.endswith("relative_position_bias_table") or (
                name.endswith(".weight") and len(shape) == 2):
            t = torch.empty(shape, device=device)
            torch.nn.init.trunc_normal_(t, std=0.02, generator=gen)
        elif len(shape) == 5 or name in conv_bias:
            cs = every[conv_bias.get(name, name)]
            bound = 1.0 / float(np.sqrt(cs[1] * np.prod(cs[2:])))
            t = (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound
        elif "norm" in name and name.endswith(".weight"):
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t
    return out


# ---------------------------------------------------------------- forward


def _rounder(quant):
    if quant == "bf16":
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    if quant == "fp8":
        return fp8_round
    return lambda t: t


def _conv(x, w, b=None, q=None, **kw):
    return F.conv3d(q(x), q(w), b, **kw)


def _linear(x, w, b=None, q=None):
    return F.linear(q(x), q(w), b)


def _rel_index(w: int) -> torch.Tensor:
    c = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), torch.arange(w),
                                   indexing="ij")).flatten(1)
    rel = c[:, :, None] - c[:, None, :] + (w - 1)
    return rel[0] * (2 * w - 1) ** 2 + rel[1] * (2 * w - 1) + rel[2]


def _windows(x, ws):
    """(B, D, H, W, C) -> (B * nW, N, C)."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def _unwindows(x, ws, b, d, h, w):
    x = x.reshape(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def _region_mask(dims, ws, ss, device) -> torch.Tensor:
    """(nW, N, N): 0 within a shift region, -100 across regions."""
    img = torch.zeros((1, *dims, 1), device=device)
    cnt = 0
    for sd in (slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None)):
        for sh in (slice(-ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None)):
            for sw in (slice(-ws[2]), slice(-ws[2], -ss[2]), slice(-ss[2], None)):
                img[:, sd, sh, sw, :] = cnt
                cnt += 1
    m = _windows(img, ws).squeeze(-1)
    diff = m[:, None, :] - m[:, :, None]
    return torch.where(diff != 0, torch.tensor(-100.0, device=device),
                       torch.tensor(0.0, device=device))


def _attend(xw, sd, blk, heads, ws, win_full, mask, q):
    """Window attention of (nW_total, N, C) windows, WINDOW_CHUNK at a time;
    `mask` (nW, N, N) of one sample's windows, or None."""
    bw, n, c = xw.shape
    hd = c // heads
    table = sd[blk + "attn.relative_position_bias_table"]
    idx = _rel_index(win_full).to(xw.device)[:n, :n].reshape(-1)
    bias = table[idx].reshape(n, n, heads).permute(2, 0, 1)  # (heads, N, N)
    out = torch.empty_like(xw)
    nw = 1 if mask is None else mask.shape[0]
    for a in range(0, bw, WINDOW_CHUNK):
        chunk = xw[a:a + WINDOW_CHUNK]
        m = chunk.shape[0]
        qkv = _linear(chunk, sd[blk + "attn.qkv.weight"], sd[blk + "attn.qkv.bias"], q)
        qkv = qkv.reshape(m, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        qq, kk, vv = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        logits = q(qq) @ q(kk).transpose(-2, -1) + bias[None]
        if mask is not None:
            logits = logits + mask[torch.arange(a, a + m, device=xw.device) % nw][:, None]
        p = torch.softmax(logits, dim=-1)
        o = (q(p) @ q(vv)).transpose(1, 2).reshape(m, n, c)
        out[a:a + m] = _linear(o, sd[blk + "attn.proj.weight"], sd[blk + "attn.proj.bias"], q)
    return out


def _swin_block(x, sd, blk, heads, window, shifted, q):
    """One block on channels-last tokens (B, D, H, W, C)."""
    b, d, h, w, c = x.shape
    ws = [min(e, window) for e in (d, h, w)]
    ss = [0 if e <= window or not shifted else window // 2 for e in (d, h, w)]
    y = F.layer_norm(x, (c,), sd[blk + "norm1.weight"], sd[blk + "norm1.bias"], LN_EPS)
    pd, ph, pw = ((ws[i] - e % ws[i]) % ws[i] for i, e in enumerate((d, h, w)))
    y = F.pad(y, (0, 0, 0, pw, 0, ph, 0, pd))
    dp, hp, wp = d + pd, h + ph, w + pw
    mask = None
    if any(s > 0 for s in ss):
        y = torch.roll(y, shifts=(-ss[0], -ss[1], -ss[2]), dims=(1, 2, 3))
        mask = _region_mask((dp, hp, wp), ws, ss, x.device)
    y = _attend(_windows(y, ws), sd, blk, heads, ws, window, mask, q)
    y = _unwindows(y, ws, b, dp, hp, wp)
    if any(s > 0 for s in ss):
        y = torch.roll(y, shifts=(ss[0], ss[1], ss[2]), dims=(1, 2, 3))
    x = x + y[:, :d, :h, :w]
    y = F.layer_norm(x, (c,), sd[blk + "norm2.weight"], sd[blk + "norm2.bias"], LN_EPS)
    y = F.gelu(_linear(y, sd[blk + "mlp.linear1.weight"], sd[blk + "mlp.linear1.bias"], q))
    return x + _linear(y, sd[blk + "mlp.linear2.weight"], sd[blk + "mlp.linear2.bias"], q)


def _merge(x, sd, layer, q):
    b, d, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x = torch.cat([x[:, i::2, j::2, k::2, :]
                   for i, j, k in itertools.product(range(2), range(2), range(2))], -1)
    x = F.layer_norm(x, (8 * c,), sd[layer + "downsample.norm.weight"],
                     sd[layer + "downsample.norm.bias"], LN_EPS)
    return _linear(x, sd[layer + "downsample.reduction.weight"], None, q)


def _proj_out(x, normalize):
    """NCDHW -> NCDHW, LayerNorm over channels without weights."""
    if not normalize:
        return x
    c = x.shape[1]
    y = x.permute(0, 2, 3, 4, 1)
    return F.layer_norm(y, (c,), eps=LN_EPS).permute(0, 4, 1, 2, 3)


def _res_block(x, sd, name, q):
    y = _conv(x, sd[name + "conv1.conv.weight"], q=q, padding=1)
    y = F.leaky_relu(F.instance_norm(y, eps=IN_EPS), SLOPE)
    y = F.instance_norm(_conv(y, sd[name + "conv2.conv.weight"], q=q, padding=1), eps=IN_EPS)
    if name + "conv3.conv.weight" in sd:
        x = F.instance_norm(_conv(x, sd[name + "conv3.conv.weight"], q=q), eps=IN_EPS)
    return F.leaky_relu(y + x, SLOPE)


def forward(sd: dict, x: torch.Tensor, spec: Spec = Spec(), quant: str | None = None):
    """Logits (B, out_channels, D, H, W) of NCDHW float32 input x."""
    q = _rounder(quant)
    p = spec.patch_size
    d, h, w = x.shape[2:]
    xe = F.pad(x, (0, (p - w % p) % p, 0, (p - h % p) % p, 0, (p - d % p) % p))
    t = _conv(xe, sd["swinViT.patch_embed.proj.weight"], sd["swinViT.patch_embed.proj.bias"],
              q=q, stride=p)
    hidden = [_proj_out(t, spec.normalize)]
    t = t.permute(0, 2, 3, 4, 1)
    for i in range(4):
        layer = f"swinViT.layers{i + 1}.0."
        for j in range(spec.depths[i]):
            t = _swin_block(t, sd, f"{layer}blocks.{j}.", spec.num_heads[i], spec.window_size,
                            j % 2 == 1, q)
        t = _merge(t, sd, layer, q)
        hidden.append(_proj_out(t.permute(0, 4, 1, 2, 3), spec.normalize))
    enc0 = _res_block(x, sd, "encoder1.layer.", q)
    enc1 = _res_block(hidden[0], sd, "encoder2.layer.", q)
    enc2 = _res_block(hidden[1], sd, "encoder3.layer.", q)
    enc3 = _res_block(hidden[2], sd, "encoder4.layer.", q)
    dec = _res_block(hidden[4], sd, "encoder10.layer.", q)
    for k, skip in zip((5, 4, 3, 2, 1), (hidden[3], enc3, enc2, enc1, enc0)):
        up = F.conv_transpose3d(q(dec), q(sd[f"decoder{k}.transp_conv.conv.weight"]), stride=2)
        dec = _res_block(torch.cat([up, skip], dim=1), sd, f"decoder{k}.conv_block.", q)
    return _conv(dec, sd["out.conv.conv.weight"], sd["out.conv.conv.bias"], q=q)


# ------------------------------------------------------------ whole volume


def predict_scores(sd: dict, stored: np.ndarray, spec: Spec, *, cube: int, step: int,
                   batch: int, hu_shift: float, device,
                   quant: str | None = None) -> torch.Tensor:
    """The overlap-averaged sigmoid scores of an int16 stored volume (HU -
    hu_shift), one tile at a time, tiled as `volume.positions` tiles (the
    published test loop's tiling, padded to whole batches)."""
    shape = np.maximum(np.asarray(stored.shape), cube)
    pads = [(0, int(t - s)) for s, t in zip(stored.shape, shape)]
    vol = np.pad(stored.astype(np.float32), pads, constant_values=-1024.0 - hu_shift)
    hu = torch.from_numpy(vol).to(device) + hu_shift
    acc = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    cnt = torch.zeros_like(acc)
    with torch.no_grad(), no_tf32():
        for (x, y, z), times in Counter(positions(shape, cube, step, batch)).items():
            win = (slice(x, x + cube), slice(y, y + cube), slice(z, z + cube))
            logits = forward(sd, dual_window(hu[win])[None], spec, quant=quant)
            acc[win] += times * torch.sigmoid(logits[0, 0])
            cnt[win] += times
    d, hh, w = stored.shape
    return (acc * (1.0 / torch.clamp(cnt, min=1.0)))[:d, :hh, :w]


def predict_trits(sd: dict, stored: np.ndarray, spec: Spec, *, cube: int, step: int,
                  batch: int, h: float, l: float, hu_shift: float, device,
                  quant: str | None = None) -> np.ndarray:
    """uint8 trits (0 below `l`, 1 from `l`, 2 from `h`) of `predict_scores`."""
    avg = predict_scores(sd, stored, spec, cube=cube, step=step, batch=batch,
                         hu_shift=hu_shift, device=device, quant=quant)
    return ((avg >= l).to(torch.uint8) + (avg >= h).to(torch.uint8)).cpu().numpy()

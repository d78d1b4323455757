"""Swin UNETR, eval-mode forward in PyTorch on NDHWC tensors.

Hatamizadeh et al., "Swin Transformers for Semantic Segmentation of Brain
Tumors in MRI Images" (arXiv:2201.01266), with the convolutional decoder
blocks of UNETR (arXiv:2103.10504), as MONAI's `monai.networks.nets.SwinUNETR`
computes it with `use_v2=False` and every drop rate 0:

  * patch embedding: a k=2, s=2 conv with bias; every hidden state handed
    to the decoder is `layer_norm(h, [C])` without weights (`normalize`);
  * four stages of `depths[i]` Swin blocks, each stage followed by patch
    merging. Block j shifts its windows by window // 2 when j is odd. A
    block: x + proj(A(LN1(x))), then x + W2 GELU(W1 LN2(x)) (exact erf,
    hidden 4C). A pads the token grid with zeros after LN1 up to a multiple
    of the window, rolls it by -shift, attends within each window^3-token
    window (qkv with bias, head dim C / heads, scale dim^-1/2, a learned
    relative-position bias of (2w-1)^3 x heads, in shifted blocks -100
    between tokens of different shift regions of the padded grid, as
    MONAI's `compute_mask`), then reverses, rolls back and crops. Padded
    tokens are keys of every window that holds them, as in MONAI. Where a
    stage's extent along an axis is at most the window, the window is that
    extent and the shift 0 along it;
  * patch merging: the 8 tokens of each 2x2x2 cell concatenated in the order
    of `itertools.product(range(2), repeat=3)` over (d, h, w), LayerNorm(8C),
    Linear(8C, 2C) without bias;
  * the res block R(cin -> cout) (UNETR's `UnetResBlock`): y = LReLU(IN(conv3(x))),
    y = IN(conv3(y)), shortcut IN(conv1(x)) where cin != cout else x,
    LReLU(y + shortcut); convs without bias, InstanceNorm without affine,
    eps 1e-5, slope 0.01;
  * the up block U(cin -> cout)(a, skip) = R(2 cout -> cout)(cat(ConvT(a), skip)),
    ConvT a k=2, s=2 transposed conv without bias; the logits a 1x1x1 conv
    with bias.

Departures from MONAI:
  * patch merging concatenates the 8 neighbours in the order above (the
    paper's, and MONAI's `PatchMergingV2`); MONAI's default `"merging"`
    repeats two neighbours and leaves two out;
  * each res block's first InstanceNorm + LeakyReLU is K7
    (`ops/norm_leaky.py`): statistics in float32 with the variance as
    E[x^2] - mean^2, the slope in float32, one rounding to the compute
    dtype; the other InstanceNorms in plain torch (`_instance_norm`:
    float32 mean and variance in one pass over a float32 copy, the
    normalization in float32, one rounding);
  * in the compute dtype (bfloat16 on the card) every activation, weight,
    residual sum and attention bias is held in that dtype; LayerNorm,
    softmax and the statistics accumulate in float32.

The parameters are a flat dict under MONAI's state_dict names and layouts
(`swinViT.layers1.0.blocks.0.attn.qkv.weight`, `encoder1.layer.conv1.conv.weight`,
...), so that a MONAI checkpoint loads as it is (its
`relative_position_index` buffers are not read). `prepare(params, cfg)`
casts them once to the compute dtype and the conv kernels to DHWIO, and
keeps each block's attention bias (relative-position bias, plus the shift
mask in shifted blocks) per token-grid shape.

Under a profiler session (`utils.profiling`) each stage with its merge is
the span `swin.stage`, each window attention (the attention core, from q,
k, v to the heads' outputs) `swin.attn`, each res block `unetr.block` and
each transposed conv `unetr.up`; the counters `swin.tokens` and
`swin.tokens_attended` add each block's real and padded tokens.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch
import torch.nn.functional as F

from ..ops.conv import conv3d, conv_transpose3d
from ..ops.norm_leaky import instance_norm_leaky_ndhwc
from ..utils.profiling import count, span

LN_EPS = 1e-5
IN_EPS = 1e-5
SLOPE = 0.01
MASK_VALUE = -100.0  # MONAI's `compute_mask`
ALIGN = 8  # the attention bias's row pitch, in elements (SDPA takes it without a copy)


@dataclasses.dataclass(frozen=True)
class SwinUNETRConfig:
    in_channels: int = 2
    out_channels: int = 1
    feature_size: int = 48
    depths: tuple = (2, 2, 2, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 2
    mlp_ratio: float = 4.0
    normalize: bool = True
    compute_dtype: torch.dtype = torch.float32  # bfloat16 on the card

    def __post_init__(self):
        if self.patch_size != 2:
            raise ValueError("Swin UNETR's decoder needs patch_size 2")
        if len(self.depths) != 4 or len(self.num_heads) != 4:
            raise ValueError("Swin UNETR has four stages")


def stage_channels(cfg: SwinUNETRConfig) -> list[int]:
    """The token width of each stage's blocks: F, 2F, 4F, 8F."""
    return [cfg.feature_size * 2 ** i for i in range(4)]


def window_shift(dims, window: int, shifted: bool):
    """(window, shift) per axis of a token grid `dims`, MONAI's
    `get_window_size`: an axis no longer than the window takes its extent
    and no shift."""
    win = tuple(d if d <= window else window for d in dims)
    shift = tuple(0 if d <= window or not shifted else window // 2 for d in dims)
    return win, shift


def _full_index(w: int) -> torch.Tensor:
    """(w^3, w^3) index into the (2w-1)^3 relative-position table: the
    (d, h, w) offsets shifted by w - 1, strides (2w-1)^2 and 2w-1. A
    smaller window takes its first N x N entries, as MONAI does."""
    g = torch.stack(torch.meshgrid(*[torch.arange(w)] * 3, indexing="ij")).flatten(1)
    rel = (g[:, :, None] - g[:, None, :]).permute(1, 2, 0) + (w - 1)
    return rel[..., 0] * (2 * w - 1) ** 2 + rel[..., 1] * (2 * w - 1) + rel[..., 2]


def shift_regions(padded, win, shift) -> torch.Tensor:
    """(nW, N) the shift region of each token of each window of the rolled,
    padded grid (MONAI's `compute_mask` before the pairwise comparison)."""
    ids = torch.zeros(padded, dtype=torch.int64)
    cnt = 0
    bands = [(slice(-w), slice(-w, -s), slice(-s, None)) if s else (slice(None),)
             for w, s in zip(win, shift)]
    for a, b, c in itertools.product(*bands):
        ids[a, b, c] = cnt
        cnt += 1
    return _partition(ids[None, ..., None], win)[..., 0]


def _partition(x: torch.Tensor, win) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * nW, N, C), windows in (b, d, h, w) order."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // win[0], win[0], h // win[1], win[1], w // win[2], win[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, win[0] * win[1] * win[2], c)


def _reverse(x: torch.Tensor, win, b: int, dims) -> torch.Tensor:
    d, h, w = dims
    x = x.view(b, d // win[0], h // win[1], w // win[2], win[0], win[1], win[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def merge_cat(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, D/2, H/2, W/2, 8C): the 2x2x2 cell's tokens
    in `itertools.product(range(2), repeat=3)` order over (d, h, w), odd
    extents padded with zeros at the end."""
    _, d, h, w, _ = x.shape
    if d % 2 or h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    return torch.cat([x[:, i::2, j::2, k::2] for i, j, k in itertools.product(range(2), repeat=3)],
                     dim=-1)


# ------------------------------------------------------------- parameters


def _block_prefix(stage: int, block: int) -> str:
    return f"swinViT.layers{stage + 1}.0.blocks.{block}."


def _res_names(cfg: SwinUNETRConfig):
    """(module prefix, cin, cout) of the ten res blocks, in forward order."""
    f = cfg.feature_size
    enc = [("encoder1.layer.", cfg.in_channels, f), ("encoder2.layer.", f, f),
           ("encoder3.layer.", 2 * f, 2 * f), ("encoder4.layer.", 4 * f, 4 * f),
           ("encoder10.layer.", 16 * f, 16 * f)]
    dec = [(f"decoder{i}.conv_block.", 2 * c, c)
           for i, c in zip((5, 4, 3, 2, 1), (8 * f, 4 * f, 2 * f, f, f))]
    return enc + dec


def param_shapes(cfg: SwinUNETRConfig) -> dict:
    """{MONAI state_dict name: shape} of every learned parameter."""
    f, p, w = cfg.feature_size, cfg.patch_size, cfg.window_size
    out = {"swinViT.patch_embed.proj.weight": (f, cfg.in_channels, p, p, p),
           "swinViT.patch_embed.proj.bias": (f,)}
    for i, (c, heads) in enumerate(zip(stage_channels(cfg), cfg.num_heads)):
        hid = int(c * cfg.mlp_ratio)
        for j in range(cfg.depths[i]):
            pre = _block_prefix(i, j)
            out.update({pre + "norm1.weight": (c,), pre + "norm1.bias": (c,),
                        pre + "attn.relative_position_bias_table": ((2 * w - 1) ** 3, heads),
                        pre + "attn.qkv.weight": (3 * c, c), pre + "attn.qkv.bias": (3 * c,),
                        pre + "attn.proj.weight": (c, c), pre + "attn.proj.bias": (c,),
                        pre + "norm2.weight": (c,), pre + "norm2.bias": (c,),
                        pre + "mlp.linear1.weight": (hid, c), pre + "mlp.linear1.bias": (hid,),
                        pre + "mlp.linear2.weight": (c, hid), pre + "mlp.linear2.bias": (c,)})
        pre = f"swinViT.layers{i + 1}.0.downsample."
        out.update({pre + "norm.weight": (8 * c,), pre + "norm.bias": (8 * c,),
                    pre + "reduction.weight": (2 * c, 8 * c)})
    for pre, cin, cout in _res_names(cfg):
        out[pre + "conv1.conv.weight"] = (cout, cin, 3, 3, 3)
        out[pre + "conv2.conv.weight"] = (cout, cout, 3, 3, 3)
        if cin != cout:
            out[pre + "conv3.conv.weight"] = (cout, cin, 1, 1, 1)
    for i, cin, c in zip((5, 4, 3, 2, 1), (16 * f, 8 * f, 4 * f, 2 * f, f),
                         (8 * f, 4 * f, 2 * f, f, f)):
        out[f"decoder{i}.transp_conv.conv.weight"] = (cin, c, 2, 2, 2)
    out["out.conv.conv.weight"] = (cfg.out_channels, f, 1, 1, 1)
    out["out.conv.conv.bias"] = (cfg.out_channels,)
    return out


def load_params(path: str) -> dict:
    """A MONAI `SwinUNETR` state_dict (or a checkpoint holding one under
    `state_dict`) from `path`, on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd)


class Prepared:
    """The parameters in the compute dtype (conv kernels as DHWIO,
    transposed-conv kernels as (k, k, k, Cin, Cout)) on their device, and
    each block's attention bias per token-grid shape, made at first use."""

    def __init__(self, params: dict, cfg: SwinUNETRConfig):
        missing = sorted(set(param_shapes(cfg)) - set(params))
        if missing:
            raise KeyError(f"Swin UNETR parameters missing: {missing[:4]}...")
        dt = cfg.compute_dtype
        self.cfg = cfg
        self.w = {}
        for name in param_shapes(cfg):
            t = params[name].detach()
            if name.endswith("relative_position_bias_table"):
                self.w[name] = t.to(torch.float32)
            elif "transp_conv" in name:
                self.w[name] = t.permute(2, 3, 4, 0, 1).contiguous().to(dt)
            elif t.dim() == 5:
                self.w[name] = t.permute(2, 3, 4, 1, 0).contiguous().to(dt)
            else:
                self.w[name] = t.to(dt)
        self._bias = {}

    def attn_bias(self, stage: int, block: int, padded, win, shift) -> torch.Tensor:
        """(nW or 1, heads, N, N) in the compute dtype: the block's
        relative-position bias, plus in a shifted block the -100 shift mask
        of each window; rows at a pitch of a multiple of ALIGN elements."""
        key = (stage, block, tuple(padded), win, shift)
        out = self._bias.get(key)
        if out is None:
            table = self.w[_block_prefix(stage, block) + "attn.relative_position_bias_table"]
            n = win[0] * win[1] * win[2]
            idx = _full_index(self.cfg.window_size)[:n, :n].to(table.device)
            bias = table[idx.reshape(-1)].view(n, n, -1).permute(2, 0, 1)[None]
            if any(shift):
                ids = shift_regions(padded, win, shift).to(table.device)
                mask = (ids[:, :, None] != ids[:, None, :]).to(torch.float32) * MASK_VALUE
                bias = bias + mask[:, None]
            pitch = -(-n // ALIGN) * ALIGN
            out = bias.new_zeros((*bias.shape[:-1], pitch), dtype=self.cfg.compute_dtype)
            out = out[..., :n]
            out.copy_(bias)
            self._bias[key] = out
        return out


def prepare(params: dict, cfg: SwinUNETRConfig) -> Prepared:
    return Prepared(params, cfg)


# ---------------------------------------------------------------- forward


def _layer_norm(x, w=None, b=None):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps=LN_EPS)


def _attention(win: torch.Tensor, pw: dict, pre: str, heads: int, bias: torch.Tensor,
               b: int) -> torch.Tensor:
    """Window attention of (B * nW, N, C) tokens; `bias` (nW or 1, heads, N, N)
    is the same for every tile's windows, so each tile's windows are one call."""
    bw, n, c = win.shape
    qkv = F.linear(win, pw[pre + "attn.qkv.weight"], pw[pre + "attn.qkv.bias"])
    qkv = qkv.view(b, bw // b, n, 3, heads, c // heads).permute(3, 0, 1, 4, 2, 5)
    with span("swin.attn"):
        out = torch.empty((b, bw // b, n, heads, c // heads), dtype=win.dtype, device=win.device)
        mask = bias.expand(bw // b, heads, n, n)
        for t in range(b):
            out[t] = F.scaled_dot_product_attention(qkv[0, t], qkv[1, t], qkv[2, t],
                                                    attn_mask=mask).transpose(1, 2)
        out = out.view(bw, n, c)
    return F.linear(out, pw[pre + "attn.proj.weight"], pw[pre + "attn.proj.bias"])


def _swin_block(x: torch.Tensor, prep: Prepared, stage: int, block: int) -> torch.Tensor:
    cfg, pw = prep.cfg, prep.w
    pre = _block_prefix(stage, block)
    b, d, h, w, c = x.shape
    win, shift = window_shift((d, h, w), cfg.window_size, block % 2 == 1)
    pads = [(-e) % k for e, k in zip((d, h, w), win)]
    padded = (d + pads[0], h + pads[1], w + pads[2])
    count("swin.tokens", b * d * h * w)
    count("swin.tokens_attended", b * padded[0] * padded[1] * padded[2])
    y = _layer_norm(x, pw[pre + "norm1.weight"], pw[pre + "norm1.bias"])
    if any(pads):
        y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    if any(shift):
        y = torch.roll(y, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    heads = cfg.num_heads[stage]
    y = _attention(_partition(y, win), pw, pre, heads,
                   prep.attn_bias(stage, block, padded, win, shift), b)
    y = _reverse(y, win, b, padded)
    if any(shift):
        y = torch.roll(y, shifts=shift, dims=(1, 2, 3))
    if any(pads):
        y = y[:, :d, :h, :w]
    x = x + y
    y = _layer_norm(x, pw[pre + "norm2.weight"], pw[pre + "norm2.bias"])
    y = F.gelu(F.linear(y, pw[pre + "mlp.linear1.weight"], pw[pre + "mlp.linear1.bias"]))
    return x + F.linear(y, pw[pre + "mlp.linear2.weight"], pw[pre + "mlp.linear2.bias"])


def _stage(x: torch.Tensor, prep: Prepared, stage: int) -> torch.Tensor:
    """A stage's blocks and its patch merging."""
    pw = prep.w
    with span("swin.stage"):
        for j in range(prep.cfg.depths[stage]):
            x = _swin_block(x, prep, stage, j)
        pre = f"swinViT.layers{stage + 1}.0.downsample."
        x = _layer_norm(merge_cat(x), pw[pre + "norm.weight"], pw[pre + "norm.bias"])
        return F.linear(x, pw[pre + "reduction.weight"])


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm without affine of NDHWC x, statistics per (b, c) over D,
    H, W in float32, the result rounded once to x's dtype."""
    var, mean = torch.var_mean(x.to(torch.float32), dim=(1, 2, 3), keepdim=True, correction=0)
    rstd = torch.rsqrt(var + IN_EPS)
    return torch.addcmul(-mean * rstd, x, rstd).to(x.dtype)


def _res_block(x: torch.Tensor, pw: dict, pre: str) -> torch.Tensor:
    with span("unetr.block"):
        y = instance_norm_leaky_ndhwc(conv3d(x, pw[pre + "conv1.conv.weight"], padding=1))
        y = _instance_norm(conv3d(y, pw[pre + "conv2.conv.weight"], padding=1))
        k3 = pw.get(pre + "conv3.conv.weight")
        s = x if k3 is None else _instance_norm(conv3d(x, k3))
        return F.leaky_relu(y + s, SLOPE)


def _up_block(a: torch.Tensor, skip: torch.Tensor, pw: dict, i: int) -> torch.Tensor:
    with span("unetr.up"):
        a = conv_transpose3d(a, pw[f"decoder{i}.transp_conv.conv.weight"], stride=2)
    return _res_block(torch.cat([a, skip], dim=-1), pw, f"decoder{i}.conv_block.")


def apply(params: dict, x: torch.Tensor, *, cfg: SwinUNETRConfig = SwinUNETRConfig(),
          prepared: Prepared | None = None) -> torch.Tensor:
    """Logits (B, D, H, W, out_channels) in the compute dtype of NDHWC
    input x (B, D, H, W, in_channels). `prepared`: `prepare(params, cfg)`,
    kept by the caller across calls (made here when None)."""
    prep = prepared if prepared is not None else prepare(params, cfg)
    pw = prep.w
    x = x.to(cfg.compute_dtype)
    p = cfg.patch_size
    _, d, h, w, _ = x.shape
    xe = x
    if d % p or h % p or w % p:
        xe = F.pad(x, (0, 0, 0, (-w) % p, 0, (-h) % p, 0, (-d) % p))
    t = conv3d(xe, pw["swinViT.patch_embed.proj.weight"], pw["swinViT.patch_embed.proj.bias"],
               stride=p)
    norm = _layer_norm if cfg.normalize else (lambda v: v)
    hidden = [norm(t)]
    for i in range(4):
        t = _stage(t, prep, i)
        hidden.append(norm(t))
    enc0 = _res_block(x, pw, "encoder1.layer.")
    enc1 = _res_block(hidden[0], pw, "encoder2.layer.")
    enc2 = _res_block(hidden[1], pw, "encoder3.layer.")
    enc3 = _res_block(hidden[2], pw, "encoder4.layer.")
    dec = _res_block(hidden[4], pw, "encoder10.layer.")
    for i, skip in zip((5, 4, 3, 2, 1), (hidden[3], enc3, enc2, enc1, enc0)):
        dec = _up_block(dec, skip, pw, i)
    return conv3d(dec, pw["out.conv.conv.weight"], pw["out.conv.conv.bias"])

"""Scale-Enhanced U-Net, eval-mode forward in PyTorch.

A 4-level encoder-decoder over 2-channel dual-windowed CT crops
(reference SE_UNet.py:9-242): every conv block is Conv3x3x3 ->
InstanceNorm -> LeakyReLU -> one or two spatial SE gates, plus a
2-channel side head; each encoder level fuses its three block outputs
with a 1x1x1 CATConv and adds a CATConv of the (pooled) raw input; two
1x1x1 heads read the concatenated side outputs (12 encoder sides ->
`pred_en`, 6 decoder sides -> `pred_de`). Raw logits out.

Channel plan (in -> out per level):
  enc L1: 2->8->16->32(dil2), cat(56)->32, + inj(2->32)   sides x3 @ s=1
  enc L2: 32->32->32(dil2)->64(dil2), cat(128)->64, + inj sides x3 @ s=2
  enc L3: 64->64->64(dil2)->64(dil2), cat(192)->64, + inj sides x3 @ s=4
  bottleneck: 64->64->64->64, cat(192)->64               sides x3 @ s=8
  dec L3: cat(128)->64->64, cat(128)->64                 sides x2 @ s=4
  dec L2: cat(128)->64->32, cat(96)->32                  sides x2 @ s=2
  dec L1: cat(64)->32->16, cat(48)->16                   sides x2 @ s=1

Two forwards over one parameter tree (DHWIO weights, NDHWC tensors):
  * `apply`: the reference layout, block by block;
  * `apply_fast`: the same function with the full-resolution and 1/2
    levels in space-to-depth layout (ops/s2d.py), the side heads
    composed into the prediction heads, and every s2d block's
    InstanceNorm + LeakyReLU + SE gates run as one fused epilogue
    kernel (ops/epilogue_s2d.py). Equal to `apply` up to float
    reassociation.

`SEUNet` is the `nn.Module` holding the parameters under the reference
state_dict names. Train mode (DropLayer, gradients) is not ported yet:
`train=True` raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from ..ops import (
    conv3d,
    gated_norm_block,
    instance_norm,
    leaky_relu,
    max_pool3d,
    phased_gated_block,
    upsample_trilinear,
)
from ..ops.resize import _interp_matrix
from ..ops.s2d import (
    _interp_pair,
    bias_to_s2d,
    conv3_weight_to_s2d,
    depth_to_space,
    dil2_group_weight,
    grouped_pointwise_multi_pre,
    grouped_pointwise_multi_weight,
    max_pool_s2d,
    phased_conv_weights,
    space_to_depth,
    upsample_to_s2d,
)
from ..utils.devices import resolve_device
from .torch_import import params_from_state_dict

Params = dict[str, Any]

_TRAIN_MSG = ("train mode (DropLayer and the epilogue backwards) is not "
              "ported yet; it comes with the train slice")


@dataclasses.dataclass(frozen=True)
class SEUNetConfig:
    in_channels: int = 2
    n_classes: int = 1
    side_channels: int = 2  # out_channel2 in the reference
    drop_threshold: float = 0.3
    compute_dtype: torch.dtype = torch.float32  # bfloat16 for inference


# (name, kind, (cin, cout)); kind: sse1/sse2 = SSEConv with 1/2 gates
_SPEC: list[tuple[str, str, tuple[int, int]]] = [
    ("ec1", "sse1", (-1, 8)), ("ec2", "sse1", (8, 16)), ("ec3", "sse1", (16, 32)),
    ("ec33", "cat", (56, 32)), ("x33", "cat", (-1, 32)),
    ("ec4", "sse2", (32, 32)), ("ec5", "sse2", (32, 32)), ("ec6", "sse2", (32, 64)),
    ("ec63", "cat", (128, 64)), ("x63", "cat", (-1, 64)),
    ("ec7", "sse2", (64, 64)), ("ec8", "sse2", (64, 64)), ("ec9", "sse2", (64, 64)),
    ("ec93", "cat", (192, 64)), ("x93", "cat", (-1, 64)),
    ("ec10", "sse2", (64, 64)), ("ec11", "sse2", (64, 64)), ("ec12", "sse2", (64, 64)),
    ("ec123", "cat", (192, 64)),
    ("dc1", "sse2", (128, 64)), ("dc2", "sse2", (64, 64)), ("dc22", "cat", (128, 64)),
    ("dc3", "sse2", (128, 64)), ("dc4", "sse2", (64, 32)), ("dc42", "cat", (96, 32)),
    ("dc5", "sse1", (64, 32)), ("dc6", "sse1", (32, 16)), ("dc62", "cat", (48, 16)),
]


# ---------------------------------------------------------------- module


class _Conv(nn.Module):
    """Conv3d parameters (OIDHW) with PyTorch's default init
    distribution U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias,
    drawn from an explicit generator."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool,
                 generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(cin * k ** 3)

        def uniform(shape):
            u = torch.rand(shape, generator=generator, dtype=torch.float32)
            return nn.Parameter(u * (2 * bound) - bound)

        self.weight = uniform((cout, cin, k, k, k))
        self.bias = uniform((cout,)) if bias else None


class _SSEConv(nn.Module):
    def __init__(self, cin, cout, side, n_gates, generator):
        super().__init__()
        self.conv1 = _Conv(cin, cout, 3, True, generator)
        self.conv2 = _Conv(cout, side, 1, True, generator)
        self.conv_se = _Conv(cout, 1, 1, False, generator)
        if n_gates == 2:
            self.conv_se2 = _Conv(cout, 1, 1, False, generator)


class _CATConv(nn.Module):
    def __init__(self, cin, cout, generator):
        super().__init__()
        self.conv1 = _Conv(cin, cout, 1, False, generator)


class SEUNet(nn.Module):
    """The SE-UNet's parameters under the reference state_dict names
    (reference `.pth` files load with `load_state_dict`). `forward` runs
    the eval-mode fast path."""

    def __init__(self, cfg: SEUNetConfig = SEUNetConfig(), *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        s = cfg.side_channels
        for name, kind, (cin, cout) in _SPEC:
            cin = cfg.in_channels if cin < 0 else cin
            if kind == "cat":
                mod = _CATConv(cin, cout, generator)
            else:
                mod = _SSEConv(cin, cout, s, 1 if kind == "sse1" else 2, generator)
            self.add_module(name, mod)
        self.dc0_0 = _Conv(12 * s, cfg.n_classes, 1, True, generator)
        self.dc0_1 = _Conv(6 * s, cfg.n_classes, 1, True, generator)

    def params_tree(self) -> Params:
        """The functional parameter tree (DHWIO views of the parameters)."""
        return params_from_state_dict(dict(self.named_parameters()))

    def forward(self, x: torch.Tensor, **kw):
        return apply_fast(self.params_tree(), x, cfg=self.cfg, **kw)


def get_model(in_channels: int = 2, n_classes: int = 1, seed: int = 0,
              device=None, compute_dtype: torch.dtype = torch.float32):
    """(config, SEUNet) with weights drawn from `seed`, on `device`
    (default `cuda`; raises without CUDA unless `device="cpu"`)."""
    dev = resolve_device(device)
    cfg = SEUNetConfig(in_channels=in_channels, n_classes=n_classes,
                       compute_dtype=compute_dtype)
    model = SEUNet(cfg, generator=torch.Generator().manual_seed(seed))
    return cfg, model.to(dev).eval()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Float32 leaves -> `dtype` (other leaves as they are)."""
    return _tree_map(lambda t: t.to(dtype) if t.dtype == torch.float32 else t, params)


# -------------------------------------------------------- reference layout


def _sse_block(p: Params, x, *, dilation: int, up: int, n_gates: int,
               want_side: bool = True):
    """Conv3 -> IN -> LeakyReLU -> SE gate(s) -> (features, side@full-res)."""
    e = conv3d(x, p["conv"]["w"], p["conv"]["b"], padding=dilation,
               dilation=dilation)
    e = leaky_relu(instance_norm(e))
    for g in range(n_gates):
        e = e * torch.sigmoid(conv3d(e, p[f"se{g}"]["w"]))
    if not want_side:
        return e, None
    side = conv3d(e, p["side"]["w"], p["side"]["b"])
    return e, upsample_trilinear(side, up)


def _cat_block(p: Params, x):
    return leaky_relu(instance_norm(conv3d(x, p["conv"]["w"])))


def apply(params: Params, x: torch.Tensor, *, cfg: SEUNetConfig = SEUNetConfig(),
          train: bool = False):
    """Forward on NDHWC input (B, D, H, W, in_channels) in the reference
    layout. Returns the raw-logit heads (pred_en, pred_de)."""
    if train:
        raise NotImplementedError(_TRAIN_MSG)
    p = cast_params(params, cfg.compute_dtype)
    x = x.to(cfg.compute_dtype)

    def cat(*ts):
        return torch.cat(ts, dim=-1)

    e0, s0 = _sse_block(p["ec1"], x, dilation=1, up=1, n_gates=1)
    e1, s1 = _sse_block(p["ec2"], e0, dilation=1, up=1, n_gates=1)
    e1_1, s2 = _sse_block(p["ec3"], e1, dilation=2, up=1, n_gates=1)
    e1 = _cat_block(p["ec33"], cat(e1_1, e0, e1)) + _cat_block(p["x33"], x)
    e2 = max_pool3d(e1)
    x = max_pool3d(x)

    e2, s3 = _sse_block(p["ec4"], e2, dilation=1, up=2, n_gates=2)
    e3, s4 = _sse_block(p["ec5"], e2, dilation=2, up=2, n_gates=2)
    e3_1, s5 = _sse_block(p["ec6"], e3, dilation=2, up=2, n_gates=2)
    e3 = _cat_block(p["ec63"], cat(e3_1, e2, e3)) + _cat_block(p["x63"], x)
    e4 = max_pool3d(e3)
    x = max_pool3d(x)

    e4, s6 = _sse_block(p["ec7"], e4, dilation=1, up=4, n_gates=2)
    e5, s7 = _sse_block(p["ec8"], e4, dilation=2, up=4, n_gates=2)
    e5_1, s8 = _sse_block(p["ec9"], e5, dilation=2, up=4, n_gates=2)
    e5 = _cat_block(p["ec93"], cat(e5_1, e4, e5)) + _cat_block(p["x93"], x)
    e6 = max_pool3d(e5)

    e6, s9 = _sse_block(p["ec10"], e6, dilation=1, up=8, n_gates=2)
    e7, s10 = _sse_block(p["ec11"], e6, dilation=1, up=8, n_gates=2)
    e7_1, s11 = _sse_block(p["ec12"], e7, dilation=1, up=8, n_gates=2)
    e7 = _cat_block(p["ec123"], cat(e7_1, e6, e7))

    e8 = upsample_trilinear(e7, 2)
    d0, s12 = _sse_block(p["dc1"], cat(e8, e5), dilation=1, up=4, n_gates=2)
    d0_1, s13 = _sse_block(p["dc2"], d0, dilation=1, up=4, n_gates=2)
    d0 = _cat_block(p["dc22"], cat(d0_1, d0))

    d1 = upsample_trilinear(d0, 2)
    d1, s14 = _sse_block(p["dc3"], cat(d1, e3), dilation=1, up=2, n_gates=2)
    d1_1, s15 = _sse_block(p["dc4"], d1, dilation=1, up=2, n_gates=2)
    d1 = _cat_block(p["dc42"], cat(d1_1, d1))

    d2 = upsample_trilinear(d1, 2)
    d2, s16 = _sse_block(p["dc5"], cat(d2, e1), dilation=1, up=1, n_gates=1)
    _, s17 = _sse_block(p["dc6"], d2, dilation=1, up=1, n_gates=1)
    # dc62's output feeds nothing in the reference forward

    sides_en = cat(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11)
    sides_de = cat(s12, s13, s14, s15, s16, s17)
    pred_en = conv3d(sides_en, p["head_en"]["w"], p["head_en"]["b"])
    pred_de = conv3d(sides_de, p["head_de"]["w"], p["head_de"]["b"])
    return pred_en, pred_de


# --------------------------------------------------------------- fast path

# partial-dense group counts of the dil-2 s2d blocks (ops.s2d.dil2_group_weight)
_DIL2_NG = {"ec3": 2, "ec5": 2, "ec6": 4}


def prepare_fast_params(params: Params, cfg: SEUNetConfig,
                        n: int | None = None) -> Params:
    """Every weight transform `apply_fast` needs, computed once: s2d
    kernel lifts, phase-stacked kernels (concat interleaves folded in),
    block-diagonal pointwise weights, the compact (G, C) SE gate
    vectors, and (given `n`, the s2d grid size = cube/2) the
    interpolation matrices."""
    dt = cfg.compute_dtype
    p = cast_params(params, dt)
    dev = next(iter(_leaves(params))).device
    fp: Params = {}

    def wse(name: str, n_gates: int) -> torch.Tensor:
        return torch.stack([p[name][f"se{g}"]["w"][0, 0, 0, :, 0]
                            for g in range(n_gates)]).contiguous()

    for name in ("ec1", "ec2"):
        fp[name] = {"w": conv3_weight_to_s2d(p[name]["conv"]["w"]),
                    "b": bias_to_s2d(p[name]["conv"]["b"]), "wse": wse(name, 1)}
    for name, gates in (("ec3", 1), ("ec5", 2), ("ec6", 2)):
        ng = _DIL2_NG[name]
        fp[name] = {"wgroup": dil2_group_weight(p[name]["conv"]["w"], ng, dt),
                    "bg": p[name]["conv"]["b"].repeat(8), "ng": ng,
                    "wse": wse(name, gates)}
    # phased blocks; splits = original channel counts of the plain concat
    for name, gates, splits in (
        ("ec4", 2, None),
        ("dc3", 2, (64, 64)),   # cat(up(d0), e3s)
        ("dc4", 2, None),
        ("dc5", 1, (32, 32)),   # cat(up(d1), e1)
        ("dc6", 1, None),
    ):
        w_all, b_all = phased_conv_weights(p[name]["conv"]["w"],
                                           p[name]["conv"]["b"], splits)
        fp[name] = {"w_all": w_all, "b_all": b_all, "wse": wse(name, gates)}
    for name, counts in (
        ("ec33", (32, 8, 16)),  # cat(e1_1, e0, e1)
        ("x33", (cfg.in_channels,)),
        ("ec63", (64, 32, 32)),  # cat(e3_1s, e2s, e3s)
        ("x63", (cfg.in_channels,)),
        ("dc42", (32, 64)),     # cat(d1_1s, d1s)
    ):
        fp[name] = {"wd": grouped_pointwise_multi_weight(
            p[name]["conv"]["w"][0, 0, 0], counts, dt)}
    if n is not None:
        def pair(a, b):
            return torch.from_numpy(_interp_pair(a, b)).to(dev)

        fp["interp"] = {(n // 2, n): pair(n // 2, n), (n, 2 * n): pair(n, 2 * n),
                        (n // 2, 2 * n): pair(n // 2, 2 * n),
                        (n // 4, 2 * n): pair(n // 4, 2 * n)}
        fp["interp_tri"] = torch.from_numpy(_interp_matrix(n // 4, n // 2)).to(dev)
    return fp


def _sse_block_s2d(pre: Params, x):
    """SSEConv (one gate) on an s2d tensor via the block-lifted dense 3^3
    conv (ec1/ec2), then the gathered epilogue."""
    return gated_norm_block(conv3d(x, pre["w"], pre["b"], padding=1), pre["wse"])


def _sse_block_s2d_dil2(pre: Params, x):
    """Dilation-2 SSEConv on an s2d tensor: the 8 sub-grid dil-1 convs as
    one grouped conv (partial-dense lift), then the gathered epilogue."""
    y = conv3d(x, pre["wgroup"], pre["bg"], padding=1, groups=pre["ng"])
    return gated_norm_block(y, pre["wse"])


def _sse_block_s2d_phased(pre: Params, x):
    """SSEConv on an s2d tensor (or a list forming a plain concat) via
    the phased conv, then the phased epilogue."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    return phased_gated_block(xs, pre["w_all"], pre["b_all"], pre["wse"])


def _cat_block_s2d(pre: Params, x):
    """CATConv on an s2d tensor or a list forming a plain concat: the
    interleave permutation is folded into the pointwise weight; gate-free
    gathered epilogue."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    return gated_norm_block(grouped_pointwise_multi_pre(xs, pre["wd"]), None)


def _composed_head(metas, head_p: Params, interp=None, s2d_out: bool = False):
    """Eval-mode deep-supervision head without materializing the side
    outputs: conv1x1(cat(upsample(side_i))) is linear, and align_corners
    interpolation rows sum to 1, so it folds into
        sum_i upsample(feat_i @ (w_side_i @ W_head_i)) + bias.

    `metas`: ordered (feat, block_params, kind, scale); kind 's2d' is an
    s2d feature at the output grid, 's2d_up' an s2d feature at a coarser
    grid, 'std' a plain (B, m, m, m, Ci) feature; the last two upsample
    by `scale`. Returns (B, 2n, 2n, 2n, 1) logits, or the s2d
    (B, n, n, n, 8) form when `s2d_out`."""
    f32 = torch.float32
    hw = head_p["w"][0, 0, 0, :, 0].to(f32)
    batch = metas[0][0].shape[0]
    dev = hw.device
    eye8 = torch.eye(8, dtype=f32, device=dev)
    total = None
    per_scale: dict = {}
    bias = torch.zeros(batch, dtype=f32, device=dev) + head_p["b"].to(f32)[0]
    ch = 0
    for feat, bp, kind, sc in metas:
        w_side = bp["side"]["w"][0, 0, 0].to(f32)  # (Ci, 2)
        whe = hw[ch : ch + 2]
        ch += 2
        bias = bias + (bp["side"]["b"].to(f32) * whe).sum()
        w1 = w_side @ whe  # (Ci,)
        if kind in ("s2d", "s2d_up"):
            wk = torch.einsum("pq,c->pcq", eye8, w1).reshape(feat.shape[-1], 8)
            contrib = (feat @ wk.to(feat.dtype)).to(f32)
            if kind == "s2d":
                total = contrib if total is None else total + contrib
                continue
            contrib = depth_to_space(contrib)
        else:
            contrib = (feat @ w1.to(feat.dtype)).unsqueeze(-1).to(f32)
        per_scale[sc] = contrib if sc not in per_scale else per_scale[sc] + contrib
    for sc, acc in per_scale.items():
        m = acc.shape[1]
        pair = interp.get((m, m * sc)) if interp else None
        up = upsample_to_s2d(acc, sc, pair=pair)
        total = up if total is None else total + up
    bias = bias.reshape(-1, 1, 1, 1, 1)
    if s2d_out:
        return total + bias
    return depth_to_space(total) + bias


def apply_fast(params: Params, x: torch.Tensor, *,
               cfg: SEUNetConfig = SEUNetConfig(), train: bool = False,
               fast_params: Params | None = None, x_is_s2d: bool = False,
               heads_s2d: bool = False):
    """Fast forward; same contract as `apply` (D, H, W divisible by 8).

    `x_is_s2d`: the input is already the s2d entry tensor
    (B, D/2, H/2, W/2, 8*C) with phase-major lanes. `heads_s2d`: return
    both heads in s2d layout (B, D/2, H/2, W/2, 8*n_classes). Neither
    changes values. `fast_params`: `prepare_fast_params(params, cfg)`,
    computed here when None."""
    if train:
        raise NotImplementedError(_TRAIN_MSG)
    dt = cfg.compute_dtype
    p = cast_params(params, dt)
    x = x.to(dt)
    fp = fast_params if fast_params is not None else prepare_fast_params(params, cfg)
    interp = fp.get("interp", {})

    def cat(*ts):
        return torch.cat(ts, dim=-1)

    # ---- encoder level 1 (s2d at the full-resolution grid) ----
    xs = x if x_is_s2d else space_to_depth(x)
    e0 = _sse_block_s2d(fp["ec1"], xs)
    e1 = _sse_block_s2d(fp["ec2"], e0)
    e1_1 = _sse_block_s2d_dil2(fp["ec3"], e1)
    f0, f1, f2 = e0, e1, e1_1
    e1 = _cat_block_s2d(fp["ec33"], [e1_1, e0, e1]) + _cat_block_s2d(fp["x33"], xs)
    # ---- encoder level 2 (s2d at the 1/2 grid) ----
    e2s = space_to_depth(max_pool_s2d(e1))
    x2s = space_to_depth(max_pool_s2d(xs))
    e2s = _sse_block_s2d_phased(fp["ec4"], e2s)
    e3s = _sse_block_s2d_dil2(fp["ec5"], e2s)
    e3_1s = _sse_block_s2d_dil2(fp["ec6"], e3s)
    f3, f4, f5 = e2s, e3s, e3_1s
    e3s = (_cat_block_s2d(fp["ec63"], [e3_1s, e2s, e3s])
           + _cat_block_s2d(fp["x63"], x2s))
    e4 = max_pool_s2d(e3s)
    x3 = max_pool_s2d(x2s)

    # ---- encoder level 3 (1/4) ----
    e4, _ = _sse_block(p["ec7"], e4, dilation=1, up=1, n_gates=2, want_side=False)
    e5, _ = _sse_block(p["ec8"], e4, dilation=2, up=1, n_gates=2, want_side=False)
    e5_1, _ = _sse_block(p["ec9"], e5, dilation=2, up=1, n_gates=2, want_side=False)
    f6, f7, f8 = e4, e5, e5_1
    e5 = _cat_block(p["ec93"], cat(e5_1, e4, e5)) + _cat_block(p["x93"], x3)
    e6 = max_pool3d(e5)

    # ---- bottleneck (1/8) ----
    e6, _ = _sse_block(p["ec10"], e6, dilation=1, up=1, n_gates=2, want_side=False)
    e7, _ = _sse_block(p["ec11"], e6, dilation=1, up=1, n_gates=2, want_side=False)
    e7_1, _ = _sse_block(p["ec12"], e7, dilation=1, up=1, n_gates=2, want_side=False)
    f9, f10, f11 = e6, e7, e7_1
    e7 = _cat_block(p["ec123"], cat(e7_1, e6, e7))

    # ---- decoder level 3 (1/4) ----
    e8 = upsample_trilinear(e7, 2, mat=fp.get("interp_tri"))
    d0, _ = _sse_block(p["dc1"], cat(e8, e5), dilation=1, up=1, n_gates=2,
                       want_side=False)
    d0_1, _ = _sse_block(p["dc2"], d0, dilation=1, up=1, n_gates=2, want_side=False)
    f12, f13 = d0, d0_1
    d0 = _cat_block(p["dc22"], cat(d0_1, d0))

    # ---- decoder level 2 (s2d at the 1/2 grid) ----
    m = d0.shape[1]
    d1s = upsample_to_s2d(d0, 2, pair=interp.get((m, 2 * m)))
    d1s = _sse_block_s2d_phased(fp["dc3"], [d1s, e3s])
    d1_1s = _sse_block_s2d_phased(fp["dc4"], d1s)
    f14, f15 = d1s, d1_1s
    d1s = _cat_block_s2d(fp["dc42"], [d1_1s, d1s])

    # ---- decoder level 1 (s2d at the full-resolution grid) ----
    d1f = depth_to_space(d1s)
    m = d1f.shape[1]
    up_s = upsample_to_s2d(d1f, 2, pair=interp.get((m, 2 * m)))
    d2 = _sse_block_s2d_phased(fp["dc5"], [up_s, e1])
    d2_1 = _sse_block_s2d_phased(fp["dc6"], d2)
    f16, f17 = d2, d2_1
    # dc62's output feeds nothing in the reference forward: skipped

    metas_en = [
        (f0, p["ec1"], "s2d", 1), (f1, p["ec2"], "s2d", 1), (f2, p["ec3"], "s2d", 1),
        (f3, p["ec4"], "s2d_up", 2), (f4, p["ec5"], "s2d_up", 2),
        (f5, p["ec6"], "s2d_up", 2),
        (f6, p["ec7"], "std", 4), (f7, p["ec8"], "std", 4), (f8, p["ec9"], "std", 4),
        (f9, p["ec10"], "std", 8), (f10, p["ec11"], "std", 8),
        (f11, p["ec12"], "std", 8),
    ]
    metas_de = [
        (f12, p["dc1"], "std", 4), (f13, p["dc2"], "std", 4),
        (f14, p["dc3"], "s2d_up", 2), (f15, p["dc4"], "s2d_up", 2),
        (f16, p["dc5"], "s2d", 1), (f17, p["dc6"], "s2d", 1),
    ]
    pred_en = _composed_head(metas_en, p["head_en"], interp=interp, s2d_out=heads_s2d)
    pred_de = _composed_head(metas_de, p["head_de"], interp=interp, s2d_out=heads_s2d)
    return pred_en.to(torch.float32), pred_de.to(torch.float32)

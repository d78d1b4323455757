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
    reassociation. Under `SEUNetConfig(conv_stats=True)` the phased and
    dil-2 blocks instead run a fused conv + statistics kernel
    (ops/conv_stats.py) and normalize from its sums; under
    `SEUNetConfig(conv_epi=True)` the dil-2 blocks run the dense conv +
    statistics kernel into the gathered epilogue and the phased blocks
    the ungathered phased conv kernel into the phased epilogue.

`SEUNet` is the `nn.Module` holding the parameters under the reference
state_dict names.

With `space=` (a `parallel.DataMesh` whose `space` axis splits the depth;
default configuration only) both forwards run on this rank's depth slab of
each crop and return its slab of the heads: every conv takes its depth
padding from the neighbouring slabs (`parallel.halo`: one s2d plane for
the lifted, grouped dil-2 and phased s2d convs, `dilation` planes for the
reference-layout convs, none for the 1x1x1 convs), every InstanceNorm adds
its statistics over the slabs (`parallel.space_sum`), and the upsamples
take their slab's rows of the whole crop's matrix. Pools, space-to-depth,
the SE gates and DropLayer stay inside a slab.

Train mode (`train=True`) applies DropLayer, the reference's channel
dropout, to the concatenated side outputs in front of each head. Its
uniform draws, (B, 12*side) for the encoder head and (B, 6*side) for the
decoder head, come from an explicit `torch.Generator`, or are passed in
as `drop_draws` (the JAX package's keyed draws cannot be reproduced, so
tests hand both packages the same numbers). DropLayer's scale sums its
mask over the whole batch; a rank of a mesh that runs some rows of a
batch passes the batch's draws and its `drop_rows`. Gradients flow through
everything, `prepare_fast_params` included: the fast path's fused
blocks, and the s2d max pool, are `torch.autograd.Function`s with the
JAX package's hand-written backwards. `cfg.remat` checkpoints each block
(`torch.utils.checkpoint`, non-reentrant), except the phased blocks and,
under `conv_epi`, the dil-2 blocks, whose Functions save only the block
inputs anyway.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import (
    conv3d,
    dil2_conv_stats,
    dil2_gated_block,
    gated_norm_block,
    instance_norm,
    leaky_relu,
    max_pool3d,
    phased_conv_stats,
    phased_gated_block,
    upsample_trilinear,
)
from ..ops.resize import _interp_matrix
from ..ops.s2d import (
    _interp_pair,
    bias_to_s2d,
    conv3_weight_to_s2d,
    depth_to_space,
    dil2_dense_weight,
    dil2_group_weight,
    grouped_pointwise_multi_pre,
    grouped_pointwise_multi_weight,
    instance_norm_from_stats,
    max_pool_s2d,
    phased_conv_weights,
    se_gate_s2d_pre,
    se_gate_weights,
    space_to_depth,
    upsample_to_s2d,
)
from ..utils.devices import resolve_device
from .torch_import import params_from_state_dict

Params = dict[str, Any]

@dataclasses.dataclass(frozen=True)
class SEUNetConfig:
    in_channels: int = 2
    n_classes: int = 1
    side_channels: int = 2  # out_channel2 in the reference
    drop_threshold: float = 0.3
    compute_dtype: torch.dtype = torch.float32  # bfloat16 for inference
    # checkpoint each block in training: its activations are recomputed in
    # backward instead of kept
    remat: bool = False
    # the fused conv + statistics forward of the JAX package's
    # SEUNetConfig(use_pallas=True, use_pallas_epi=False) with PALLAS_DIL2=1:
    # the five phased blocks run `phased_conv_stats`, the three dil-2 blocks
    # `dil2_conv_stats` (ops/conv_stats.py), each followed by the InstanceNorm
    # from the kernel's sums, LeakyReLU and the SE gates in plain torch
    conv_stats: bool = False
    # the conv-to-epilogue forward of the JAX package's
    # SEUNetConfig(batch_minor=True, use_pallas_epi=True) with
    # PALLAS_DIL2BM=1 (the batch-minor layout itself is not carried over):
    # the three dil-2 blocks run the dense block-diagonal conv + statistics
    # kernel `dil2_dense_conv_stats` into the gathered epilogue, the five
    # phased blocks the ungathered conv kernel `phased_conv_ungathered`
    # into the phased epilogue (ops/conv_stats.py, ops/epilogue_s2d.py)
    conv_epi: bool = False

    def __post_init__(self):
        if self.conv_epi and self.conv_stats:
            # the JAX package ignores use_pallas under batch_minor
            raise ValueError("conv_epi and conv_stats are two configurations; pick one")


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


def num_params(params) -> int:
    """The element count of a parameter tree (`SEUNet.params_tree()`), or
    of an `nn.Module`'s parameters (JAX `models/se_unet.py::num_params`)."""
    leaves = params.parameters() if isinstance(params, nn.Module) else _leaves(params)
    return sum(t.numel() for t in leaves)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Float32 leaves -> `dtype` (other leaves as they are)."""
    return _tree_map(lambda t: t.to(dtype) if t.dtype == torch.float32 else t, params)


# -------------------------------------------------------- reference layout


def _sse_block(p: Params, x, *, dilation: int, up: int, n_gates: int,
               want_side: bool = True, space=None):
    """Conv3 -> IN -> LeakyReLU -> SE gate(s) -> (features, side@full-res)."""
    e = conv3d(x, p["conv"]["w"], p["conv"]["b"], padding=dilation,
               dilation=dilation, space=space)
    e = leaky_relu(instance_norm(e, space=space))
    for g in range(n_gates):
        e = e * torch.sigmoid(conv3d(e, p[f"se{g}"]["w"]))
    if not want_side:
        return e, None
    side = conv3d(e, p["side"]["w"], p["side"]["b"])
    return e, upsample_trilinear(side, up, space=space)


def _cat_block(p: Params, x, space=None):
    return leaky_relu(instance_norm(conv3d(x, p["conv"]["w"]), space=space))


def _check_space(x, cfg: SEUNetConfig, space, x_is_s2d: bool = False) -> None:
    """Raise for what a forward cannot take on the depth slab x of a
    `space` mesh: the conv_stats and conv_epi configurations, whose
    kernels (K8-K11) pad the depth inside the kernel and would count the
    halo's output planes in their fused sums (ROADMAP M9b); or a crop
    depth that is not a multiple of 8 x n_space, or that leaves a slab
    fewer than 2 planes at the 1/4 level (its dil-2 convs' halo)."""
    if space is None:
        return
    if cfg.conv_stats or cfg.conv_epi:
        raise NotImplementedError(
            "SEUNetConfig(conv_stats=True) and (conv_epi=True) take no depth slab of the "
            "`space` axis: their kernels pad the depth inside the kernel and their fused sums "
            "would count the halo's output planes (ROADMAP M9b)")
    n = space.space_size
    depth = x.shape[1] * (2 if x_is_s2d else 1) * n
    if depth % (8 * n) or depth // (4 * n) < 2:
        raise ValueError(f"a crop depth of {depth} does not split over {n} space ranks: it "
                         f"must be a multiple of {8 * n} (8 x n_space), at least 2 planes a "
                         f"slab at the 1/4 level")


def _remat(f, cfg: SEUNetConfig):
    """`f` checkpointed (recomputed in backward) under cfg.remat while
    gradients are taken; `f` itself otherwise."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return f

    def wrapped(*args, **kw):
        return checkpoint(f, *args, use_reentrant=False, **kw)
    return wrapped


def draw_dropout(b: int, cfg: SEUNetConfig, generator: torch.Generator) -> list:
    """DropLayer's two uniform draws for a batch of `b`, (b, 12*side) and
    (b, 6*side), from `generator` on its device."""
    s = cfg.side_channels
    return [torch.rand((b, k * s), generator=generator, device=generator.device)
            for k in (12, 6)]


def _drop_draws(x, cfg: SEUNetConfig, generator, drop_draws):
    """The two DropLayer uniform draws (B, 12*side), (B, 6*side) as
    float32 on x's device: `drop_draws` when given, else from
    `generator`."""
    if drop_draws is None:
        if generator is None:
            raise ValueError("train=True needs a generator or drop_draws for DropLayer")
        drop_draws = draw_dropout(x.shape[0], cfg, generator)
    return [r.to(device=x.device, dtype=torch.float32) for r in drop_draws]


def _drop_scale(r, threshold: float, rows=None):
    """DropLayer's per-(batch, channel) factor from its uniform draws r
    (B, C): mask (r >= threshold) times C / (mask.sum() + 0.01), the sum
    over the whole mask (reference SE_UNet.py:84-97); only the batch rows
    `rows` of it when given."""
    mask = (r >= threshold).to(torch.float32)
    scale = mask * (r.shape[-1] / (mask.sum() + 0.01))
    return scale if rows is None else scale[rows]


def _drop_layer(x, r, threshold: float, rows=None):
    """DropLayer (channel dropout) of NDHWC x with the draws r (B, C)."""
    m = _drop_scale(r, threshold, rows).reshape(x.shape[0], 1, 1, 1, x.shape[-1])
    return x * m.to(x.dtype)


def apply(params: Params, x: torch.Tensor, *, cfg: SEUNetConfig = SEUNetConfig(),
          train: bool = False, generator: torch.Generator | None = None,
          drop_draws=None, drop_rows: slice | None = None, space=None):
    """Forward on NDHWC input (B, D, H, W, in_channels) in the reference
    layout. Returns the raw-logit heads (pred_en, pred_de). `train`
    applies DropLayer with draws from `generator` or `drop_draws`;
    `drop_rows`: x's rows within the batch that `drop_draws` covers.
    `space`: x is this rank's depth slab (`_check_space`), and the heads
    are its slab."""
    _check_space(x, cfg, space)
    p = cast_params(params, cfg.compute_dtype)
    x = x.to(cfg.compute_dtype)
    _sse_block = _remat(globals()["_sse_block"], cfg)
    _cat_block = _remat(globals()["_cat_block"], cfg)

    def cat(*ts):
        return torch.cat(ts, dim=-1)

    e0, s0 = _sse_block(p["ec1"], x, dilation=1, up=1, n_gates=1, space=space)
    e1, s1 = _sse_block(p["ec2"], e0, dilation=1, up=1, n_gates=1, space=space)
    e1_1, s2 = _sse_block(p["ec3"], e1, dilation=2, up=1, n_gates=1, space=space)
    e1 = _cat_block(p["ec33"], cat(e1_1, e0, e1), space) + _cat_block(p["x33"], x, space)
    e2 = max_pool3d(e1)
    x = max_pool3d(x)

    e2, s3 = _sse_block(p["ec4"], e2, dilation=1, up=2, n_gates=2, space=space)
    e3, s4 = _sse_block(p["ec5"], e2, dilation=2, up=2, n_gates=2, space=space)
    e3_1, s5 = _sse_block(p["ec6"], e3, dilation=2, up=2, n_gates=2, space=space)
    e3 = _cat_block(p["ec63"], cat(e3_1, e2, e3), space) + _cat_block(p["x63"], x, space)
    e4 = max_pool3d(e3)
    x = max_pool3d(x)

    e4, s6 = _sse_block(p["ec7"], e4, dilation=1, up=4, n_gates=2, space=space)
    e5, s7 = _sse_block(p["ec8"], e4, dilation=2, up=4, n_gates=2, space=space)
    e5_1, s8 = _sse_block(p["ec9"], e5, dilation=2, up=4, n_gates=2, space=space)
    e5 = _cat_block(p["ec93"], cat(e5_1, e4, e5), space) + _cat_block(p["x93"], x, space)
    e6 = max_pool3d(e5)

    e6, s9 = _sse_block(p["ec10"], e6, dilation=1, up=8, n_gates=2, space=space)
    e7, s10 = _sse_block(p["ec11"], e6, dilation=1, up=8, n_gates=2, space=space)
    e7_1, s11 = _sse_block(p["ec12"], e7, dilation=1, up=8, n_gates=2, space=space)
    e7 = _cat_block(p["ec123"], cat(e7_1, e6, e7), space)

    e8 = upsample_trilinear(e7, 2, space=space)
    d0, s12 = _sse_block(p["dc1"], cat(e8, e5), dilation=1, up=4, n_gates=2, space=space)
    d0_1, s13 = _sse_block(p["dc2"], d0, dilation=1, up=4, n_gates=2, space=space)
    d0 = _cat_block(p["dc22"], cat(d0_1, d0), space)

    d1 = upsample_trilinear(d0, 2, space=space)
    d1, s14 = _sse_block(p["dc3"], cat(d1, e3), dilation=1, up=2, n_gates=2, space=space)
    d1_1, s15 = _sse_block(p["dc4"], d1, dilation=1, up=2, n_gates=2, space=space)
    d1 = _cat_block(p["dc42"], cat(d1_1, d1), space)

    d2 = upsample_trilinear(d1, 2, space=space)
    d2, s16 = _sse_block(p["dc5"], cat(d2, e1), dilation=1, up=1, n_gates=1, space=space)
    _, s17 = _sse_block(p["dc6"], d2, dilation=1, up=1, n_gates=1, space=space)
    # dc62's output feeds nothing in the reference forward

    sides_en = cat(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11)
    sides_de = cat(s12, s13, s14, s15, s16, s17)
    if train:
        r_en, r_de = _drop_draws(x, cfg, generator, drop_draws)
        sides_en = _drop_layer(sides_en, r_en, cfg.drop_threshold, drop_rows)
        sides_de = _drop_layer(sides_de, r_de, cfg.drop_threshold, drop_rows)
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
        if cfg.conv_stats:  # the kernel takes the reference kernel as it is
            fp[name] = {"w": p[name]["conv"]["w"], "b": p[name]["conv"]["b"],
                        "wse": wse(name, gates)}
            continue
        if cfg.conv_epi:  # the dense kernel takes the block-diagonal lift
            fp[name] = {"wdense": dil2_dense_weight(p[name]["conv"]["w"], dt),
                        "bg": p[name]["conv"]["b"].repeat(8), "wse": wse(name, gates)}
            continue
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


def _sse_block_s2d(pre: Params, x, space=None):
    """SSEConv (one gate) on an s2d tensor via the block-lifted dense 3^3
    conv (ec1/ec2), then the gathered epilogue."""
    return gated_norm_block(conv3d(x, pre["w"], pre["b"], padding=1, space=space), pre["wse"],
                            space=space)


def _norm_gates(y, s1, s2, wse):
    """The conv_stats blocks' tail (JAX se_unet.py:577-578, 777-778):
    InstanceNorm from the conv's sums (rounded once), LeakyReLU, then the
    SE gates as x * onehot(sigmoid(x @ kron(I8, w))), each rounded."""
    e = leaky_relu(instance_norm_from_stats(y, s1, s2))
    for w in wse:
        e = se_gate_s2d_pre(e, *se_gate_weights(w[:, None], e.dtype))
    return e


def _sse_block_s2d_dil2(pre: Params, x, conv_stats: bool = False, conv_epi: bool = False,
                        space=None):
    """Dilation-2 SSEConv on an s2d tensor: the 8 sub-grid dil-1 convs as
    one grouped conv (partial-dense lift), then the gathered epilogue; or,
    under `conv_stats`, the fused conv + statistics kernel; or, under
    `conv_epi`, the dense conv + statistics kernel into the gathered
    epilogue (JAX se_unet.py:580-604)."""
    if conv_stats:
        return _norm_gates(*dil2_conv_stats(x, pre["w"], pre["b"]), pre["wse"])
    if conv_epi:
        return dil2_gated_block(x, pre["wdense"], pre["bg"], pre["wse"])
    y = conv3d(x, pre["wgroup"], pre["bg"], padding=1, groups=pre["ng"], space=space)
    return gated_norm_block(y, pre["wse"], space=space)


def _sse_block_s2d_phased(pre: Params, x, conv_stats: bool = False, conv_epi: bool = False,
                          space=None):
    """SSEConv on an s2d tensor (or a list forming a plain concat) via
    the phased conv (under `conv_epi` the ungathered conv kernel), then
    the phased epilogue; or, under `conv_stats`, the fused conv +
    statistics kernel."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    if conv_stats:
        w_all = pre["w_all"]
        y, s1, s2 = phased_conv_stats(xs, w_all.reshape(8, *w_all.shape[3:]), pre["b_all"])
        return _norm_gates(y, s1, s2, pre["wse"])
    return phased_gated_block(xs, pre["w_all"], pre["b_all"], pre["wse"], ext_kernel=conv_epi,
                              space=space)


def _cat_block_s2d(pre: Params, x, space=None):
    """CATConv on an s2d tensor or a list forming a plain concat: the
    interleave permutation is folded into the pointwise weight; gate-free
    gathered epilogue."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    return gated_norm_block(grouped_pointwise_multi_pre(xs, pre["wd"]), None, space=space)


def _composed_head(metas, head_p: Params, interp=None, s2d_out: bool = False,
                   drop=None, space=None):
    """Deep-supervision head without materializing the side outputs:
    conv1x1(DropLayer(cat(upsample(side_i)))) is linear, and
    align_corners interpolation rows sum to 1, so it folds into
        sum_i upsample(feat_i @ (w_side_i @ (m_i * W_head_i))) + bias,
    with the DropLayer factors m (B, C) of `drop` (train mode) entering
    as a per-batch reweighting of the head; without `drop` (eval) the
    weights are batch-independent.

    `metas`: ordered (feat, block_params, kind, scale); kind 's2d' is an
    s2d feature at the output grid, 's2d_up' an s2d feature at a coarser
    grid, 'std' a plain (B, m, m, m, Ci) feature; the last two upsample
    by `scale`. Returns (B, 2n, 2n, 2n, 1) logits, or the s2d
    (B, n, n, n, 8) form when `s2d_out`; with `space`, this rank's depth
    slab of them."""
    f32 = torch.float32
    hw = head_p["w"][0, 0, 0, :, 0].to(f32)
    batch = metas[0][0].shape[0]
    dev = hw.device
    eye8 = torch.eye(8, dtype=f32, device=dev)
    total = None
    per_scale: dict = {}
    bias = torch.zeros(batch, dtype=f32, device=dev) + head_p["b"].to(f32)[0]
    ch = 0
    hw_eff = None if drop is None else drop * hw[None, :]  # (B, C)
    for feat, bp, kind, sc in metas:
        w_side = bp["side"]["w"][0, 0, 0].to(f32)  # (Ci, 2)
        if hw_eff is not None:
            whe = hw_eff[:, ch : ch + 2]  # (B, 2)
            ch += 2
            bias = bias + whe @ bp["side"]["b"].to(f32)
            w_eff = (whe @ w_side.T).to(feat.dtype)  # (B, Ci)
            lead = feat.shape[:-1]
            flat = feat.reshape(batch, -1, feat.shape[-1])
            if kind in ("s2d", "s2d_up"):
                wk = torch.einsum("pq,bc->bpcq", eye8.to(feat.dtype), w_eff)
                contrib = (flat @ wk.reshape(batch, -1, 8)).reshape(*lead, 8).to(f32)
                if kind == "s2d":
                    total = contrib if total is None else total + contrib
                    continue
                contrib = depth_to_space(contrib)
            else:
                contrib = (flat @ w_eff.unsqueeze(-1)).reshape(*lead, 1).to(f32)
            per_scale[sc] = contrib if sc not in per_scale else per_scale[sc] + contrib
            continue
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
        m = acc.shape[2]
        pair = interp.get((m, m * sc)) if interp else None
        up = upsample_to_s2d(acc, sc, pair=pair, space=space)
        total = up if total is None else total + up
    bias = bias.reshape(-1, 1, 1, 1, 1)
    if s2d_out:
        return total + bias
    return depth_to_space(total) + bias


def apply_fast(params: Params, x: torch.Tensor, *,
               cfg: SEUNetConfig = SEUNetConfig(), train: bool = False,
               generator: torch.Generator | None = None, drop_draws=None,
               drop_rows: slice | None = None, fast_params: Params | None = None,
               x_is_s2d: bool = False, heads_s2d: bool = False, space=None):
    """Fast forward; same contract as `apply` (D, H, W divisible by 8).

    `x_is_s2d`: the input is already the s2d entry tensor
    (B, D/2, H/2, W/2, 8*C) with phase-major lanes. `heads_s2d`: return
    both heads in s2d layout (B, D/2, H/2, W/2, 8*n_classes). Neither
    changes values. `fast_params`: `prepare_fast_params(params, cfg)`,
    computed here when None (in the autograd graph, as training needs).
    `train`: DropLayer with draws from `generator` or `drop_draws`;
    `drop_rows`: x's rows within the batch that `drop_draws` covers.
    `space`: x is this rank's depth slab (`_check_space`), and the heads
    are its slab."""
    _check_space(x, cfg, space, x_is_s2d)
    _sse_block_s2d = _remat(globals()["_sse_block_s2d"], cfg)
    modes = dict(conv_stats=cfg.conv_stats, conv_epi=cfg.conv_epi, space=space)
    # the default phased block, and both blocks under conv_epi, are
    # Functions that save their inputs only: checkpointing them would add a
    # forward replay that nothing reads
    _sse_block_s2d_dil2 = partial(globals()["_sse_block_s2d_dil2"], **modes)
    if not cfg.conv_epi:
        _sse_block_s2d_dil2 = _remat(_sse_block_s2d_dil2, cfg)
    _sse_block_s2d_phased = partial(globals()["_sse_block_s2d_phased"], **modes)
    if cfg.conv_stats:
        _sse_block_s2d_phased = _remat(_sse_block_s2d_phased, cfg)
    _cat_block_s2d = _remat(globals()["_cat_block_s2d"], cfg)
    _sse_block = _remat(globals()["_sse_block"], cfg)
    _cat_block = _remat(globals()["_cat_block"], cfg)
    dt = cfg.compute_dtype
    p = cast_params(params, dt)
    x = x.to(dt)
    fp = fast_params if fast_params is not None else prepare_fast_params(params, cfg)
    interp = fp.get("interp", {})

    def cat(*ts):
        return torch.cat(ts, dim=-1)

    # ---- encoder level 1 (s2d at the full-resolution grid) ----
    xs = x if x_is_s2d else space_to_depth(x)
    e0 = _sse_block_s2d(fp["ec1"], xs, space)
    e1 = _sse_block_s2d(fp["ec2"], e0, space)
    e1_1 = _sse_block_s2d_dil2(fp["ec3"], e1)
    f0, f1, f2 = e0, e1, e1_1
    e1 = (_cat_block_s2d(fp["ec33"], [e1_1, e0, e1], space)
          + _cat_block_s2d(fp["x33"], xs, space))
    # ---- encoder level 2 (s2d at the 1/2 grid) ----
    e2s = space_to_depth(max_pool_s2d(e1))
    x2s = space_to_depth(max_pool_s2d(xs))
    e2s = _sse_block_s2d_phased(fp["ec4"], e2s)
    e3s = _sse_block_s2d_dil2(fp["ec5"], e2s)
    e3_1s = _sse_block_s2d_dil2(fp["ec6"], e3s)
    f3, f4, f5 = e2s, e3s, e3_1s
    e3s = (_cat_block_s2d(fp["ec63"], [e3_1s, e2s, e3s], space)
           + _cat_block_s2d(fp["x63"], x2s, space))
    e4 = max_pool_s2d(e3s)
    x3 = max_pool_s2d(x2s)

    # ---- encoder level 3 (1/4) ----
    std = dict(up=1, n_gates=2, want_side=False, space=space)
    e4, _ = _sse_block(p["ec7"], e4, dilation=1, **std)
    e5, _ = _sse_block(p["ec8"], e4, dilation=2, **std)
    e5_1, _ = _sse_block(p["ec9"], e5, dilation=2, **std)
    f6, f7, f8 = e4, e5, e5_1
    e5 = _cat_block(p["ec93"], cat(e5_1, e4, e5), space) + _cat_block(p["x93"], x3, space)
    e6 = max_pool3d(e5)

    # ---- bottleneck (1/8) ----
    e6, _ = _sse_block(p["ec10"], e6, dilation=1, **std)
    e7, _ = _sse_block(p["ec11"], e6, dilation=1, **std)
    e7_1, _ = _sse_block(p["ec12"], e7, dilation=1, **std)
    f9, f10, f11 = e6, e7, e7_1
    e7 = _cat_block(p["ec123"], cat(e7_1, e6, e7), space)

    # ---- decoder level 3 (1/4) ----
    e8 = upsample_trilinear(e7, 2, mat=fp.get("interp_tri"), space=space)
    d0, _ = _sse_block(p["dc1"], cat(e8, e5), dilation=1, **std)
    d0_1, _ = _sse_block(p["dc2"], d0, dilation=1, **std)
    f12, f13 = d0, d0_1
    d0 = _cat_block(p["dc22"], cat(d0_1, d0), space)

    # ---- decoder level 2 (s2d at the 1/2 grid) ----
    m = d0.shape[2]
    d1s = upsample_to_s2d(d0, 2, pair=interp.get((m, 2 * m)), space=space)
    d1s = _sse_block_s2d_phased(fp["dc3"], [d1s, e3s])
    d1_1s = _sse_block_s2d_phased(fp["dc4"], d1s)
    f14, f15 = d1s, d1_1s
    d1s = _cat_block_s2d(fp["dc42"], [d1_1s, d1s], space)

    # ---- decoder level 1 (s2d at the full-resolution grid) ----
    d1f = depth_to_space(d1s)
    m = d1f.shape[2]
    up_s = upsample_to_s2d(d1f, 2, pair=interp.get((m, 2 * m)), space=space)
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
    drop_en = drop_de = None
    if train:
        r_en, r_de = _drop_draws(x, cfg, generator, drop_draws)
        drop_en = _drop_scale(r_en, cfg.drop_threshold, drop_rows)
        drop_de = _drop_scale(r_de, cfg.drop_threshold, drop_rows)
    pred_en = _composed_head(metas_en, p["head_en"], interp=interp, s2d_out=heads_s2d,
                             drop=drop_en, space=space)
    pred_de = _composed_head(metas_de, p["head_de"], interp=interp, s2d_out=heads_s2d,
                             drop=drop_de, space=space)
    return pred_en.to(torch.float32), pred_de.to(torch.float32)

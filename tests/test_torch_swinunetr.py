"""Swin UNETR in the port (`models/swin_unetr.py`, the runner's Swin route)
against the benchmark's plain float32 reference (`portbench/reference/
swinunetr.py`, which imports nothing of the port), on the CPU at small
sizes, seeded weights from the reference's `make_weights`:

  * the whole forward at feature 12, window 4, on a 64^3 input (stages of
    32, 16, 8 and 4 tokens a side: every stage at least the window);
  * one stage's two blocks (unshifted, then shifted) against a brute-force
    attention that finds each token's window, relative position and shift
    region from its own padded, rolled coordinates: 10^3 tokens with window
    4 (padded to 12^3, shift 2) and 9^3 with the published window 7
    (padded to 14^3, shift 3);
  * the patch-merging order;
  * the runner with a `SwinUNETRConfig` (cube 64, step 32, batch 2) against
    the reference's whole-volume scores and trits;
  * `portbench/counts_swinunetr.py`'s operations against
    `FlopCounterMode` on the reference, its attention and K7 bytes against
    the tensors the port hands them;
  * the spans and counters under a profiler session, and none without;
  * `--arch` in `cli.predict` and `cli.test`.

Tolerances: float32 everywhere; the port and the reference order their
sums differently (SDPA against matmul-softmax-matmul, K7's E[x^2] - mean^2
variance against a two-pass one, other conv algorithms), which moves the
logits by about 2e-6 on values up to 3. The bounds below are about 20
times that; a misplaced window, shift, index or merge moves them by more
than 1e-2 (rounding the reference's conv and linear inputs to bfloat16
alone moves them by 1.6e-2).
"""

import itertools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts_swinunetr
from portbench.reference import swinunetr as ref
from se_unet_airseg_tpu_torch.infer.sliding_window import SlidingWindowRunner
from se_unet_airseg_tpu_torch.models import swin_unetr as swin
from se_unet_airseg_tpu_torch.utils import profiling

from test_torch_sliding_window import torch_threads  # noqa: F401

LOGIT_ATOL = 5e-5  # the forward, logits up to about 3
BLOCK_ATOL = 2e-5  # one stage's blocks, activations up to about 5
SCORE_ATOL = 1e-5  # overlap-averaged sigmoid scores
SMALL = dict(feature_size=12, window_size=4)


def _spec_cfg(**kw):
    return ref.Spec(**kw), swin.SwinUNETRConfig(**kw)


@pytest.fixture(scope="module")
def small():
    """Seeded weights, a 64^3 input, and the reference's logits of it with the
    operations `FlopCounterMode` counted while it ran."""
    spec, cfg = _spec_cfg(**SMALL)
    sd = ref.make_weights(2**40 + 17, "cpu", spec)
    x = torch.randn((1, 2, 64, 64, 64), generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as fc:
        want = ref.forward(sd, x, spec)
    return spec, cfg, sd, x, want, fc


def test_weights_are_the_ports_parameters(small):
    spec, cfg, sd = small[:3]
    assert {k: tuple(v.shape) for k, v in sd.items()} == swin.param_shapes(cfg)
    published = swin.param_shapes(swin.SwinUNETRConfig()).values()
    assert sum(math.prod(shape) for shape in published) == 62_188_387


def test_forward_matches_reference(small):
    spec, cfg, sd, x, want, _ = small
    got = swin.apply(sd, x.permute(0, 2, 3, 4, 1), cfg=cfg).permute(0, 4, 1, 2, 3)
    assert got.shape == want.shape == (1, 1, 64, 64, 64)
    assert float((got - want).abs().max()) <= LOGIT_ATOL


def _brute_block(x, sd, pre, heads, window, shift):
    """One Swin block with its attention worked out token by token: the
    padded grid's position q of every key, its rolled coordinate
    r = (q - shift) mod P, window r // w, place r % w and shift region
    (bands [0, P-w), [P-w, P-s), [P-s, P) of r on each axis)."""
    _, d, _, _, c = x.shape
    p = -(-d // window) * window
    y = F.layer_norm(x, (c,), sd[pre + "norm1.weight"], sd[pre + "norm1.bias"], 1e-5)
    y = F.pad(y, (0, 0, 0, p - d, 0, p - d, 0, p - d))[0].reshape(-1, c)
    q3 = torch.stack(torch.meshgrid(*[torch.arange(p)] * 3, indexing="ij"), -1).reshape(-1, 3)
    r = (q3 - shift) % p
    win, loc = r // window, r % window
    if shift:
        band = (r >= p - window).long() + (r >= p - shift).long()
        region = band[:, 0] * 9 + band[:, 1] * 3 + band[:, 2]
    else:
        region = torch.zeros(len(r), dtype=torch.long)
    same = (win[:, None, :] == win[None, :, :]).all(-1)
    rel = loc[:, None, :] - loc[None, :, :] + window - 1
    idx = rel[..., 0] * (2 * window - 1) ** 2 + rel[..., 1] * (2 * window - 1) + rel[..., 2]
    hd = c // heads
    qkv = (y @ sd[pre + "attn.qkv.weight"].T + sd[pre + "attn.qkv.bias"]).view(-1, 3, heads, hd)
    out = torch.empty(len(y), heads, hd)
    table = sd[pre + "attn.relative_position_bias_table"]
    for h in range(heads):
        logits = (qkv[:, 0, h] * hd ** -0.5) @ qkv[:, 1, h].T + table[idx, h]
        logits = logits + torch.where(region[:, None] == region[None, :], 0.0, -100.0)
        logits = logits.masked_fill(~same, float("-inf"))
        out[:, h] = torch.softmax(logits, -1) @ qkv[:, 2, h]
    a = out.reshape(-1, c) @ sd[pre + "attn.proj.weight"].T + sd[pre + "attn.proj.bias"]
    a = a.view(p, p, p, c)[:d, :d, :d][None]
    x = x + a
    y = F.layer_norm(x, (c,), sd[pre + "norm2.weight"], sd[pre + "norm2.bias"], 1e-5)
    y = F.gelu(y @ sd[pre + "mlp.linear1.weight"].T + sd[pre + "mlp.linear1.bias"])
    return x + y @ sd[pre + "mlp.linear2.weight"].T + sd[pre + "mlp.linear2.bias"]


@pytest.mark.parametrize("tokens,window", [(10, 4), (9, 7)])
def test_stage_matches_brute_force_attention(tokens, window):
    spec, cfg = _spec_cfg(feature_size=8, num_heads=(2, 2, 2, 2), window_size=window)
    sd = ref.make_weights(7, "cpu", spec)
    prep = swin.prepare(sd, cfg)
    x = torch.randn((1, tokens, tokens, tokens, 8), generator=torch.Generator().manual_seed(2))
    got = swin._swin_block(swin._swin_block(x, prep, 0, 0), prep, 0, 1)
    want = x
    for j, shift in enumerate((0, window // 2)):
        want = _brute_block(want, sd, f"swinViT.layers1.0.blocks.{j}.", 2, window, shift)
    assert float((got - want).abs().max()) <= BLOCK_ATOL


def test_merge_order_is_the_product_order():
    x = torch.arange(2 * 4 * 6 * 2 * 3, dtype=torch.float32).view(2, 4, 6, 2, 3)
    got = swin.merge_cat(x)
    assert got.shape == (2, 2, 3, 1, 24)
    order = list(itertools.product(range(2), repeat=3))
    assert len(set(order)) == 8
    for b, a0, b0, c0 in itertools.product(range(2), range(2), range(3), range(1)):
        for t, (i, j, k) in enumerate(order):
            assert torch.equal(got[b, a0, b0, c0, 3 * t:3 * t + 3],
                               x[b, 2 * a0 + i, 2 * b0 + j, 2 * c0 + k])


def test_runner_matches_reference_volume():
    spec, cfg = _spec_cfg(**SMALL)
    sd = ref.make_weights(3, "cpu", spec)
    # two overlapping tiles along the last axis, one batch
    vol = (np.random.default_rng(0).integers(-1000, 400, size=(64, 64, 96)) + 1024).astype(np.int16)
    kw = dict(cube=64, step=32, batch=2)
    runner = SlidingWindowRunner(sd, cfg, device="cpu", **kw)
    got = runner.predict_hu(vol, hu_shift=-1024.0)
    want = ref.predict_scores(sd, vol, spec, hu_shift=-1024.0, device="cpu", **kw).numpy()
    assert float(np.abs(got - want).max()) <= SCORE_ATOL
    trits = runner.predict_trits(vol, h_thresh=0.5, l_thresh=0.4, hu_shift=-1024.0)
    want_t = (want >= 0.4).astype(np.uint8) + (want >= 0.5)
    far = (np.abs(want - 0.4) > SCORE_ATOL) & (np.abs(want - 0.5) > SCORE_ATOL)
    assert np.array_equal(trits[far], want_t[far])
    assert runner.fast is False and runner.train_mode is False


def _conf(spec):
    return spec._asdict()


def test_counts_match_flop_counter_and_tensors(small, monkeypatch):
    spec, cfg, sd, x, _, fc = small
    conf, crop = _conf(spec), 64
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    conv = sum(v for k, v in by_op.items() if "convolution" in k)
    assert conv == counts_swinunetr.conv_flops(conf, crop)
    assert fc.get_total_flops() == counts_swinunetr.forward_flops(conf, crop)
    assert (fc.get_total_flops() - conv
            == counts_swinunetr.linear_flops(conf, crop) + counts_swinunetr.attn_flops(conf, crop))

    # bytes: what the port hands the attention and K7 for a tile batch of 2
    calls, k7 = [], []
    sdpa, norm_leaky = F.scaled_dot_product_attention, swin.instance_norm_leaky_ndhwc

    def spy_sdpa(q, k, v, attn_mask):
        calls.append((q.numel(), math.prod(s for s, st in zip(attn_mask.shape,
                                                               attn_mask.stride()) if st)))
        return sdpa(q, k, v, attn_mask=attn_mask)

    def spy_k7(t):
        k7.append(t.numel())
        return norm_leaky(t)

    monkeypatch.setattr(swin.F, "scaled_dot_product_attention", spy_sdpa)
    monkeypatch.setattr(swin, "instance_norm_leaky_ndhwc", spy_k7)
    swin.apply(sd, torch.cat([x, x]).permute(0, 2, 3, 4, 1), cfg=cfg)
    # two tiles a block: q, k, v and the output of each, the bias once
    per_block = [2 * (4 * (a[0] + b[0]) + a[1]) for a, b in zip(calls[0::2], calls[1::2])]
    assert per_block == [int(v) for v in counts_swinunetr.attn_bytes(conf, crop, 2)]
    assert 2 * 2 * sum(k7) == counts_swinunetr.norm_leaky_bytes(conf, crop, 2)
    assert len(k7) == counts_swinunetr.K7_LAUNCHES


def test_spans_and_counters(small):
    spec, cfg, sd = small[:3]
    x = torch.randn((1, 32, 32, 32, 2))
    before = profiling.record()
    swin.apply(sd, x, cfg=cfg)
    assert profiling.record() == before  # no session: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        swin.apply(sd, x, cfg=cfg)
    rec = profiling.record()
    names = [s.name for s in rec.spans]
    assert {n: names.count(n) for n in set(names)} == {
        "swin.stage": 4, "swin.attn": 8, "unetr.block": 10, "unetr.up": 5}
    assert all(s.mirrored for s in rec.spans)
    attn = [s for s in rec.spans if s.name == "swin.attn"]
    assert all(rec.spans[s.parent].name == "swin.stage" for s in attn)
    # stages of 16, 8, 4 and 2 tokens a side, windows of 4 (2 in the last)
    assert rec.counts["swin.tokens"] == 2 * (16 ** 3 + 8 ** 3 + 4 ** 3 + 2 ** 3)
    assert rec.counts["swin.tokens_attended"] == rec.counts["swin.tokens"]
    with profile(activities=[ProfilerActivity.CPU]):
        swin._stage(torch.randn((1, 18, 18, 18, 12)), swin.prepare(sd, cfg), 0)
    # 18 tokens a side, padded to 20 for windows of 4
    assert profiling.record().counts == {"swin.tokens": 2 * 18 ** 3,
                                         "swin.tokens_attended": 2 * 20 ** 3}


@pytest.mark.parametrize("module", ["predict", "test"])
def test_cli_arch_flag(module, tmp_path, capsys):
    import importlib

    main = importlib.import_module(f"se_unet_airseg_tpu_torch.cli.{module}").main
    with pytest.raises(SystemExit):
        main(["--arch", "unet_plus_plus"])
    assert "invalid choice" in capsys.readouterr().err
    if module == "predict":
        spec, _ = _spec_cfg(**SMALL)
        path = tmp_path / "swin.pt"
        torch.save({"state_dict": ref.make_weights(0, "cpu", spec)}, path)
        (tmp_path / "cts").mkdir()
        main(["--arch", "swin_unetr", "--model", str(path), "--ct_dir", str(tmp_path / "cts"),
              "--save_path", str(tmp_path / "out"), "--device", "cpu"])

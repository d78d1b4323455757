"""The port's whole-volume runner against the JAX package's, on both
routes (s2d-folded for even extents, per-tile for odd ones), cube 32,
step 16, batch 2, same weights through the bridge, float32 on CPU.
Averaged probabilities agree to 1e-5; trit fields are equal except
where the averaged probability lies within 1e-5 of a threshold. Also
the host codec against the JAX one."""

import jax
import numpy as np
import pytest
import torch

from se_unet_airseg_tpu.infer import SlidingWindowRunner as JaxRunner
from se_unet_airseg_tpu.infer import sliding_window as jsw
from se_unet_airseg_tpu.models import SEUNetConfig as JaxConfig, init_params
from se_unet_airseg_tpu_torch.data import pad_positions_to_batch, tile_positions
from se_unet_airseg_tpu_torch.infer import SlidingWindowRunner
from se_unet_airseg_tpu_torch.infer import sliding_window as psw
from se_unet_airseg_tpu_torch.models import SEUNet, SEUNetConfig, state_dict_from_jax_params

CUBE, STEP, BATCH = 32, 16, 2


@pytest.fixture(scope="module")
def runners():
    jp = jax.jit(lambda k: init_params(k, JaxConfig()))(jax.random.key(5))
    jp = jax.tree.map(np.asarray, jp)
    model = SEUNet(SEUNetConfig())
    model.load_state_dict(state_dict_from_jax_params(jp))
    kw = dict(cube=CUBE, step=STEP, batch=BATCH)
    return (JaxRunner(jp, JaxConfig(), **kw),
            SlidingWindowRunner(model, SEUNetConfig(), device="cpu", **kw))


@pytest.mark.parametrize("shape,s2d_route", [((48, 40, 32), True), ((33, 32, 34), False)])
def test_runner_matches_jax(shape, s2d_route, runners):
    jr, pr = runners
    vol = (np.random.default_rng(sum(shape)).random(shape) * 1400 - 1000).astype(np.int16)
    pos = pad_positions_to_batch(tile_positions(vol.shape, CUBE, STEP), BATCH)
    assert pr._s2d_io_ok(vol.shape, pos) == s2d_route
    ref = jr.predict_hu(vol, hu_shift=-24.0)
    got = pr.predict_hu(vol, hu_shift=-24.0)
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # thresholds inside the score range, so all three trits occur
    lo, hi = (float(v) for v in np.quantile(ref, [0.3, 0.7]))
    t_ref = jr.predict_trits(vol, h_thresh=hi, l_thresh=lo, hu_shift=-24.0)
    t_got = pr.predict_trits(vol, h_thresh=hi, l_thresh=lo, hu_shift=-24.0)
    assert set(np.unique(t_ref)) == {0, 1, 2}
    near = (np.abs(ref - lo) < 1e-5) | (np.abs(ref - hi) < 1e-5)
    np.testing.assert_array_equal(t_got[~near], t_ref[~near])


def test_undersized_volume_pads_to_one_cube(runners):
    _, pr = runners
    vol = (np.random.default_rng(1).random((32, 32, 20)) * 500).astype(np.float32)
    out = pr.predict_hu(vol)
    assert out.shape == (32, 32, 20) and np.isfinite(out).all()
    # the whole-field packing decodes to the block codec's trits
    packed, padded, orig = pr.predict_trits_device(vol, h_thresh=0.5, l_thresh=0.45)
    assert padded == (32, 32, 32) and tuple(orig) == (32, 32, 20)
    full = psw.unpack_trits(packed.numpy(), 32 ** 3, padded)[:32, :32, :20]
    np.testing.assert_array_equal(full, pr.predict_trits(vol, h_thresh=0.5, l_thresh=0.45))


def test_encoder_head_and_raw_logits(runners):
    """head="encoder", use_sigmoid=False on one tile equals the raw
    pred_en of apply_fast."""
    from se_unet_airseg_tpu_torch.models import se_unet_apply_fast
    from se_unet_airseg_tpu_torch.ops import hu_dual_window

    _, pr = runners
    r = SlidingWindowRunner(pr.params, SEUNetConfig(), cube=CUBE, step=STEP, batch=1,
                            head="encoder", use_sigmoid=False, device="cpu")
    vol = (np.random.default_rng(2).random((CUBE,) * 3) * 1400 - 1000).astype(np.float32)
    got = r.predict_hu(vol)
    with torch.inference_mode():
        x = hu_dual_window(torch.from_numpy(vol))[None]
        want = se_unet_apply_fast(pr.params, x, cfg=SEUNetConfig())[0][0, ..., 0]
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 7, 10240 * 3 + 5])
def test_trit_codec_matches_jax(n):
    r = np.random.default_rng(n)
    # block-constant runs with a few mixed blocks, as in airway fields
    pred = np.repeat(r.choice([0.1, 0.45, 0.9], size=n // 997 + 1), 997)[:n]
    pred = pred + (r.random(n) < 0.01) * 0.4
    pred = pred.astype(np.float32)
    inv = np.ones(n, np.float32)
    args = (0.5, 0.4)
    s_j, c_j, p_j = jsw.SlidingWindowRunner._trit_summary(pred, inv, *args)
    s_p, c_p, p_p = psw.SlidingWindowRunner._trit_summary(
        torch.from_numpy(pred), torch.from_numpy(inv), *args)
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(p_p.numpy(), np.asarray(p_j))
    assert len(c_p) == len(c_j)
    np.testing.assert_array_equal(
        psw.SlidingWindowRunner._trit_pack(torch.from_numpy(pred), torch.from_numpy(inv),
                                           *args).numpy(),
        np.asarray(jsw.SlidingWindowRunner._trit_pack(pred, inv, *args)))
    want = ((pred >= 0.4).astype(np.uint8) + (pred >= 0.5)).astype(np.uint8)
    s = s_p.numpy()
    for frac in (0.0, 1.0):  # whole-payload and per-chunk routes
        got = psw.decode_trit_summary(s, psw.make_chunk_fetcher(s, c_p, p_p, frac=frac),
                                      n, (n,))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(psw.unpack_trits(p_p.numpy(), 10240, (10240,)),
                                  jsw.unpack_trits(np.asarray(p_j), 10240, (10240,)))
    np.testing.assert_array_equal(psw.trits_to_scores(want, 0.5, 0.4),
                                  jsw.trits_to_scores(want, 0.5, 0.4))


@pytest.mark.parametrize("shape,cube,step,batch", [((64, 48, 40), 32, 16, 3),
                                                   ((32, 33, 95), 32, 20, 4)])
def test_tiling_matches_jax(shape, cube, step, batch):
    from se_unet_airseg_tpu.data.tiling import (
        pad_positions_to_batch as jpad,
        tile_positions as jtile,
    )

    np.testing.assert_array_equal(
        pad_positions_to_batch(tile_positions(shape, cube, step), batch),
        jpad(jtile(shape, cube, step), batch))


def test_runner_device_rule():
    if torch.cuda.is_available():
        pytest.skip("the rule under test is the CPU-only host's")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlidingWindowRunner(SEUNet(), SEUNetConfig(), cube=16, step=8)

"""The port's whole-volume runner against the JAX package's, on both
routes (s2d-folded for even extents, per-tile for odd ones), cube 32,
step 16, batch 2, same weights through the bridge, float32 on CPU.
Averaged probabilities agree to 1e-5; trit fields are equal except
where the averaged probability lies within 1e-5 of a threshold. Also
the host codec against the JAX one.

Train mode (DropLayer on, as validation and test run the net): JAX folds
the batch index into its key per tile batch and splits it per head; the
port gets those draws as `drop_draws`, one `[r_en, r_de]` per batch
(`jax_drop_draws`), at the same tolerances."""

import jax
import jax.numpy as jnp
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
SIDES = ((0, 24), (1, 12))  # (head, DropLayer channels): 12 and 6 side maps of 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads for the port's CPU forwards while a module's
    tests run: the tier-1 run puts six workers on the host's cores, and
    oversubscribed threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_drop_draws(rng, n_batches: int, batch: int):
    """The JAX runner's DropLayer uniforms for key `rng`, as the port's
    `drop_draws`: per tile batch i the key fold_in(rng, i), split into
    the two heads' keys, each drawing (batch, C)."""
    out = []
    for i in range(n_batches):
        keys = jax.random.split(jax.random.fold_in(rng, i))
        out.append([torch.from_numpy(np.array(
            jax.random.uniform(keys[h], (batch, 1, 1, 1, c), jnp.float32)).reshape(batch, c))
            for h, c in SIDES])
    return out


def _n_batches(shape, batch=BATCH):
    return len(pad_positions_to_batch(tile_positions(shape, CUBE, STEP), batch)) // batch


@pytest.fixture(scope="module")
def runners():
    jp = jax.jit(lambda k: init_params(k, JaxConfig()))(jax.random.key(5))
    jp = jax.tree.map(np.asarray, jp)
    model = SEUNet(SEUNetConfig())
    model.load_state_dict(state_dict_from_jax_params(jp))
    kw = dict(cube=CUBE, step=STEP, batch=BATCH)
    return (JaxRunner(jp, JaxConfig(), **kw),
            SlidingWindowRunner(model, SEUNetConfig(), device="cpu", **kw))


@pytest.fixture(scope="module")
def train_runners(runners):
    """Train-mode twins of `runners` (same weights, batch 2)."""
    jr, pr = runners
    kw = dict(cube=CUBE, step=STEP, batch=BATCH, train_mode=True)
    return (JaxRunner(jr.params, JaxConfig(), **kw),
            SlidingWindowRunner(pr.params, SEUNetConfig(), device="cpu", **kw))


def _hold_to_jax(jr, pr, vol, jkw: dict, pkw: dict):
    """predict_hu within 1e-5 of JAX; trits equal off-threshold."""
    ref = jr.predict_hu(vol, hu_shift=-24.0, **jkw)
    got = pr.predict_hu(vol, hu_shift=-24.0, **pkw)
    assert got.shape == vol.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # thresholds inside the score range, so all three trits occur
    lo, hi = (float(v) for v in np.quantile(ref, [0.3, 0.7]))
    t_ref = jr.predict_trits(vol, h_thresh=hi, l_thresh=lo, hu_shift=-24.0, **jkw)
    t_got = pr.predict_trits(vol, h_thresh=hi, l_thresh=lo, hu_shift=-24.0, **pkw)
    assert set(np.unique(t_ref)) == {0, 1, 2}
    near = (np.abs(ref - lo) < 1e-5) | (np.abs(ref - hi) < 1e-5)
    np.testing.assert_array_equal(t_got[~near], t_ref[~near])
    return got


@pytest.mark.parametrize("shape,s2d_route", [((48, 40, 32), True), ((33, 32, 34), False)])
def test_runner_matches_jax(shape, s2d_route, runners):
    jr, pr = runners
    vol = (np.random.default_rng(sum(shape)).random(shape) * 1400 - 1000).astype(np.int16)
    pos = pad_positions_to_batch(tile_positions(vol.shape, CUBE, STEP), BATCH)
    assert pr._s2d_io_ok(vol.shape, pos) == s2d_route
    _hold_to_jax(jr, pr, vol, {}, {})


@pytest.mark.parametrize("shape,s2d_route", [((48, 40, 32), True), ((33, 32, 34), False)])
def test_train_mode_runner_matches_jax(shape, s2d_route, runners, train_runners):
    """DropLayer on both routes with the JAX draws injected per batch;
    the draws change the scores (they are not the eval ones)."""
    jr, pr = train_runners
    vol = (np.random.default_rng(sum(shape)).random(shape) * 1400 - 1000).astype(np.int16)
    key = jax.random.key(7)
    draws = jax_drop_draws(key, _n_batches(shape), BATCH)
    assert pr._s2d_io_ok(vol.shape, pad_positions_to_batch(
        tile_positions(shape, CUBE, STEP), BATCH)) == s2d_route
    got = _hold_to_jax(jr, pr, vol, {"rng": key}, {"drop_draws": draws})
    assert np.abs(got - runners[1].predict_hu(vol, hu_shift=-24.0)).max() > 1e-3


def test_reference_layout_route_matches_jax(runners):
    """fast=False (the reference-layout apply, per-tile route) in train
    mode against JAX fast=False, and the port's two routes agree."""
    jr, pr = runners
    shape = (40, 32, 32)
    vol = (np.random.default_rng(4).random(shape) * 1400 - 1000).astype(np.int16)
    key = jax.random.key(8)
    draws = jax_drop_draws(key, _n_batches(shape), BATCH)
    kw = dict(cube=CUBE, step=STEP, batch=BATCH, train_mode=True, fast=False)
    jref = JaxRunner(jr.params, JaxConfig(), **kw)
    pref = SlidingWindowRunner(pr.params, SEUNetConfig(), device="cpu", **kw)
    assert pref.fast_params is None and not pref._s2d_io_ok(shape, np.zeros((1, 3), int))
    ref = jref.predict_hu(vol, rng=key, hu_shift=-24.0)
    got = pref.predict_hu(vol, hu_shift=-24.0, drop_draws=draws)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    fast = SlidingWindowRunner(pr.params, SEUNetConfig(), device="cpu", cube=CUBE, step=STEP,
                               batch=BATCH, train_mode=True)
    np.testing.assert_allclose(fast.predict_hu(vol, hu_shift=-24.0, drop_draws=draws), got,
                               atol=1e-5, rtol=0)


def test_train_mode_draws_from_a_generator_in_turn(runners):
    """A generator is drawn from batch after batch, [r_en, r_de] each:
    the same as passing those draws."""
    _, pr = runners
    r = SlidingWindowRunner(pr.params, SEUNetConfig(), cube=CUBE, step=STEP, batch=1,
                            train_mode=True, device="cpu")
    vol = (np.random.default_rng(3).random((48, 32, 32)) * 1400 - 1000).astype(np.float32)
    g = torch.Generator().manual_seed(11)
    draws = [[torch.rand((1, c), generator=g) for _, c in SIDES] for _ in range(_n_batches(
        vol.shape, 1))]
    got = r.predict_hu(vol, generator=torch.Generator().manual_seed(11))
    np.testing.assert_array_equal(got, r.predict_hu(vol, drop_draws=draws))


def test_eval_mode_ignores_draws_and_train_mode_needs_them(runners):
    _, pr = runners
    vol = (np.random.default_rng(5).random((32, 32, 32)) * 1400 - 1000).astype(np.float32)
    want = pr.predict_hu(vol)
    np.testing.assert_array_equal(
        pr.predict_hu(vol, generator=torch.Generator().manual_seed(1)), want)
    r = SlidingWindowRunner(pr.params, SEUNetConfig(), cube=CUBE, step=STEP, batch=1,
                            train_mode=True, device="cpu")
    with pytest.raises(ValueError, match="generator= or drop_draws="):
        r.predict_hu(vol)
    with pytest.raises(ValueError, match="tile batches"):
        r.predict_trits(vol, drop_draws=[])
    with pytest.raises(NotImplementedError, match="mesh"):
        SlidingWindowRunner(pr.params, SEUNetConfig(), cube=CUBE, step=STEP, mesh=object(),
                            device="cpu")


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

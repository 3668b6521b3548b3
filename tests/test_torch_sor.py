"""SOR in the PyTorch port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in ``gsconverter_tpu_torch``.  The JAX side reaches the
Pallas window kernel in interpret mode, as its own tests run it; the port
side takes the plain PyTorch version of kernel K1, which is what its
wrapper runs on a CPU tensor.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gsconverter_tpu.ops import sor as jsor
from gsconverter_tpu.ops.padding import PAD_POS, pad_rows
from gsconverter_tpu_torch.ops import sor as tsor


def _flyer_scene(n=3000, seed=7):
    """Dense blob plus a far flyer cluster (the last 64 rows)."""
    r = np.random.default_rng(seed)
    return np.concatenate([
        r.normal(0, 1.0, (n - 64, 3)),
        r.normal(0, 1.0, (64, 3)) + 30.0,
    ]).astype(np.float32)


def _sorted_padded(pos, size=4096):
    """JAX's Morton-sorted input, pad rows at PAD_POS (n=3000 -> 4096)."""
    posp = pad_rows(jnp.asarray(pos), size, PAD_POS)
    valid = jnp.arange(size) < pos.shape[0]
    _, spos, svalid = jsor._sor_window_bin(posp, valid)
    return np.array(spos), np.array(svalid)


@pytest.mark.parametrize("k,window,iters", [(25, 512, 10), (23, 256, 7)])
def test_kernel_plain_version_matches_pallas(k, window, iters):
    spos, real = _sorted_padded(_flyer_scene())
    md_j = np.asarray(
        jsor._sor_window_loop_pallas(jnp.asarray(spos), k, window, 512,
                                     iters=iters, interpret=True))
    md_t = tsor._sor_window_loop_kernel(torch.from_numpy(spos), k, window,
                                        iters).numpy()
    rel = np.abs(md_t[real] - md_j[real]) / np.maximum(md_j[real], 1e-12)
    # Measured on this input: p99 1.2e-7 and max 1.2e-7 at both settings
    # (the f32 sums taken in another order).  The max bound leaves room for
    # one bf16 tie flipping a bisection step.
    assert np.quantile(rel, 0.99) <= 1e-4, np.quantile(rel, 0.99)
    assert rel.max() <= 5e-3, rel.max()


def test_kernel_wrapper_checks_its_arguments():
    spos = torch.zeros(1000, 3)
    with pytest.raises(ValueError, match="multiple of 512"):
        tsor._sor_window_loop_kernel(spos, 25, 256, 7)
    with pytest.raises(ValueError, match="window to divide"):
        tsor._sor_window_loop_kernel(torch.zeros(1024, 3), 25, 384, 7)
    with pytest.raises(ValueError, match="float32"):
        tsor._sor_window_loop_kernel(torch.zeros(1024, 3, dtype=torch.float64),
                                     25, 256, 7)
    with pytest.raises(ValueError, match="contiguous"):
        tsor._sor_window_loop_kernel(torch.zeros(3, 1024).T, 25, 256, 7)


def test_morton_key_identity_pass_bit_exact():
    r = np.random.default_rng(3)
    pos = r.normal(0, 2.0, (5000, 3)).astype(np.float32)
    valid = np.arange(5000) < 4900
    kj = np.asarray(jsor._morton_key(jnp.asarray(pos), jnp.asarray(valid),
                                     None, (0.0, 0.0, 0.0))).astype(np.int64)
    kt = tsor._morton_key(torch.from_numpy(pos), torch.from_numpy(valid),
                          None, (0.0, 0.0, 0.0)).numpy()
    np.testing.assert_array_equal(kt, kj)


@pytest.mark.parametrize("pass_idx", [1, 2, 3])
def test_morton_key_rotated_passes_agree(pass_idx):
    r = np.random.default_rng(5)
    pos = r.normal(0, 2.0, (5000, 3)).astype(np.float32)
    valid = np.ones(5000, bool)
    rot, shift = jsor._PASS_ORDERS[pass_idx]
    trot, tshift = tsor._PASS_ORDERS[pass_idx]
    np.testing.assert_array_equal(trot, rot)
    assert tshift == shift
    kj = np.asarray(jsor._morton_key(jnp.asarray(pos), jnp.asarray(valid),
                                     rot, shift)).astype(np.int64)
    kt = tsor._morton_key(torch.from_numpy(pos), torch.from_numpy(valid),
                          trot, tshift).numpy()
    # the 3x3 rotation may round differently in the two matmuls
    assert (kt == kj).mean() >= 0.999


def test_sor_mask_one_pass_identical():
    pos = _flyer_scene()
    k, sigma = tsor.intensity_to_params(4)  # k=23, sigma=14.33: one pass
    mj = np.asarray(jsor.sor_mask(jnp.asarray(pos), k, sigma,
                                  impl="pallas_interpret"))
    mt = tsor.sor_mask(torch.from_numpy(pos), k, sigma).numpy()
    np.testing.assert_array_equal(mt, mj)


def test_sor_mask_two_passes_agree():
    pos = _flyer_scene()
    mj = np.asarray(jsor.sor_mask(jnp.asarray(pos), 25, 2.0,
                                  impl="pallas_interpret"))
    mt = tsor.sor_mask(torch.from_numpy(pos), 25, 2.0).numpy()
    assert (mt == mj).mean() >= 0.999
    assert mt[-64:].mean() < 0.1  # flyers removed
    assert mt[:-64].mean() > 0.9


def test_small_n_window_loop_matches_xla():
    r = np.random.default_rng(11)
    n = 1500
    pos = np.concatenate([r.normal(0, 1.0, (n - 20, 3)),
                          r.normal(0, 20.0, (20, 3))]).astype(np.float32)
    posp = pad_rows(jnp.asarray(pos), 2048, PAD_POS)
    valid = jnp.arange(2048) < n
    _, spos, svalid = jsor._sor_window_bin(posp, valid)
    md_j = np.asarray(jsor._sor_window_loop(spos, svalid, 15, 512, 1024,
                                            approx=False))
    md_t = tsor._sor_window_loop(torch.from_numpy(np.asarray(spos)),
                                 torch.from_numpy(np.asarray(svalid)),
                                 15, 512, 1024).numpy()
    real = np.asarray(svalid)
    np.testing.assert_allclose(md_t[real], md_j[real], rtol=1e-5)


def test_small_n_sor_mask_matches_xla():
    """n <= 2048 takes the exact top-k loop on both sides."""
    r = np.random.default_rng(13)
    pos = np.concatenate([r.normal(0, 1.0, (1980, 3)),
                          r.normal(0, 1.0, (20, 3)) + 40.0]).astype(np.float32)
    mj = np.asarray(jsor.sor_mask(jnp.asarray(pos), 15, 3.0, approx=False))
    mt = tsor.sor_mask(torch.from_numpy(pos), 15, 3.0).numpy()
    np.testing.assert_array_equal(mt, mj)
    assert not mt[-20:].any()


def test_intensity_and_window_over_the_slider():
    for i in np.linspace(1.0, 10.0, 91):
        assert tsor.intensity_to_params(float(i)) == jsor.intensity_to_params(float(i))
    for k in range(1, 61):
        assert tsor.resolve_window(k) == jsor.resolve_window(k)


def test_sor_mask_keeps_callers_device_and_length():
    pos = torch.from_numpy(_flyer_scene(n=2600, seed=1))
    m = tsor.sor_mask(pos, 25, 10.5)
    assert m.dtype == torch.bool and m.shape == (2600,)
    assert m.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="grid"):
        tsor.sor_mask(pos, 25, 10.5, method="grid")

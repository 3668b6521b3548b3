"""K-Means of the PyTorch port against the JAX package, on the CPU.

The plain versions of kernels K2, K3 and K4 (``_lloyd_ref``, ``_assign_ref``,
``_update_ref``) are held against the Pallas kernels in interpret mode, the
port's CPU routes against JAX's XLA routes, and the entry functions
(``kmeans``, ``kmeans_chunked``, ``init_centroids``) against JAX's where the random
init allows: JAX's threefry draws cannot be reproduced, so the chunked
comparison injects JAX's init into the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsconverter_tpu.ops import kmeans as jkm
from gsconverter_tpu.ops.padding import PAD_POS, next_pow2
from gsconverter_tpu_torch.ops import kmeans as km
from tests.torch_port_helpers import jax_chunk_init, jax_one_device  # noqa: F401


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _data(n, d, k, seed):
    r = np.random.default_rng(seed)
    return (r.normal(0, 1, (n, d)).astype(np.float32),
            r.normal(0, 1, (k, d)).astype(np.float32))


def _port_lloyd(x, c, nv, precision):
    s, n, l = km._lloyd_ref(_t(x)[None], _t(c)[None],
                            torch.tensor([nv], dtype=torch.int32), precision)
    return s[0].numpy(), n[0].numpy(), l[0].numpy()


@pytest.mark.parametrize("n,d,k,nv", [(900, 24, 130, 850), (600, 1, 256, 580),
                                      (700, 45, 70, 650)])
def test_lloyd_plain_matches_pallas_f32(n, d, k, nv):
    x, c = _data(n, d, k, seed=7 + d)
    s1, n1, l1 = jkm.lloyd_step(jnp.asarray(x), jnp.asarray(c), k,
                                n_valid=jnp.int32(nv), impl="pallas_interpret",
                                precision="f32")
    s2, n2, l2 = _port_lloyd(x, c, nv, "f32")
    np.testing.assert_array_equal(np.asarray(l1)[:nv], l2[:nv])
    np.testing.assert_array_equal(np.asarray(n1), n2)
    np.testing.assert_allclose(s2, np.asarray(s1), rtol=1e-5, atol=1e-4)


def test_lloyd_plain_matches_pallas_bf16():
    x, c = _data(2000, 9, 64, seed=8)
    c = x[np.random.default_rng(8).choice(2000, 64, replace=False)]
    _, _, lj = jkm.lloyd_step(jnp.asarray(x), jnp.asarray(c), 64,
                              impl="pallas_interpret", precision="bf16")
    s, n, lp = _port_lloyd(x, c, 2000, "bf16")
    agree = float((np.asarray(lj) == lp).mean())
    assert agree >= 0.995, agree
    # the sums are sums of the bf16-rounded rows
    xb = km._bf16(_t(x)).numpy()
    np.testing.assert_allclose(s[5], xb[lp == 5].sum(0), rtol=1e-5, atol=1e-4)
    assert n.sum() == 2000


def _chunks(p, d, k, seed):
    """Two chunks of p rows and centroids drawn from each chunk's rows."""
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (2, p, d)).astype(np.float32)
    c = np.stack([x[i, r.choice(p, k, replace=False)] for i in range(2)])
    return x, c


@pytest.mark.parametrize("precision,d,k,nv", [
    ("f32", 24, 130, (900, 850)), ("f32", 45, 61, (700, 0)),
    ("bf16", 24, 130, (900, 850)), ("bf16", 45, 61, (700, 0))])
def test_lloyd_ordered_plain_matches_pallas(precision, d, k, nv):
    """K2's function in K4's summation order against the Pallas Lloyd step
    in interpret mode, chunk by chunk: a partial chunk, an empty one
    (n_valid = 0), k not a multiple of 8, D = 24 and 45."""
    p = nv[0]
    x, c = _chunks(p, d, k, seed=d + k)
    s, n, lab = km._lloyd_ordered_ref(_t(x), _t(c), torch.tensor(nv, dtype=torch.int32),
                                      precision)
    s, n, lab = s.numpy(), n.numpy(), lab.numpy()
    for i, nvi in enumerate(nv):
        sj, nj, lj = (np.asarray(a) for a in jkm.lloyd_step(
            jnp.asarray(x[i]), jnp.asarray(c[i]), k, n_valid=jnp.int32(nvi),
            impl="pallas_interpret", precision=precision))
        assert n[i].sum() == nvi
        if precision == "f32":
            np.testing.assert_array_equal(lj[:nvi], lab[i, :nvi])
            np.testing.assert_array_equal(nj, n[i])
            np.testing.assert_allclose(s[i], sj, rtol=1e-5, atol=1e-4)
        else:
            if nvi:
                agree = float((lj[:nvi] == lab[i, :nvi]).mean())
                assert agree >= 0.995, agree
            # the sums are sums of the bf16-rounded rows of each label
            xb = km._bf16(_t(x[i, :nvi])).numpy().astype(np.float64)
            want = np.zeros((k, d))
            np.add.at(want, lab[i, :nvi], xb)
            np.testing.assert_allclose(s[i], want, rtol=1e-5, atol=1e-4)
            np.testing.assert_array_equal(n[i], np.bincount(lab[i, :nvi], minlength=k))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_lloyd_ordered_sums_are_k4_order_bit_for_bit(precision):
    x, c = _chunks(600, 24, 40, seed=21)
    nv = np.array([600, 333], np.int32)
    s, n, lab = km._lloyd_ordered_ref(_t(x), _t(c), _t(nv), precision)
    # K4's segments by hand: chunk * k + label below n_valid, -1 above it
    seg = lab.numpy() + 40 * np.arange(2, dtype=np.int32)[:, None]
    seg[np.arange(600)[None, :] >= nv[:, None]] = -1
    xs = km._bf16(_t(x)) if precision == "bf16" else _t(x)
    so, no = km._update_ordered_ref(xs.reshape(-1, 24), _t(seg.reshape(-1)), 80)
    assert torch.equal(s.reshape(80, 24), so) and torch.equal(n.reshape(80), no)
    # the labels are the plain version's
    assert torch.equal(lab, km._lloyd_ref(_t(x), _t(c), _t(nv), precision)[2])


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_lloyd_step_cpu_route_matches_xla(precision):
    # the CPU route is f32 whatever the precision, as JAX's
    x, c = _data(900, 24, 130, seed=3)
    s1, n1, l1 = jkm.lloyd_step(jnp.asarray(x), jnp.asarray(c), 130,
                                n_valid=jnp.int32(850), impl="xla")
    s2, n2, l2 = km.lloyd_step(_t(x), _t(c), 130, n_valid=850, precision=precision)
    np.testing.assert_array_equal(np.asarray(l1), l2.numpy())
    np.testing.assert_array_equal(np.asarray(n1), n2.numpy())
    np.testing.assert_allclose(s2.numpy(), np.asarray(s1), rtol=1e-5, atol=1e-4)


def test_assign_plain_matches_pallas_ties_to_lowest():
    x, c = _data(1200, 24, 600, seed=11)
    # duplicate centroids in other 256-wide tiles: exact ties
    c[300] = c[5]
    c[550] = c[260]
    x[:40] = c[5] + np.float32(1e-3) * x[:40]
    x[40:80] = c[260] + np.float32(1e-3) * x[40:80]
    lj = np.asarray(jkm.assign(jnp.asarray(x), jnp.asarray(c), impl="pallas_interpret"))
    lp = km._assign_ref(_t(x), _t(c)).numpy()
    np.testing.assert_array_equal(lp, lj)
    assert (lp[:40] == 5).all() and (lp[40:80] == 260).all()
    np.testing.assert_array_equal(km.assign(_t(x), _t(c)).numpy(), lj)


def _split_case(kind, d, seed):
    """x [200, d] and centroids [150, d] of one kind: N(0, 1); a u8 grid
    (SOG's dequantized values); magnitudes from 1e-30 to 1e15, by row and
    by element; rows that equal centroids."""
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (200, d)).astype(np.float32)
    c = r.normal(0, 1, (150, d)).astype(np.float32)
    if kind == "grid":
        step, mn = np.float32(0.0123), np.float32(-1.57)
        x = (mn + step * r.integers(0, 256, (200, d))).astype(np.float32)
        c = x[r.choice(200, 150, replace=False)].copy()
    elif kind == "magnitudes":
        x[:100] *= (10.0 ** r.uniform(-30, 15, (100, 1))).astype(np.float32)
        x[100:] *= (10.0 ** r.uniform(-30, 15, (100, d))).astype(np.float32)
        c *= (10.0 ** r.uniform(-30, 15, (150, 1))).astype(np.float32)
    elif kind == "on_centroids":
        x[::2] = c[r.choice(150, 100)]
    return x, c


@pytest.mark.parametrize("d", [3, 24, 45, 128])
@pytest.mark.parametrize("kind", ["normal", "grid", "magnitudes", "on_centroids"])
def test_split_product_is_within_its_bound(kind, d):
    """K3's split product, with the exact f64 sum and with a sequential f32
    sum of its 3D terms, stays within E / 2 of the FMA chain for every
    (row, centroid) pair, so E bounds each distance; and the route's
    labels are the chain's."""
    x, c = (_t(a) for a in _split_case(kind, d, seed=d))
    chain = km._chain(x, c).to(torch.float64)
    xn, cmax = km._split_norms(x, c)
    half = km._split_bound(xn, cmax, d)[:, None] / 2
    split = km._split_product(x, c)
    assert bool((split - chain).abs().le(half).all())
    # one rounding to f32 after each term, in column order
    (xh, xl), (ch, cl) = km._split_bf16(x), km._split_bf16(c)
    terms = [(xh, ch), (xh, cl), (xl, ch)]
    acc = torch.zeros(x.shape[0], c.shape[0], dtype=torch.float64)
    for a, b in terms:
        for i in range(d):
            prod = a[:, i, None].double() * b[None, :, i].double()
            acc = (acc + prod).to(torch.float32).to(torch.float64)
    assert bool((acc - chain).abs().le(half).all())
    lab, listed = km._assign_split_ref(x, c)
    assert torch.equal(lab, km._assign_ref(x, c))
    assert 0 <= listed <= x.shape[0]


def test_assign_split_route_matches_pallas_ties_to_lowest():
    """The split route on the tie inputs of
    ``test_assign_plain_matches_pallas_ties_to_lowest``: its labels are the
    plain version's and the Pallas kernel's, and every row on a duplicated
    centroid is re-checked."""
    x, c = _data(1200, 24, 600, seed=11)
    c[300] = c[5]
    c[550] = c[260]
    x[:40] = c[5] + np.float32(1e-3) * x[:40]
    x[40:80] = c[260] + np.float32(1e-3) * x[40:80]
    lj = np.asarray(jkm.assign(jnp.asarray(x), jnp.asarray(c), impl="pallas_interpret"))
    lab, listed = km._assign_split_ref(_t(x), _t(c))
    np.testing.assert_array_equal(lab.numpy(), lj)
    np.testing.assert_array_equal(lab.numpy(), km._assign_ref(_t(x), _t(c)).numpy())
    assert 80 <= listed < 1200


def test_update_plain_matches_pallas():
    r = np.random.default_rng(12)
    k = 40
    x = r.normal(0, 1, (1000, 9)).astype(np.float32)
    lab = r.integers(0, k, 1000).astype(np.int32)
    lab[lab == 17] = 3  # cluster 17 is empty and keeps prev
    lab[:25] = -1
    lab[25:50] = k
    valid = np.arange(1000) < 950
    prev = r.normal(0, 1, (k, 9)).astype(np.float32)
    cj, nj = jkm.update(jnp.asarray(x), jnp.asarray(lab), k, jnp.asarray(prev),
                        valid=jnp.asarray(valid), impl="pallas_interpret")
    cp, npt = km.update(_t(x), _t(lab), k, _t(prev), valid=_t(valid))
    np.testing.assert_array_equal(npt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cp.numpy()[17], prev[17])
    labm = torch.where(_t(valid), _t(lab), k)
    s, cnt = km._update_ref(_t(x), labm, k)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(km._centroid_means(s, cnt, _t(prev)).numpy(),
                               np.asarray(cj), rtol=1e-5, atol=1e-5)


def _update_case(n, d, k, case, seed):
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (n, d)).astype(np.float32)
    if case == "zero":
        return x, np.zeros(n, np.int32)
    lab = r.integers(0, k, n).astype(np.int32)
    if case == "out_of_range":
        lab[r.random(n) < 0.05] = -1
        lab[r.random(n) < 0.05] = k
    return x, lab


@pytest.mark.parametrize("n,d,k,case", [(1000, 9, 40, "out_of_range"), (3000, 3, 1, "uniform"),
                                        (2000, 24, 37, "zero"), (700, 40, 300, "uniform")])
def test_update_ordered_plain_matches_pallas(n, d, k, case):
    """K4's summation order against the Pallas update kernel in interpret
    mode: labels -1 and k dropped, one cluster of 8 pieces, wide rows."""
    x, lab = _update_case(n, d, k, case, seed=n + d)
    sj, nj = jkm._update_sums_pallas(jnp.asarray(x), jnp.asarray(lab), k, interpret=True)
    sp, npt = km._update_ordered_ref(_t(x), _t(lab), k)
    np.testing.assert_array_equal(npt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-5)


def test_update_ordered_plain_pins_the_piece_order():
    """1e8, 300 ones, -1e8 in cluster 0, rows of cluster 1 between them:
    the cut after 256 rows of cluster 0 keeps 45 of the ones, which one
    left-to-right sum loses entirely."""
    vals = [1e8] + [1.0] * 300 + [-1e8]
    x, lab = [], []
    for i, v in enumerate(vals):
        x.append(v)
        lab.append(0)
        if i % 7 == 0:
            x.append(0.5)
            lab.append(1)
    x = np.array(x, np.float32)[:, None]
    lab = np.array(lab, np.int32)
    sums, counts = km._update_ordered_ref(_t(x), _t(lab), 2)

    def seq(values):
        acc = np.float32(0)
        for v in values:
            acc = np.float32(acc + np.float32(v))
        return acc

    first, rest = vals[:km.UPDATE_PIECE], vals[km.UPDATE_PIECE:]
    by_hand = seq([seq(first), seq(rest)])
    assert by_hand == np.float32(48.0)
    assert sums[0, 0].numpy() == by_hand
    assert seq(vals) != by_hand
    assert sums[1, 0].numpy() == seq([0.5] * int(counts[1]))
    np.testing.assert_array_equal(counts.numpy(), [len(vals), (lab == 1).sum()])


def test_kmeans_recovers_clusters():
    r = np.random.default_rng(2)
    centers = np.array([[0, 0], [10, 0], [0, 10], [10, 10]], np.float32)
    x = np.concatenate([r.normal(0, 0.3, (250, 2)).astype(np.float32) + c
                        for c in centers])
    c, labels = km.kmeans(x, 4, max_iter=10, seed=0, device="cpu")
    for t in centers:
        assert np.min(np.linalg.norm(c.numpy() - t, axis=1)) < 0.3
    assert len(np.unique(labels.numpy())) == 4


def test_kmeans_k_ge_n_and_1d():
    x = np.random.default_rng(0).normal(0, 1, (10, 2)).astype(np.float32)
    c, l = km.kmeans(x, 20, device="cpu")
    np.testing.assert_array_equal(c.numpy(), x)
    np.testing.assert_array_equal(l.numpy(), np.arange(10))
    # the scalar-codebook shape: D = 1, K = 256
    v = np.random.default_rng(3).normal(-4, 1, 5000).astype(np.float32)
    c, labels = km.kmeans(v, 256, max_iter=10, device="cpu")
    assert c.shape == (256, 1)
    assert np.mean(np.abs(c.numpy()[labels.numpy(), 0] - v)) < 0.05


def test_kmeans_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        km.kmeans(np.zeros((10, 2), np.float32), 4)


def test_kmeans_chunked_matches_jax_with_its_init(monkeypatch, jax_one_device):
    r = np.random.default_rng(5)
    n, chunks, k = 3000, 4, 32
    # continuous data: on a coarse grid, exact distance ties make the two
    # packages' f32 rounding pick different winners
    x = r.normal(0, 1, (n, 9)).astype(np.float32)
    cj, lj = jkm.kmeans_chunked(x, num_chunks=chunks, k_per_chunk=k, max_iter=8,
                                seed=100)
    monkeypatch.setattr(km, "init_centroids", jax_chunk_init(100))
    cp, lp = km.kmeans_chunked(x, chunks, k, max_iter=8, seed=100, device="cpu")
    cj, lj, cp, lp = np.asarray(cj), np.asarray(lj), cp.numpy(), lp.numpy()
    assert cp.shape == (chunks * k, 9) and lp.shape == (n,)
    assert (lj == lp).mean() >= 0.999
    same = np.array([np.array_equal(lj == j, lp == j) for j in range(chunks * k)])
    assert same.mean() > 0.9
    np.testing.assert_allclose(cp[same], cj[same], rtol=1e-4, atol=1e-4)
    # each label lands in its own chunk's palette slice
    chunk = next_pow2(-(-n // chunks), floor=256)
    np.testing.assert_array_equal(lp // k, np.arange(n) // chunk)


def test_kmeans_chunked_trailing_padding_chunks():
    # 1,100 rows over 4 chunks of 512: chunks 2 and 3 are padding only
    x = np.random.default_rng(6).normal(0, 1, (1100, 3)).astype(np.float32)
    c, labels = km.kmeans_chunked(x, 4, 16, max_iter=3, seed=1, device="cpu")
    c = c.numpy()
    assert np.isfinite(c).all()
    assert (c[48:] == np.float32(PAD_POS)).all()
    assert (np.abs(c[:32]) < 10).all()
    assert labels.numpy().max() < 48


def test_init_centroids_seed_rows_and_slots():
    r = np.random.default_rng(9)
    x = torch.from_numpy(r.normal(0, 1, (2, 2048, 4)).astype(np.float32) + 5)
    valid = torch.ones(2, 2048, dtype=torch.bool)
    a = km.init_centroids(x, 260, 3, valid=valid)
    np.testing.assert_array_equal(a.numpy(), km.init_centroids(x, 260, 3, valid=valid).numpy())
    assert not torch.equal(a, km.init_centroids(x, 260, 4, valid=valid))
    assert not torch.equal(a[0], a[1])  # chunks draw from their own streams
    for i in range(2):
        # slot 0 is row 0; with k = 260 (m = 2, 130 rounds) the last round
        # lands at min(1 + 129 * 2, 258) = 258, so every slot holds a row
        assert torch.equal(a[i, 0], x[i, 0])
        rows = {tuple(v) for v in x[i].numpy()}
        assert all(tuple(v) in rows for v in a[i].numpy())
    # m = 1: round r fills slot r + 1, so no slot repeats the one before
    b = km.init_centroids(x[0], 64, 3)
    assert b.shape == (64, 4)
    assert all(not torch.equal(b[j], b[j + 1]) for j in range(63))


def test_init_centroids_skips_padding_and_keeps_padding_chunks_finite():
    r = np.random.default_rng(10)
    x = np.full((2, 1024, 3), PAD_POS, np.float32)
    x[0, :300] = r.normal(0, 1, (300, 3))
    valid = torch.zeros(2, 1024, dtype=torch.bool)
    valid[0, :300] = True
    c = km.init_centroids(torch.from_numpy(x), 64, 0, valid=valid).numpy()
    assert (np.abs(c[0]) < 100).all()  # no pad row while valid rows have d2 > 0
    assert (c[1] == np.float32(PAD_POS)).all() and np.isfinite(c[1]).all()

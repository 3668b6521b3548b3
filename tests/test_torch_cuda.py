"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card and skips without one.  The compositing
kernels K5/K6 (``csrc/composite.cu``) are held against their plain versions
with per-tile exit (``render/rasterizer.py``).  The module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; there, skip the JAX-importing ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gsconverter_tpu_torch import convert
from gsconverter_tpu_torch.cloud import SplatCloud
from gsconverter_tpu_torch.formats import get_handler
from gsconverter_tpu_torch.ops import kmeans as km
from gsconverter_tpu_torch.ops import sor
from gsconverter_tpu_torch.ops.padding import PAD_POS, pad_rows
from gsconverter_tpu_torch.render import rasterizer as rz
from torch_port_helpers import clamp_edge_windows  # tests/ is on the path

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels K1-K6 (csrc/*.cu) have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flyer_scene(n=3000, seed=7):
    """Dense blob plus a far flyer cluster (the last 64 rows)."""
    r = np.random.default_rng(seed)
    return np.concatenate([r.normal(0, 1.0, (n - 64, 3)),
                           r.normal(0, 1.0, (64, 3)) + 30.0]).astype(np.float32)


def _sorted_padded(pos, device, size=4096):
    """The first pass's Morton-sorted input, pad rows at PAD_POS."""
    posp = pad_rows(torch.from_numpy(pos).to(device), size, PAD_POS)
    valid = torch.arange(size, device=device) < pos.shape[0]
    key = sor._morton_key(posp, valid, None, (0.0, 0.0, 0.0))
    return posp[torch.sort(key, stable=True).indices].contiguous()


def _kernel_and_plain(spos, k, window, iters):
    """K1 on the card (one launch counted) and its plain version."""
    launches = sor.KERNEL_LAUNCHES
    md_k = sor._sor_window_loop_kernel(spos, k, window, iters)
    torch.cuda.synchronize()
    assert sor.KERNEL_LAUNCHES == launches + 1
    return md_k, sor._sor_window_loop_ref(spos, k, window, iters)


# every specialisation of the kernel (window 128, 256, 512) and its generic
# instantiation (any window up to 64, here 64 and 16)
@pytest.mark.parametrize("k,window,iters", [(25, 512, 10), (23, 256, 7), (50, 128, 7),
                                            (25, 64, 7), (7, 16, 5)])
def test_kernel_matches_plain_version(card, k, window, iters):
    spos = _sorted_padded(_flyer_scene(), card)
    md_k, md_p = _kernel_and_plain(spos, k, window, iters)
    real = spos[:, 0] < sor._D_VALID_MAX
    assert int(real.sum()) == 3000
    rel = ((md_k - md_p).abs() / md_p.clamp_min(1e-12))[real]
    # identical distances and bisection steps; only the f32 sums may be
    # taken in another order
    assert float(rel.max()) <= 1e-5, float(rel.max())
    assert bool(torch.isfinite(md_k[real]).all())


@pytest.mark.parametrize("window", [256, 64])
def test_kernel_with_fewer_than_k_candidates(card, window):
    """20 real rows in a block of 1024: every real row has 19 valid
    candidates, fewer than k, and takes the fill at the largest distance;
    pad rows have none and write 0."""
    pos = np.random.default_rng(11).normal(0, 1.0, (20, 3)).astype(np.float32)
    spos = _sorted_padded(pos, card, size=1024)
    md_k, md_p = _kernel_and_plain(spos, 23, window, 7)
    real = spos[:, 0] < sor._D_VALID_MAX
    assert int(real.sum()) == 20
    assert bool(torch.isfinite(md_k).all())
    rel = ((md_k - md_p).abs() / md_p.clamp_min(1e-12))[real]
    assert float(rel.max()) <= 1e-5, float(rel.max())
    # no sum on a pad row: bit for bit
    assert torch.equal(md_k[~real], md_p[~real])
    assert bool((md_k[~real] == 0).all())


@pytest.mark.parametrize("window", [512, 256, 128, 64])
def test_kernel_with_duplicate_points(card, window):
    """300 distinct points, each repeated ten times and a few repeated
    within 1e-7: those pairs are at d <= 1e-6 and are no neighbours."""
    r = np.random.default_rng(12)
    base = r.normal(0, 1.0, (300, 3)).astype(np.float32)
    pos = np.repeat(base, 10, axis=0)
    pos[::7] += np.float32(1e-7)
    spos = _sorted_padded(pos, card)
    md_k, md_p = _kernel_and_plain(spos, 25, window, 7)
    real = spos[:, 0] < sor._D_VALID_MAX
    assert bool(torch.isfinite(md_k[real]).all())
    rel = ((md_k - md_p).abs() / md_p.clamp_min(1e-12))[real]
    assert float(rel.max()) <= 1e-5, float(rel.max())


@pytest.mark.parametrize("window,iters", [(256, 0), (64, 0), (512, 7), (16, 3)])
def test_kernel_at_k1(card, window, iters):
    """k = 1: count(d <= lo) < 1 keeps lo's sum empty, so md is 0.5 (lo +
    hi) with no sum taken at all, and must be equal bit for bit."""
    spos = _sorted_padded(_flyer_scene(), card)
    md_k, md_p = _kernel_and_plain(spos, 1, window, iters)
    real = spos[:, 0] < sor._D_VALID_MAX
    assert bool(torch.isfinite(md_k[real]).all())
    assert torch.equal(md_k, md_p)


def test_kernel_rejects_what_it_does_not_take(card):
    with pytest.raises(ValueError, match="contiguous"):
        sor._sor_window_loop_kernel(torch.zeros(3, 1024, device=card).T, 25, 256, 7)
    with pytest.raises(ValueError, match="multiple of 512"):
        sor._sor_window_loop_kernel(torch.zeros(1000, 3, device=card), 25, 256, 7)


@pytest.mark.parametrize("k,sigma,flyers_go", [(23, 14.33, False), (25, 2.0, True)])
def test_sor_mask_on_card_matches_cpu(card, k, sigma, flyers_go):
    pos = _flyer_scene()
    launches = sor.KERNEL_LAUNCHES
    m_gpu = sor.sor_mask(torch.from_numpy(pos).to(card), k, sigma)
    assert sor.KERNEL_LAUNCHES > launches
    m_cpu = sor.sor_mask(torch.from_numpy(pos), k, sigma)
    assert m_gpu.device.type == "cuda"
    assert float((m_gpu.cpu() == m_cpu).float().mean()) >= 0.999
    # the flyer cluster is 64 points strong: only the tight sigma drops it
    assert (float(m_gpu[-64:].float().mean()) < 0.1) == flyers_go


def test_convert_on_card_matches_cpu(card, tmp_path):
    r = np.random.default_rng(3)
    n = 6000
    pos = np.concatenate([r.normal(0, 1.2, (n - 40, 3)),
                          r.uniform(-40.0, 40.0, (40, 3))]).astype(np.float32)
    quat = r.normal(0, 1, (n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    cloud = SplatCloud(
        pos=pos, sh_dc=r.normal(0, 0.5, (n, 3)).astype(np.float32),
        sh_rest=np.zeros((n, 3, 15), np.float32),
        opacity=r.normal(1, 2, (n,)).astype(np.float32),
        log_scale=r.normal(-4, 0.5, (n, 3)).astype(np.float32),
        quat=quat, normal=np.zeros((n, 3), np.float32), active_sh_degree=0)
    src = str(tmp_path / "scene.ply")
    get_handler("3dgs").write(cloud, src)
    out = {}
    for dev in ("cuda", "cpu"):
        path = str(tmp_path / f"{dev}.splat")
        launches = sor.KERNEL_LAUNCHES
        kept = convert(src, path, "splat", device=dev, min_opacity=5,
                       sor_intensity=10).n
        out[dev] = (kept, open(path, "rb").read(), sor.KERNEL_LAUNCHES - launches)
    assert out["cuda"][2] == 1 and out["cpu"][2] == 0
    assert out["cuda"][0] < n - 30  # the scattered flyers are gone
    assert out["cuda"][:2] == out["cpu"][:2]


def test_convert_batch_on_card_launches_k1_once(card, tmp_path):
    """One K1 launch for a scene however many formats; every file
    byte-identical to a standalone conversion on the card."""
    from gsconverter_tpu_torch.batch import convert_batch

    r = np.random.default_rng(4)
    n = 6000
    pos = np.concatenate([r.normal(0, 1.2, (n - 40, 3)),
                          r.uniform(-40.0, 40.0, (40, 3))]).astype(np.float32)
    quat = r.normal(0, 1, (n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    rest = np.zeros((n, 3, 15), np.float32)
    rest[:, :, :8] = r.normal(0, 0.1, (n, 3, 8))
    cloud = SplatCloud(
        pos=pos, sh_dc=r.normal(0, 0.5, (n, 3)).astype(np.float32), sh_rest=rest,
        opacity=r.normal(1, 2, (n,)).astype(np.float32),
        log_scale=r.normal(-4, 0.5, (n, 3)).astype(np.float32),
        quat=quat, normal=np.zeros((n, 3), np.float32), active_sh_degree=2)
    src = str(tmp_path / "scene.ply")
    get_handler("3dgs").write(cloud, src)
    fmts = ["3dgs", "splat", "ksplat", "spz", "compressed_ply"]
    kw = dict(min_opacity=5, sor_intensity=10, compression_level=1)
    launches = sor.KERNEL_LAUNCHES
    done = convert_batch(src, str(tmp_path / "b"), fmts, device="cuda", **kw)
    assert sor.KERNEL_LAUNCHES == launches + 1
    assert sorted(d[1] for d in done) == sorted(fmts)
    for _, fmt, out in done:
        solo = str(tmp_path / f"solo_{fmt}{get_handler(fmt).extension}")
        launches = sor.KERNEL_LAUNCHES
        convert(src, solo, fmt, device="cuda", **kw)
        assert sor.KERNEL_LAUNCHES == launches + 1
        assert open(solo, "rb").read() == open(out, "rb").read(), fmt


# ------------------------------------------------------------ K2, K3, K4


def _kmeans_inputs(card, chunks=3, p=4096, d=24, k=130, seed=0, grid=True):
    """Chunked rows (u8-grid values, as SOG's, so exact ties occur), their
    centroids drawn from the rows, and n_valid with a partial and an empty
    chunk."""
    r = np.random.default_rng(seed)
    x = r.integers(0, 40, (chunks, p, d)).astype(np.float32) * np.float32(0.01)
    if not grid:
        x = r.normal(0, 1, (chunks, p, d)).astype(np.float32)
    c = np.stack([x[i, r.choice(p // 2, k, replace=False)] for i in range(chunks)])
    nv = np.array([p, p // 2 + 7, 0][:chunks], np.int32)
    return (torch.from_numpy(x).to(card), torch.from_numpy(c).to(card),
            torch.from_numpy(nv).to(card))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("k,d", [(130, 24), (1024, 24), (64, 24), (130, 45)])
def test_lloyd_kernel_matches_plain_version(card, precision, k, d):
    x, c, nv = _kmeans_inputs(card, k=k, d=d)
    launches = dict(km.LAUNCHES)
    s1, n1, l1 = km._lloyd_kernel(x, c, nv, precision)
    torch.cuda.synchronize()
    # the labels kernel, then K4 as the sum stage
    assert km.LAUNCHES["lloyd"] == launches["lloyd"] + 1
    assert km.LAUNCHES["update"] == launches["update"] + 1
    s2, n2, l2 = km._lloyd_ref(x, c, nv, precision)
    real = torch.arange(x.shape[1], device=card)[None, :] < nv[:, None]
    # the plain version forms every distance as the kernel does
    assert float((l1 == l2)[real].float().mean()) == 1.0
    assert torch.equal(n1, n2)
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=1e-4)
    # K4's summation order, bit for bit
    so, no, _ = km._lloyd_ordered_ref(x, c, nv, precision)
    assert torch.equal(s1, so) and torch.equal(n1, no)
    # two launches: bit-identical
    s3, n3, l3 = km._lloyd_kernel(x, c, nv, precision)
    assert torch.equal(s1, s3) and torch.equal(n1, n3) and torch.equal(l1, l3)


def _grid_inputs(card, p, d, k, seed):
    """One chunk of u8-grid rows exactly representable in bf16 ((q - 128) /
    512), so distances between them are exact in f32 and ties are exact
    ties in every mode, and centroids drawn from the rows."""
    r = np.random.default_rng(seed)
    x = ((r.integers(0, 256, (1, p, d)) - 128) / 512.0).astype(np.float32)
    c = x[:, r.choice(p, k, replace=False)].copy()
    return torch.from_numpy(x).to(card), torch.from_numpy(c).to(card)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,k", [(24, 600), (128, 1000)])
def test_kernels_resolve_exact_ties_to_the_lowest_index(card, precision, d, k):
    """Duplicated centroids in other 8-wide n-tiles and (at D = 128) other
    shared-memory tiles, rows sitting on them, and rows on the midpoint of
    two centroids of the grid."""
    x, c = _grid_inputs(card, 2048, d, k, seed=d)
    nv = torch.tensor([2048], dtype=torch.int32, device=card)
    c[0, 300] = c[0, 5]
    c[0, k - 50] = c[0, 260]
    x[0, :50] = c[0, 5]
    x[0, 50:100] = c[0, 260]
    # midpoints of (j, j + 1): the pair's grid values are made even apart
    for i, j in enumerate(range(10, 10 + 8 * 40, 8)):
        c[0, j + 1] = c[0, j] + 2.0 / 512.0 * ((i % 3) - 1)
        x[0, 100 + i] = (c[0, j] + c[0, j + 1]) / 2
    lab = km._lloyd_kernel(x, c, nv, precision)[2][0]
    assert bool((lab[:50] == 5).all()) and bool((lab[50:100] == 260).all())
    assert torch.equal(lab, km._lloyd_ref(x, c, nv, precision)[2][0])
    if precision == "f32":
        assign = km._assign_kernel(x[0], c[0])
        assert bool((assign[:50] == 5).all()) and bool((assign[50:100] == 260).all())


def test_lloyd_kernel_at_the_sog_palette_shape(card):
    """64 chunks of 65,536 u8-grid rows, 3M of them real: chunk 45 partial,
    chunks 46-63 PAD_POS only (their rows are not re-checked), k = 1024 in
    bf16, against K2's function in K4's order."""
    r = np.random.default_rng(9)
    n, chunks, p, d, k = 3_000_000, 64, 65_536, 24, 1024
    rows = ((r.integers(0, 256, (n, d), dtype=np.int32) - 128) / 512.0).astype(np.float32)
    x = pad_rows(torch.from_numpy(rows).to(card), chunks * p, PAD_POS).view(chunks, p, d)
    del rows
    nv = torch.clamp(n - torch.arange(chunks, device=card) * p, 0, p).to(torch.int32)
    valid = torch.arange(p, device=card)[None, :] < nv[:, None]
    c = km.init_centroids(x, k, 100, valid=valid)
    s1, n1, l1 = km._lloyd_kernel(x, c, nv, "bf16")
    rechecked = km.LAST_RECHECKED.cpu()
    so, no, lo = km._lloyd_ordered_ref(x, c, nv, "bf16")
    assert torch.equal(l1[valid], lo[valid])
    assert bool(torch.isfinite(s1).all())
    assert torch.equal(s1, so) and torch.equal(n1, no)
    assert int(rechecked[46:].sum()) == 0
    assert int(rechecked.sum()) <= 0.05 * n


def _assign_inputs(card, case):
    """x [N, D] and centroids [K, D] of one K3 case."""
    r = np.random.default_rng(len(case))
    if case == "k4100":  # K not a multiple of 8 or 16, on a 0.01 grid
        x, c, _ = _kmeans_inputs(card, chunks=1, p=9000, k=4100, seed=1)
        return x[0], c[0]
    if case == "grid_ties":  # u8 grid (SOG's dequantized values), exact ties
        x = (np.float32(-1.57) + np.float32(0.0123) * r.integers(0, 256, (20_000, 24)))
        x = x.astype(np.float32)
        c = x[r.choice(20_000, 600, replace=False)].copy()
        c[300], c[550], c[599] = c[5], c[260], c[5]
        x[:100], x[100:200] = c[5], c[260]
        return torch.from_numpy(x).to(card), torch.from_numpy(c).to(card)
    n, d, k = {"normal_1m": (1_048_576, 24, 4096), "d45": (9000, 45, 700),
               "d128": (9000, 128, 1000), "d129": (9000, 129, 300), "k1": (5000, 24, 1),
               "magnitudes": (9000, 24, 512)}[case]
    x = r.normal(0, 1, (n, d)).astype(np.float32)
    if case == "magnitudes":  # rows of magnitude 1e-30 and 1e15
        x[: n // 3] *= np.float32(1e-30)
        x[n // 3: 2 * n // 3] *= np.float32(1e15)
    c = x[r.choice(n, k, replace=False)].copy()
    return torch.from_numpy(x).to(card), torch.from_numpy(c).to(card)


@pytest.mark.parametrize("case", ["normal_1m", "grid_ties", "d45", "d128", "d129", "k1",
                                  "k4100", "magnitudes"])
def test_assign_kernel_matches_plain_version(card, case):
    """K3 equals its plain version on every row, a repeat launch is
    bit-identical, and on the tensor-core route (D <= 128) the share of
    rows it re-checks is within 2x of its plain spec's (``_assign_split_ref``,
    with 4 rows of room for counts near 0); D = 129 takes the chain."""
    x, c = _assign_inputs(card, case)
    launches = km.LAUNCHES["assign"]
    l1 = km._assign_kernel(x, c)
    listed = int(km.LAST_ASSIGN_RECHECKED)
    assert km.LAUNCHES["assign"] == launches + 1
    assert torch.equal(l1, km._assign_ref(x, c))
    assert torch.equal(l1, km._assign_kernel(x, c))
    spec, spec_listed = km._assign_split_ref(x, c)
    assert torch.equal(spec, l1)
    if x.shape[1] > km.PRECISION_MAX_D:
        assert listed == 0
    else:
        assert max(listed, spec_listed) <= 2 * min(listed, spec_listed) + 4, (listed, spec_listed)
    if case == "grid_ties":
        assert bool((l1[:100] == 5).all()) and bool((l1[100:200] == 260).all())
        assert listed >= 200


def _update_inputs(card, n, d, k, case, seed=2):
    """Rows and labels for K4: uniform labels; "zero": every label 0 (one
    cluster of n / 256 pieces), on nonnegative rows, since a sum of 1M
    N(0, 1) values cancels to about 1e3 and the f32 order alone then moves
    it by about 3e-3; "out_of_range": 5% of labels -1 or k; "empty": only
    every third cluster is used."""
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (n, d)).astype(np.float32)
    lab = r.integers(0, k, n).astype(np.int32)
    if case == "zero":
        x, lab = np.abs(x), np.zeros(n, np.int32)
    elif case == "out_of_range":
        lab[r.random(n) < 0.025] = -1
        lab[r.random(n) < 0.025] = k
    elif case == "empty":
        lab = (3 * r.integers(0, -(-k // 3), n)).astype(np.int32)
    return torch.from_numpy(x).to(card), torch.from_numpy(lab).to(card)


@pytest.mark.parametrize("n,d,k,case", [
    (1_048_576, 24, 4096, "uniform"), (65_536, 24, 1024, "uniform"), (3000, 3, 1, "uniform"),
    (70_000, 104, 2100, "uniform"), (4096, 2048, 16, "uniform"), (1_048_576, 24, 4096, "zero"),
    (200_000, 24, 300, "out_of_range"), (65_536, 24, 4096, "empty")])
def test_update_kernel_matches_plain_version(card, n, d, k, case):
    x, lab = _update_inputs(card, n, d, k, case)
    launches = km.LAUNCHES["update"]
    s1, n1 = km._update_kernel(x, lab, k)
    torch.cuda.synchronize()
    assert km.LAUNCHES["update"] == launches + 1
    # the kernel's summation order, bit for bit
    so, no = km._update_ordered_ref(x, lab, k)
    assert torch.equal(s1, so) and torch.equal(n1, no)
    s2, n2 = km._update_ref(x, lab, k)
    assert torch.equal(n1, n2)
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=1e-4)
    s3, n3 = km._update_kernel(x, lab, k)
    assert torch.equal(s1, s3) and torch.equal(n1, n3)


def test_kmeans_kernels_reject_what_they_do_not_take(card):
    x, c, nv = _kmeans_inputs(card, chunks=1, p=512, k=16)
    with pytest.raises(ValueError, match="contiguous"):
        km._lloyd_kernel(x.transpose(1, 2).contiguous().transpose(1, 2), c, nv)
    with pytest.raises(ValueError, match="float32"):
        km._assign_kernel(x[0].double(), c[0])
    with pytest.raises(ValueError, match="int32"):
        km._update_kernel(x[0], torch.zeros(512, dtype=torch.int64, device=card), 16)
    wide = torch.zeros(512, km.MAX_D + 1, device=card)
    with pytest.raises(ValueError, match=f"D <= {km.MAX_D}"):
        km._lloyd_kernel(wide[None], wide[None, :16], nv)
    with pytest.raises(ValueError, match=f"D <= {km.MAX_D}"):
        km.assign(wide, wide[:16])
    with pytest.raises(ValueError, match=f"D <= {km.MAX_D}"):
        km.update(wide, torch.zeros(512, dtype=torch.int32, device=card), 16, wide[:16])


@pytest.mark.parametrize("d,k,p", [(104, 130, 2048), (112, 130, 2048), (128, 300, 2048),
                                   (300, 64, 2048), (1000, 40, 1024), (24, 2100, 4608)])
def test_kmeans_kernels_at_any_width(card, d, k, p):
    """Every row tile size of csrc/kmeans.cu (512 rows up to D = 104, 256 up
    to 208, fewer with several threads a row beyond), and K2 above the JAX
    package's K <= 2048, against the plain versions."""
    x, c, nv = _kmeans_inputs(card, chunks=2, p=p, d=d, k=k, seed=d)
    real = torch.arange(p, device=card)[None, :] < nv[:, None]
    for precision in ("f32", "bf16"):
        s1, n1, l1 = km._lloyd_kernel(x, c, nv, precision)
        s2, n2, l2 = km._lloyd_ref(x, c, nv, precision)
        assert torch.equal(l1[real], l2[real]) and torch.equal(n1, n2)
        torch.testing.assert_close(s1, s2, rtol=1e-5, atol=1e-4)
        s3, n3, l3 = km._lloyd_kernel(x, c, nv, precision)
        assert torch.equal(s1, s3) and torch.equal(n1, n3) and torch.equal(l1, l3)
    assert torch.equal(km._assign_kernel(x[0], c[0]), km._assign_ref(x[0], c[0]))
    lab = l1[0].contiguous()
    s1, n1 = km._update_kernel(x[0], lab, k)
    s2, n2 = km._update_ref(x[0], lab, k)
    assert torch.equal(n1, n2)
    torch.testing.assert_close(s1, s2, rtol=1e-5, atol=1e-4)
    assert torch.equal(s1, km._update_ordered_ref(x[0], lab, k)[0])
    assert torch.equal(s1, km._update_kernel(x[0], lab, k)[0])


def test_public_kmeans_calls_launch_the_kernels_on_card(card):
    """lloyd_step beyond the bf16 range runs K2 in f32 (the JAX package's
    f32 route there), K4 as its sum stage; assign and update launch K3 and
    K4 at any width."""
    x, c, _ = _kmeans_inputs(card, chunks=1, p=4608, d=24, k=2100)
    before = dict(km.LAUNCHES)
    s1, n1, l1 = km.lloyd_step(x[0], c[0], 2100)
    s2, n2, l2 = km._lloyd_ref(x, c, torch.tensor([4608], dtype=torch.int32, device=card),
                               "f32")
    assert torch.equal(l1, l2[0]) and torch.equal(n1, n2[0])
    wide = x[0, :, :1].repeat(1, 300).contiguous()
    lab = km.assign(wide, wide[:40])
    km.update(wide, lab, 40, wide[:40])
    assert km.LAUNCHES["lloyd"] == before["lloyd"] + 1
    assert km.LAUNCHES["assign"] == before["assign"] + 1
    # K4 twice: the sum stage of K2, then update
    assert km.LAUNCHES["update"] == before["update"] + 2


def test_sog_written_twice_on_card_is_byte_identical(card, tmp_path):
    r = np.random.default_rng(4)
    n = 20_000
    rest = np.zeros((n, 3, 15), np.float32)
    rest[:, :, :8] = r.normal(0, 0.1, (n, 3, 8))
    quat = r.normal(0, 1, (n, 4)).astype(np.float32)
    cloud = SplatCloud(
        pos=r.normal(0, 2, (n, 3)).astype(np.float32),
        sh_dc=r.normal(0, 0.5, (n, 3)).astype(np.float32), sh_rest=rest,
        opacity=r.normal(1, 2, (n,)).astype(np.float32),
        log_scale=r.normal(-4, 0.5, (n, 3)).astype(np.float32),
        quat=quat / np.linalg.norm(quat, axis=1, keepdims=True),
        normal=np.zeros((n, 3), np.float32), active_sh_degree=2)
    outs = []
    for i in range(2):
        path = str(tmp_path / f"{i}.sog")
        launches = km.LAUNCHES["lloyd"]
        get_handler("sog").write(cloud, path, device="cuda", compression_level=1)
        assert km.LAUNCHES["lloyd"] == launches + 11  # 10 steps + final labels
        outs.append(open(path, "rb").read())
    assert outs[0] == outs[1]
    back = get_handler("sog").read(str(tmp_path / "0.sog"))
    assert back.n == n and back.active_sh_degree == 2


# ------------------------------------------------- K5 / K6: tile compositing


# the windows' splats by kind: (mean offset range in the tile, sigma range
# in px, alpha range).  "mixed": pixel-scale splats around each tile;
# "dense": every splat covers the whole tile faintly, so every warp of K6
# reduces every candidate (full groups of 8); "sparse": sigma under 0.25 px,
# so a splat covers under two pixel rows (one warp's), most warps skip most
# candidates and reduce the rest in short groups.
WINDOW_KINDS = {"mixed": ((-8, 24), (0.7, 6.0), (0.01, 0.9)),
                "dense": ((4, 12), (40.0, 80.0), (0.005, 0.05)),
                "sparse": ((0, 16), (0.15, 0.25), (0.05, 0.9))}


def _tile_windows(device, c_sz, budget, seed=0, kind="mixed"):
    """Synthetic per-tile candidate windows [C, budget] of splats of the
    given ``kind`` (``WINDOW_KINDS``), plus special tiles: 0 empty, 1 full,
    2 saturating after three candidates (four wide splats at alpha 0.99 in
    front), 3 fully transparent (every alpha below 1/255), 4 a near-camera
    giant (sigma of 500 px) in front.  Invalid slots (j >= count) carry
    alpha 0."""
    (m_lo, m_hi), (s_lo, s_hi), (a_lo, a_hi) = WINDOW_KINDS[kind]
    r = np.random.default_rng(seed)
    counts = r.integers(1, budget + 1, c_sz)
    counts[0], counts[1] = 0, budget
    tix = np.arange(c_sz)
    origin = np.stack([(tix % 32) * 16.0, (tix // 32) * 16.0], 1)
    mean = origin[:, None, :] + r.uniform(m_lo, m_hi, (c_sz, budget, 2))
    sig = r.uniform(s_lo, s_hi, (c_sz, budget, 2))
    rho = r.uniform(-0.6, 0.6, (c_sz, budget))
    det = (sig[..., 0] * sig[..., 1]) ** 2 * (1 - rho ** 2)
    conic = np.stack([sig[..., 1] ** 2 / det, -rho * sig[..., 0] * sig[..., 1] / det,
                      sig[..., 0] ** 2 / det], -1)
    color = r.uniform(0, 1, (c_sz, budget, 3))
    alpha = r.uniform(a_lo, a_hi, (c_sz, budget))
    mean[2, :4] = origin[2] + 8.0
    conic[2, :4] = [1e-4, 0.0, 1e-4]
    alpha[2, :4] = 0.99
    alpha[3] = 0.003
    mean[4, 0] = origin[4] + 3.0
    conic[4, 0] = [4e-6, 0.0, 4e-6]
    alpha[4, 0] = 0.6
    alpha[np.arange(budget)[None, :] >= counts[:, None]] = 0.0
    geo = np.concatenate([mean, conic, color], -1).astype(np.float32)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    return (f(geo), f(alpha), f(origin),
            torch.from_numpy(counts.astype(np.int32)).to(device))


def _field_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# (budget, bm, window kind); K6 sums a warp's live candidates 8 at a time,
# so bm 1, 5 and 45 (not multiples of 8) leave a partial last group
COMPOSITE_CASES = [(32, 32, "mixed"), (64, 32, "mixed"), (256, 64, "mixed"),
                   (1024, 64, "mixed"), (1024, 32, "mixed"), (96, 48, "mixed"),
                   (40, 1, "mixed"), (1024, 64, "dense"), (240, 48, "dense"),
                   (1024, 64, "sparse"), (90, 45, "sparse"), (45, 5, "mixed"),
                   (40, 5, "dense"), (48, 48, "sparse")]


@pytest.mark.parametrize("budget,bm,kind", [
    pytest.param(*case, id=f"{case[0]}-{case[1]}" + ("" if case[2] == "mixed"
                                                     else f"-{case[2]}"))
    for case in COMPOSITE_CASES])
def test_composite_kernels_match_plain_version(card, budget, bm, kind):
    c_sz = 96
    geo, alpha, origin, counts = _tile_windows(card, c_sz, budget, seed=budget + bm,
                                               kind=kind)
    bg = torch.tensor([0.25, 0.5, 1.0], device=card)
    before = dict(rz.LAUNCHES)
    fk = rz._composite_fwd_kernel(bm, geo, alpha, origin, counts, bg)
    torch.cuda.synchronize()
    fp = rz._composite_fwd_ref(bm, geo, alpha, origin, counts, bg, per_tile=True)
    assert rz.LAUNCHES["composite_fwd"] == before["composite_fwd"] + 1
    rgb_k, ts_k, tf_k, nd_k = fk
    rgb_p, ts_p, tf_p, nd_p = fp
    # a tile whose exit decision differs (its largest T within rounding of
    # T_EPS) is allowed T_EPS * (max color + max |bg|)
    flip = nd_k != nd_p
    assert int(flip.sum()) <= 1, int(flip.sum())
    same = ~flip
    err = (rgb_k - rgb_p).abs().amax((1, 2))
    assert float(err[same].max()) <= 2e-5
    if flip.any():
        assert float(err[flip].max()) <= rz.T_EPS * (1.0 + 1.0) + 2e-5
    assert int(nd_k[0]) == 0 and int(nd_k[2]) == -(-3 // bm)
    assert int(nd_k[3]) == -(-int(counts[3]) // bm)  # transparent: every block
    assert torch.allclose(rgb_k[0], bg.expand(256, 3))
    torch.testing.assert_close(tf_k[same], tf_p[same], rtol=1e-4, atol=1e-6)
    live = torch.arange(ts_k.shape[0], device=card)[:, None] < nd_k[None, :]
    live &= same[None, :]
    torch.testing.assert_close(ts_k[live], ts_p[live], rtol=1e-4, atol=1e-6)
    grgb = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (c_sz, 256, 3)).astype(np.float32)).to(card)
    dk = rz._composite_bwd_kernel(bm, geo, alpha, origin, bg, ts_k, tf_k, nd_k, grgb)
    torch.cuda.synchronize()
    dp = rz._composite_bwd_ref(bm, geo, alpha, origin, bg, ts_k, tf_k, nd_k, grgb)
    assert rz.LAUNCHES["composite_bwd"] == before["composite_bwd"] + 1
    rows = same[:, None].expand(-1, geo.shape[1])
    for name, sl in (("mean", slice(0, 2)), ("conic", slice(2, 5)), ("color", slice(5, 8))):
        assert _field_err(dk[0][..., sl][rows], dp[0][..., sl][rows]) <= 1e-4, name
    assert _field_err(dk[1][rows], dp[1][rows]) <= 1e-4, "alpha"
    assert _field_err(dk[2].sum(0), dp[2]) <= 1e-4, "bg"
    # blocks a tile never composited have zero gradients
    past = torch.arange(geo.shape[1], device=card)[None, :] >= (nd_k[:, None] * bm)
    assert not bool(dk[1][past].any()) and not bool(dk[0][past].any())


def test_composite_bwd_keeps_the_clamp_edges(card):
    """K6 against its plain version on the windows of
    ``torch_port_helpers.clamp_edge_windows``: power in (-3e-8, 0) where
    gauss rounds to 1, raw exactly 0.99, a exactly 1/255.  K6 rebuilds each
    alpha from a cached gauss whose sign carries power < 0."""
    geo, alpha, origin, counts = (torch.from_numpy(x).to(card) for x in clamp_edge_windows())
    bg = torch.tensor([0.2, 0.5, 0.9], device=card)
    grgb = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (3, 256, 3)).astype(np.float32)).to(card)
    for bm in (4, 8, 16):
        fk = rz._composite_fwd_kernel(bm, geo, alpha, origin, counts, bg)
        dk = rz._composite_bwd_kernel(bm, geo, alpha, origin, bg, *fk[1:], grgb)
        torch.cuda.synchronize()
        fp = rz._composite_fwd_ref(bm, geo, alpha, origin, counts, bg, per_tile=True)
        assert torch.equal(fk[3], fp[3])
        assert float((fk[0] - fp[0]).abs().max()) <= 2e-5
        dp = rz._composite_bwd_ref(bm, geo, alpha, origin, bg, *fk[1:], grgb)
        for sl in (slice(0, 2), slice(2, 5), slice(5, 8)):
            assert _field_err(dk[0][..., sl], dp[0][..., sl]) <= 1e-4, (bm, sl)
        assert _field_err(dk[1], dp[1]) <= 1e-4, bm
        assert _field_err(dk[2].sum(0), dp[2]) <= 1e-4, bm
        # the edge splats' own rows
        for got, want in ((dk[0][0, 5, 0], dp[0][0, 5, 0]), (dk[1][1, 6], dp[1][1, 6]),
                          (dk[1][2, 7], dp[1][2, 7])):
            assert float(want) != 0.0 and _field_err(got, want) <= 1e-4, bm


def _sequential_fwd(bm, geo, alpha, origin, counts):
    """t_starts, t_final and n_done of K5's semantics, each pixel's
    transmittance the sequential product of its factors: tb = tb * (1 - a_j)
    a candidate at a time, then T = T * tb a block, with ``_block_alpha`` on
    the card (the kernels' roundings, the accurate exp).  Per-tile exit at
    block boundaries, as K5 exits."""
    c_sz, m = alpha.shape
    nb = m // bm
    gx, gy = rz._pixel_grid(origin)
    geo_b, al_b = geo.reshape(c_sz, nb, bm, rz.GEO), alpha.reshape(c_sz, nb, bm)
    nbt = torch.clamp((counts.long() + bm - 1) // bm, max=nb)
    T = torch.ones(c_sz, rz.PIXELS, device=alpha.device)
    t_starts = torch.zeros(nb, c_sz, rz.PIXELS, device=alpha.device)
    n_done = torch.zeros(c_sz, dtype=torch.int32, device=alpha.device)
    for b in range(nb):
        act = (b < nbt) & (T.amax(1) > rz.T_EPS)
        if not bool(act.any()):
            break
        blk = geo_b[:, b]
        a = rz._block_alpha(blk[..., 0:2], blk[..., 2:5], al_b[:, b], gx, gy)[0]
        tb = torch.ones_like(T)
        for j in range(bm):
            tb = tb * (1.0 - a[:, j])
        t_starts[b] = T
        T = torch.where(act[:, None], T * tb, T)
        n_done += act.to(torch.int32)
    return t_starts, T, n_done


@pytest.mark.parametrize("case", ["clamp_edges", "mixed", "dense", "sparse"])
def test_composite_fwd_transmittance_bit_equal_to_sequential_products(card, case):
    """K5's transmittances are the sequential products of (1 - a) over its
    alphas, bit for bit, so its alphas are ``_block_alpha``'s: t_starts on
    every composited block, t_final and n_done ``torch.equal`` to
    ``_sequential_fwd``'s.  The windows: ``clamp_edge_windows`` (power just
    below 0, raw at 0.99, a at 1/255) and small ``_tile_windows`` (empty,
    full, saturating and transparent tiles among them)."""
    if case == "clamp_edges":
        geo, alpha, origin, counts = (torch.from_numpy(x).to(card)
                                      for x in clamp_edge_windows())
        bms = (4, 8, 16)
    else:
        geo, alpha, origin, counts = _tile_windows(card, 24, 96, seed=31, kind=case)
        bms = (32, 6, 48)
    bg = torch.tensor([0.3, 0.6, 0.9], device=card)
    for bm in bms:
        ts, tf, nd = _sequential_fwd(bm, geo, alpha, origin, counts)
        live = torch.arange(ts.shape[0], device=card)[:, None] < nd[None, :]
        _, ts_k, tf_k, nd_k = rz._composite_fwd_kernel(bm, geo, alpha, origin, counts, bg)
        torch.cuda.synchronize()
        assert torch.equal(nd_k, nd), (bm, nd_k, nd)
        assert torch.equal(tf_k, tf), bm
        assert torch.equal(ts_k[live], ts[live]), bm


def test_composite_fwd_rejects_an_unaligned_geo(card):
    """K5 copies each 32-byte geo row as two 16-byte copies, so a geo view
    that does not start 16-byte aligned is refused, not read wrong."""
    geo, alpha, origin, counts = _tile_windows(card, 8, 64, seed=3)
    bg = torch.tensor([0.3, 0.6, 0.9], device=card)
    geo_off = torch.zeros(geo.numel() + 1, device=card)[1:].view(geo.shape).copy_(geo)
    assert geo_off.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        rz._composite_fwd_kernel(16, geo_off, alpha, origin, counts, bg)


def test_composite_kernels_repeat_bit_identical(card):
    geo, alpha, origin, counts = _tile_windows(card, 64, 512, seed=5)
    bg = torch.tensor([0.1, 0.0, 0.3], device=card)
    f1 = rz._composite_fwd_kernel(64, geo, alpha, origin, counts, bg)
    f2 = rz._composite_fwd_kernel(64, geo, alpha, origin, counts, bg)
    assert torch.equal(f1[0], f2[0]) and torch.equal(f1[2], f2[2]) and torch.equal(f1[3], f2[3])
    live = torch.arange(f1[1].shape[0], device=card)[:, None] < f1[3][None, :]
    assert torch.equal(f1[1][live], f2[1][live])
    grgb = 2.0 * f1[0]
    b1 = rz._composite_bwd_kernel(64, geo, alpha, origin, bg, f1[1], f1[2], f1[3], grgb)
    b2 = rz._composite_bwd_kernel(64, geo, alpha, origin, bg, f1[1], f1[2], f1[3], grgb)
    for a, b in zip(b1, b2):
        assert torch.equal(a, b)


def test_composite_kernels_reject_what_they_do_not_take(card):
    geo, alpha, origin, counts = _tile_windows(card, 8, 128)
    bg = torch.zeros(3, device=card)
    for bm in (0, 65, 128, 96):
        with pytest.raises(ValueError):
            rz._composite_fwd_kernel(bm, geo, alpha, origin, counts, bg)
    with pytest.raises(ValueError):
        rz._composite_fwd_kernel(32, geo, alpha, origin, counts, bg.cpu())
    with pytest.raises(ValueError):
        rz._composite_fwd_kernel(32, geo[:, :, :7].contiguous(), alpha, origin, counts, bg)
    with pytest.raises(ValueError):
        rz.render(SplatCloud.zeros(8), rz.Camera.look_at((0, 0, -5), (0, 0, 0), width=32,
                                                         height=32), block_m=128)


def _render_scene(n=20_000, seed=7):
    """tests/test_render.py's structured scene (depth-stratified clusters,
    mid splats, near-camera giants) at 64 x 64, as a host cloud."""
    rr = np.random.default_rng(seed)
    n_giant, n_mid = 40, 1_500
    n_bg = n - n_giant - n_mid
    centers = np.array([[0, 0, 0], [0.8, 0.4, 1.5], [-0.6, -0.3, 3.0],
                        [0.2, -0.6, 4.5]], np.float32)
    pos = np.concatenate([
        centers[rr.integers(0, 4, n_bg)] + rr.normal(0, 0.5, (n_bg, 3)),
        rr.normal(0, 1.2, (n_mid, 3)),
        np.stack([rr.uniform(-1, 1, n_giant), rr.uniform(-1, 1, n_giant),
                  rr.uniform(3.2, 4.0, n_giant)], 1)]).astype(np.float32)
    ls = np.concatenate([rr.normal(-5.0, 0.3, (n_bg, 3)), rr.normal(-2.6, 0.2, (n_mid, 3)),
                         rr.normal(-0.8, 0.2, (n_giant, 3))]).astype(np.float32)
    op = np.concatenate([rr.normal(-1, 1, n_bg), rr.normal(0, 1, n_mid),
                         rr.normal(1.5, 0.5, n_giant)]).astype(np.float32)
    quat = rr.normal(0, 1, (n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    cloud = SplatCloud(pos=pos, sh_dc=rr.normal(0, 0.5, (n, 3)).astype(np.float32),
                       sh_rest=np.zeros((n, 3, 15), np.float32), opacity=op, log_scale=ls,
                       quat=quat, normal=np.zeros((n, 3), np.float32), active_sh_degree=0)
    cam = rz.Camera.look_at(eye=(0, 0, 5.0), target=(0, 0, 0), fov_deg=40.0,
                            width=64, height=64)
    return cloud, cam


def test_render_on_card_launches_once_per_band_and_matches_cpu(card, monkeypatch):
    cloud, cam = _render_scene()
    b = rz.auto_budget(cloud, cam, cap=16384, band_chunk=2)
    b_cpu = rz.auto_budget(cloud, cam, cap=16384, band_chunk=2, device="cpu")
    assert b["band_plan"] == b_cpu["band_plan"]
    kw = dict(binning="windowed", max_global=b["max_global"], tile_chunk=2, block_m=64,
              tile_order=b["tile_order"], band_plan=b["band_plan"])
    op = torch.from_numpy(cloud.opacity).to(card).requires_grad_(True)
    gcloud = cloud.to_device(card).replace(opacity=op)
    before = dict(rz.LAUNCHES)
    img = rz.render(gcloud, cam, **kw)
    assert rz.LAUNCHES["composite_fwd"] == before["composite_fwd"] + len(b["band_plan"])
    torch.sum(img * img).backward()
    torch.cuda.synchronize()
    assert rz.LAUNCHES["composite_bwd"] == before["composite_bwd"] + len(b["band_plan"])
    img = img.detach()
    # the CPU plain path: another exp and other projection roundings, so
    # a raw alpha at the 1/255 step may flip; held by PSNR and gradients
    op_c = torch.from_numpy(cloud.opacity).requires_grad_(True)
    img_c = rz.render(cloud.to_device("cpu").replace(opacity=op_c), cam, **kw)
    torch.sum(img_c * img_c).backward()
    assert _field_err(op.grad.cpu(), op_c.grad) <= 2e-3
    assert float(rz.psnr(img.cpu(), img_c.detach())) > 60.0
    # the plain path's chunk-wide exit on the card's own tensors (the same
    # alpha bits): within T_EPS * max color of the per-tile exit
    groups = rz._launch_groups
    monkeypatch.setattr(rz, "_launch_groups",
                        lambda n_tiles, chunk, on_card, *a: groups(n_tiles, chunk, False, *a))
    monkeypatch.setattr(rz, "_composite", lambda bm, g, a, o, c, bg, per_tile=True:
                        rz._composite_fwd_ref(bm, g, a, o, c, bg, per_tile=False)[0])
    with torch.no_grad():
        img_p = rz.render(cloud.to_device(card), cam, **kw)
    bound = rz.T_EPS * (float(np.clip(0.5 + 0.28209479 * cloud.sh_dc, 0, None).max())) + 1e-5
    assert float((img - img_p).abs().max()) <= bound


def test_fit_on_card_reduces_loss(card):
    from gsconverter_tpu_torch.render.train import fit

    cloud, cam = _render_scene(n=2_000, seed=3)
    target = rz.render(cloud, cam, max_per_tile=256, device="cuda")
    perturbed = cloud.replace(sh_dc=cloud.sh_dc + 0.3, opacity=cloud.opacity - 0.5)
    before = rz.LAUNCHES["composite_bwd"]
    fitted, losses = fit(perturbed, cam, target, steps=30, lr=2e-2, max_per_tile=256)
    assert fitted.pos.device.type == "cuda"
    assert rz.LAUNCHES["composite_bwd"] == before + 30
    assert losses[-1] < losses[0] * 0.5


# ------------------------------------------------ the multi-device renderer


def test_one_rank_sharded_render_on_card_equals_render(card):
    """A mesh of one rank (no group): sharded_render is render(bg=0), two
    K5 launches (its chunk, and its chunk as white splats); a band of
    render(rows=) is that band of the whole image; the tile-sharded image
    is within JAX's bar."""
    from gsconverter_tpu_torch.parallel import distributed as pd
    from gsconverter_tpu_torch.parallel.mesh import make_mesh

    cloud, cam = _render_scene()
    mesh = make_mesh(device=card)
    kw = dict(max_per_tile=1024, max_global=64, block_m=64)
    gcloud = cloud.to_device(card)
    whole = rz.render(gcloud, cam, bg=torch.zeros(3, device=card), **kw)
    before = rz.LAUNCHES["composite_fwd"]
    img = pd.sharded_render(gcloud, cam, mesh, **kw)
    assert rz.LAUNCHES["composite_fwd"] == before + 2
    assert torch.equal(img, whole)
    assert torch.equal(rz.render(gcloud, cam, rows=(16, 48), **kw), whole[16:48])
    assert float(rz.psnr(pd.sharded_render_tiles(gcloud, cam, mesh, **kw), whole)) > 35.0


def test_one_rank_sharded_step_on_card_matches_train_step(card):
    """One sharded training step at one rank against make_train_step from
    the same parameters: one K5 and one K6 launch, the loss within rel
    1e-5, every gradient within 1e-4 of its max |g| (index_add_ sums by
    atomics on the card)."""
    from gsconverter_tpu_torch.parallel.mesh import make_mesh
    from gsconverter_tpu_torch.parallel.train import make_sharded_train_step
    from gsconverter_tpu_torch.render import train

    cloud, cam = _render_scene(n=2_000, seed=3)
    base = cloud.to_device(card)
    target = rz.render(base, cam, max_per_tile=256)
    perturbed = base.replace(sh_dc=base.sh_dc + 0.3, opacity=base.opacity - 0.5)

    def one_step(make):
        params = {k: getattr(perturbed, k).clone().requires_grad_(True)
                  for k in train.TRAINABLE}
        opt = torch.optim.Adam(list(params.values()), lr=2e-2, betas=(0.9, 0.999), eps=1e-8)
        loss = float(make(opt, params)(target))
        return loss, {k: v.grad for k, v in params.items()}

    loss1, g1 = one_step(lambda o, p: train.make_train_step(perturbed, cam, o, p,
                                                            max_per_tile=256))
    before = dict(rz.LAUNCHES)
    loss2, g2 = one_step(lambda o, p: make_sharded_train_step(
        perturbed, cam, o, p, make_mesh(device=card), max_per_tile=256))
    torch.cuda.synchronize()
    assert rz.LAUNCHES["composite_fwd"] == before["composite_fwd"] + 1
    assert rz.LAUNCHES["composite_bwd"] == before["composite_bwd"] + 1
    assert abs(loss2 - loss1) <= 1e-5 * abs(loss1)
    for k in train.TRAINABLE:
        assert (g1[k] is None) == (g2[k] is None), k
        if g1[k] is not None:
            assert _field_err(g2[k], g1[k]) <= 1e-4, k


# ------------------------------------------------- the device-resident path


def _device_scene(n=20000, seed=11):
    """A host cloud: a dense blob, sparse noise inside +-40, SH degree 2."""
    r = np.random.default_rng(seed)
    pos = np.concatenate([r.normal(0, 2.0, (n - 300, 3)),
                          r.uniform(-40, 40, (300, 3))]).astype(np.float32)
    quat = r.normal(0, 1, (n, 4)).astype(np.float32)
    rest = np.zeros((n, 3, 15), np.float32)
    rest[:, :, :8] = r.normal(0, 0.1, (n, 3, 8))
    return SplatCloud(pos=pos, sh_dc=r.normal(0, 0.5, (n, 3)).astype(np.float32),
                      sh_rest=rest, opacity=r.normal(1, 2, n).astype(np.float32),
                      log_scale=r.normal(-4, 0.5, (n, 3)).astype(np.float32), quat=quat,
                      normal=np.zeros((n, 3), np.float32), active_sh_degree=2)


@pytest.mark.parametrize("multi,wide", [(False, False), (True, False), (False, True)])
def test_density_tensor_path_on_card_equals_cpu(card, multi, wide):
    from gsconverter_tpu_torch.ops import density

    pos = _device_scene().pos
    if wide:
        pos = pos.copy()
        pos[:5000] += np.float32(3000.0)
    want = density.density_mask(torch.from_numpy(pos), 1.0, 0.1, keep_multicluster=multi)
    got = density.density_mask(torch.from_numpy(pos).to(card), 1.0, 0.1,
                               keep_multicluster=multi)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, torch.from_numpy(
        density.density_mask(pos, 1.0, 0.1, keep_multicluster=multi)))


def test_sor_grid_on_card_matches_cpu(card):
    pos = torch.from_numpy(_device_scene(8000).pos)
    want = sor.sor_mean_knn_dists(pos, 25)
    got = sor.sor_mean_knn_dists(pos.to(card), 25).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    mg = sor.sor_mask(pos.to(card), 25, 3.0, method="grid").cpu()
    assert (mg == sor.sor_mask(pos, 25, 3.0, method="grid")).float().mean() >= 0.999


def test_tensor_filter_chain_on_card_matches_host(card):
    from gsconverter_tpu_torch.ops import compaction, filters

    c = _device_scene(30000)
    dev = c.device(card)
    assert dev.pos.device.type == "cuda"
    launches = 0
    for step in (lambda x: filters.crop_by_bbox(x, (-30, -30, -30, 30, 30, 30)),
                 lambda x: filters.alpha_filter(x, 5),
                 lambda x: filters.density_filter(x, sensitivity=0.5),
                 lambda x: filters.remove_flyers(x, intensity=4, device=card)):
        c = step(c)
        before = sor.KERNEL_LAUNCHES
        dev = step(dev)
        launches += sor.KERNEL_LAUNCHES - before
        assert dev.pos.device.type == "cuda" and dev.n == c.n
        np.testing.assert_array_equal(dev.pos.cpu().numpy(), c.pos)
    assert launches == 1  # the device chain's SOR stage launched K1 once
    m = torch.zeros(dev.n, dtype=torch.bool, device=card)
    m[::2] = True
    out = compaction.compact(dev, m)
    np.testing.assert_array_equal(out.pos.cpu().numpy(), c.pos[::2])


@pytest.mark.parametrize("fmt,kw", [("splat", {}), ("spz", {}), ("compressed_ply", {}),
                                    ("ksplat", dict(compression_level=0)),
                                    ("ksplat", dict(compression_level=2)), ("3dgs", {})])
def test_tensor_writer_on_card_within_a_step_of_host(card, fmt, kw, tmp_path):
    c = _device_scene(6000)
    c = c.replace(quat=c.quat / np.linalg.norm(c.quat, axis=1, keepdims=True))
    h = get_handler(fmt)
    a, b = str(tmp_path / f"h{h.extension}"), str(tmp_path / f"d{h.extension}")
    h.write(c, a, device="cpu", **kw)
    h.write(c.device(card), b, **kw)
    ca, cb = h.read(a), h.read(b)
    assert ca.n == cb.n
    if fmt == "splat":
        # rows whose metrics tie, or differ by the card's exp ulp, may
        # take another order: compare the rows in position order
        ca, cb = (x.select(np.lexsort(x.pos.T)) for x in (ca, cb))
    # exp, log1p and sigmoid on the card may round an ulp away from numpy's
    np.testing.assert_array_equal(cb.pos, ca.pos)
    np.testing.assert_allclose(cb.log_scale, ca.log_scale, rtol=0, atol=1e-3)
    np.testing.assert_allclose(cb.sh_dc, ca.sh_dc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cb.quat, ca.quat, rtol=0, atol=1e-6)
    sig = lambda x: 1 / (1 + np.exp(-x.astype(np.float64)))  # noqa: E731
    assert np.abs(sig(ca.opacity) - sig(cb.opacity)).max() <= 1 / 255 + 1e-6


def test_tensor_sog_on_card_matches_host_fitted_on_card(card, tmp_path):
    import zipfile

    c = _device_scene(20000)
    h = get_handler("sog")
    a, b = str(tmp_path / "h.sog"), str(tmp_path / "d.sog")
    h.write(c, a, device=card, compression_level=1)
    launches = dict(km.LAUNCHES)
    h.write(c.device(card), b, compression_level=1)
    assert km.LAUNCHES["lloyd"] == launches["lloyd"] + 11
    za, zb = zipfile.ZipFile(a), zipfile.ZipFile(b)
    same = [i.filename for i in za.infolist() if za.read(i.filename) == zb.read(i.filename)]
    # the palette (K2 on the same card and input) and the codebook textures
    for name in ("shN_centroids.webp", "shN_labels.webp", "scales.webp"):
        assert name in same, name


def test_checkpoint_of_a_card_cloud_and_validation(card, tmp_path):
    from gsconverter_tpu_torch.utils import checkpoint
    from gsconverter_tpu_torch.utils.validate import validate_cloud

    c = _device_scene(5000)
    dev = c.device(card)
    checkpoint.save(dev, str(tmp_path), "sor")
    back = checkpoint.load(str(tmp_path), "sor")
    np.testing.assert_array_equal(back.sh_rest, c.sh_rest)
    pos = dev.pos.clone()
    pos[:4] = float("nan")
    assert validate_cloud(dev.replace(pos=pos)) == validate_cloud(c.replace(pos=pos.cpu().numpy()))

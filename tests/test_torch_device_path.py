"""The port's device-resident cloud path against the JAX package, on the CPU.

A cloud of CPU tensors (``SplatCloud.device("cpu")``) takes every tensor
branch the card takes: the density and SOR grid device paths, compaction,
the filters and each writer's tensor encode.  The same inputs, made from a
seed with numpy, go through the JAX package's device path (``jnp`` inputs)
and through the port's host path.
"""

import io
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsconverter_tpu.ops import density as jdensity
from gsconverter_tpu.ops import sor as jsor
from gsconverter_tpu_torch.cloud import SplatCloud
from gsconverter_tpu_torch.converter import Converter
from gsconverter_tpu_torch.formats import get_handler
from gsconverter_tpu_torch.ops import compaction, filters
from gsconverter_tpu_torch.ops import density as tdensity
from gsconverter_tpu_torch.ops import sor as tsor
from gsconverter_tpu_torch.utils.transfer import cloud_is_host
from tests.conftest import make_cloud
from tests.torch_port_helpers import assert_clouds_equal, jax_one_device, to_port  # noqa: F401


def _host_cloud(n=5000, degree=2, seed=0):
    return to_port(make_cloud(n, sh_degree=degree, seed=seed))


# ------------------------------------------------------------------ cloud


def test_device_cloud_residency_round_trip():
    c = _host_cloud(300)
    t = c.device("cpu")
    assert not t.is_host and not cloud_is_host(t)
    assert isinstance(t.pos, torch.Tensor) and t.pos.device.type == "cpu"
    assert t.block_until_ready() is t
    assert_clouds_equal(t.to_numpy(), c)
    if not torch.cuda.is_available():
        # the default is the card, and there is no quiet fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            c.device()


def test_device_compaction_preserves_order():
    c = _host_cloud(100).device("cpu")
    mask = torch.from_numpy(np.arange(100) % 3 == 0)
    out = compaction.compact(c, mask)
    assert out.n == 34 and not out.is_host
    np.testing.assert_array_equal(out.pos.numpy(), c.pos.numpy()[mask.numpy()])
    order, count = compaction._front_pack_order(mask)
    assert int(count) == 34
    np.testing.assert_array_equal(order[:34].numpy(), np.flatnonzero(mask.numpy()))
    # a tensor cloud's compact and keep-mask select take the same path
    for other in (c.compact(mask), c.select(mask), c.compact(mask.numpy())):
        assert not other.is_host
        assert_clouds_equal(other.to_numpy(), out.to_numpy())


# ---------------------------------------------------------------- density


def _density_scene(kind, r):
    if kind == "grid30":  # a blob and sparse noise: the 30-bit grid
        return np.concatenate([r.normal(0, 2, (20000, 3)),
                               r.uniform(-40, 40, (300, 3))]), 1.0, 0.32, False
    if kind == "wide":  # extent / voxel > 1023: the 60-bit grid
        return np.concatenate([r.normal(0, 2, (15000, 3)),
                               r.normal(0, 2, (5000, 3)) + [3000.0, 0, 0]]), 1.0, 0.1, True
    if kind == "multicluster":
        return np.concatenate([r.normal(0, 2, (12000, 3)),
                               r.normal(0, 1.5, (8000, 3)) + [30.0, 0, 0],
                               r.uniform(-40, 40, (300, 3))]), 1.0, 0.1, True
    # one cluster and flyers, sensitivity-slider parameters
    voxel, thresh = tdensity.sensitivity_to_params(0.5)
    return np.concatenate([r.normal(0, 1.2, (20000, 3)),
                           r.uniform(-60, 60, (200, 3))]), voxel, thresh, False


@pytest.mark.parametrize("kind", ["grid30", "wide", "multicluster", "one_cluster"])
def test_density_tensor_path_matches_jax_device_path(kind):
    r = np.random.default_rng(3)
    pos, voxel, thresh, multi = _density_scene(kind, r)
    pos = pos.astype(np.float32)
    want = np.asarray(jdensity.density_mask(jnp.asarray(pos), voxel, thresh,
                                            keep_multicluster=multi))
    got = tdensity.density_mask(torch.from_numpy(pos), voxel, thresh,
                                keep_multicluster=multi)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # the host path agrees away from the pinned threshold case below
    np.testing.assert_array_equal(
        tdensity.density_mask(pos, voxel, thresh, keep_multicluster=multi), want)
    assert 0 < want.sum() < len(pos)


def test_density_f32_threshold_divergence_is_pinned():
    """The device path forms min_points in f32 (as JAX's device path):
    0.56 / 100 * 10000 is 55 there and 56 in the host path's f64.  A voxel
    of exactly 55 points next to the main cluster is kept on the device
    path and dropped on the host path, in both packages."""
    r = np.random.default_rng(0)
    n, thresh = 10000, 0.56
    rows = [x + r.uniform(0.1, 0.9, (100, 3)) * [1, 1, 1] for x in
            ([i, 0, 0] for i in range(98))]
    rows.append(np.array([98.0, 0, 0]) + r.uniform(0.1, 0.9, (55, 3)))
    rows.append(r.uniform(200, 400, (n - 98 * 100 - 55, 3)))  # 1-point voxels
    pos = np.concatenate(rows).astype(np.float32)
    assert pos.shape[0] == n
    dev = tdensity.density_mask(torch.from_numpy(pos), 1.0, thresh).numpy()
    np.testing.assert_array_equal(
        dev, np.asarray(jdensity.density_mask(jnp.asarray(pos), 1.0, thresh)))
    host = tdensity.density_mask(pos, 1.0, thresh)
    np.testing.assert_array_equal(host, jdensity._density_mask_host(pos, 1.0, thresh, False))
    assert dev.sum() == 9855 and host.sum() == 9800
    assert dev[9800:9855].all() and not host[9800:9855].any()


def test_density_empty_and_residency():
    got = tdensity.density_mask(torch.zeros((0, 3)), 1.0, 0.3)
    assert got.shape == (0,) and got.dtype == torch.bool


# -------------------------------------------------------------- SOR grid


def _sor_scene(n, seed):
    r = np.random.default_rng(seed)
    return np.concatenate([r.normal(0, 1.0, (n - 20, 3)),
                           r.uniform(-30, 30, (20, 3))]).astype(np.float32)


@pytest.mark.parametrize("n,seed", [(3000, 0), (9000, 1)])
def test_sor_grid_md_and_mask_match_jax(n, seed):
    pos = _sor_scene(n, seed)
    want = np.asarray(jsor.sor_mean_knn_dists(jnp.asarray(pos), 25))
    got = tsor.sor_mean_knn_dists(torch.from_numpy(pos), 25).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for sigma in (2.0, 10.5):
        mj = np.asarray(jsor.sor_mask(jnp.asarray(pos), 25, sigma, method="grid"))
        mt = tsor.sor_mask(torch.from_numpy(pos), 25, sigma, method="grid").numpy()
        assert (mj == mt).mean() >= 0.999


def test_sor_grid_cell_size_matches_jax():
    pos = _sor_scene(5000, 2)
    mins, extent = pos.min(0), pos.max(0) - pos.min(0)
    want = float(jsor._adaptive_cell_size(jnp.asarray(pos), jnp.ones(5000, bool),
                                          jnp.asarray(mins), jnp.asarray(extent)))
    got = float(tsor._adaptive_cell_size(torch.from_numpy(pos), torch.ones(5000, dtype=torch.bool),
                                         torch.from_numpy(mins), torch.from_numpy(extent)))
    assert got == want


def test_nanmedian_averages_the_middle_pair():
    x = torch.tensor([3.0, float("nan"), 1.0, 2.0, 10.0])
    assert float(tsor._nanmedian(x)) == float(np.nanmedian(x.numpy())) == 2.5
    assert torch.isnan(tsor._nanmedian(torch.full((4,), float("nan"))))


def test_sor_window_matches_grid_method():
    r = np.random.default_rng(3)
    pos = torch.from_numpy(r.normal(0, 1.0, (5000, 3)).astype(np.float32))
    mw = tsor.sor_mask(pos, k=20, sigma=3.0, method="window").numpy()
    mg = tsor.sor_mask(pos, k=20, sigma=3.0, method="grid").numpy()
    assert (mw == mg).mean() > 0.99


def test_sor_fill_semantics_agree():
    """Both methods rank isolated points identically: the flyers take the
    three largest md values, and both masks drop them."""
    r = np.random.default_rng(17)
    dense = r.normal(0, 0.05, (3000, 3)).astype(np.float32)
    flyers = np.array([[200.0, 0, 0], [0, 300.0, 0], [0, 0, -250.0]], np.float32)
    pos = torch.from_numpy(np.concatenate([dense, flyers]))
    n, k = pos.shape[0], 12
    md_grid = tsor.sor_mean_knn_dists(pos, k=k).numpy()
    p = tsor.next_pow2(n)
    posp = tsor.pad_rows(pos, p, tsor.PAD_POS)
    valid = torch.arange(p) < n
    md_win = tsor._sor_md_window(posp, valid, k, window=512, passes=2, iters=10,
                                 use_kernel=False).numpy()[:n]
    assert set(np.argsort(md_grid)[-3:]) == {3000, 3001, 3002}
    assert set(np.argsort(md_win)[-3:]) == {3000, 3001, 3002}
    # the grid floors the fill at its reach, as JAX's grid does
    np.testing.assert_allclose(
        md_grid[3000:], np.asarray(jsor.sor_mean_knn_dists(jnp.asarray(pos.numpy()), k=k))[3000:],
        rtol=1e-5)
    for method in ("grid", "window"):
        m = tsor.sor_mask(pos, k=k, sigma=3.0, method=method).numpy()
        assert not m[3000:].any(), method
        assert m[:3000].mean() > 0.95, method


def test_sor_mask_rejects_unknown_method():
    with pytest.raises(ValueError, match="grid"):
        tsor.sor_mask(torch.zeros((10, 3)), 25, 3.0, method="kdtree")


# ------------------------------------------------------------- filters


def _chain(cloud, device="cpu"):
    """The public filter chain, each stage's output kept."""
    out = [filters.crop_by_bbox(cloud, (-4, -4, -4, 4, 4, 4))]
    out.append(filters.alpha_filter(out[-1], 30))
    out.append(filters.density_filter(out[-1], sensitivity=0.3))
    out.append(filters.remove_flyers(out[-1], intensity=4, device=device))
    out.append(filters.auto_bbox(out[-1]))
    return out


def test_tensor_filter_chain_matches_host_chain(capsys):
    c = _host_cloud(6000, seed=4)
    host = _chain(c)
    dev = _chain(c.device("cpu"))
    for h, d in zip(host, dev):
        assert not d.is_host
        assert_clouds_equal(d.to_numpy(), h)
    assert host[-1].n < host[0].n
    # auto_bbox prints the same six numbers from both residencies
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "Auto-BBox" in ln]
    assert len(lines) == 2 and lines[0] == lines[1]


def test_remove_flyers_runs_where_a_tensor_cloud_lives():
    c = _host_cloud(3000, seed=5).device("cpu")
    # a device cloud ignores ``device``: it never leaves its own device
    out = filters.remove_flyers(c, intensity=4, device="meta")
    assert not out.is_host and out.pos.device.type == "cpu"


def test_empty_source_with_bbox_and_alpha(tmp_path, jax_one_device):
    """The JAX package's SplatCloud.select raises IndexError on an empty
    source with bbox or alpha (its deferred-compaction proxy has a 0-stride
    leaf); the port passes the empty cloud through."""
    src = str(tmp_path / "empty.ply")
    get_handler("3dgs").write(SplatCloud.zeros(0, active_sh_degree=0), src)
    out = str(tmp_path / "empty.splat")
    cloud = Converter(src, out, "splat", device="cpu").run(
        bbox=(-1, -1, -1, 1, 1, 1), min_opacity=10)
    assert cloud.n == 0 and (tmp_path / "empty.splat").stat().st_size == 0

    from gsconverter_tpu.converter import convert as jconvert
    with pytest.raises(IndexError):
        jconvert(src, str(tmp_path / "jax.splat"), "splat", bbox=(-1, -1, -1, 1, 1, 1))


@pytest.mark.parametrize("fmt", ["compressed_ply", "sog"])
def test_empty_cloud_writers_raise_a_clear_error(fmt, tmp_path):
    empty = SplatCloud.zeros(0, active_sh_degree=0)
    for cloud in (empty, empty.device("cpu")):
        with pytest.raises(ValueError, match="empty cloud"):
            get_handler(fmt).write(cloud, str(tmp_path / f"e.{fmt}"), device="cpu")


# ------------------------------------------------------------- writers

#: codecs whose tensor branch writes the host branch's bytes
EXACT = [("3dgs", {}), ("cc", {}), ("parquet", {}), ("spz", {}),
         ("compressed_ply", {})]
#: codecs whose f32 or f16 fields take ``exp`` or ``log1p``, which torch
#: and numpy round differently (an ulp): the decoded leaves must lie within
#: these bounds of the host file's (``alpha`` is sigmoid(opacity))
STEPS = [
    ("splat", {}, dict(log_scale=1e-6, alpha=1 / 255 + 1e-6)),
    ("ksplat", dict(compression_level=0), dict(log_scale=1e-6, alpha=1 / 255 + 1e-6)),
    ("ksplat", dict(compression_level=1), dict(log_scale=1e-3, alpha=1 / 255 + 1e-6)),
    ("ksplat", dict(compression_level=2), dict(log_scale=1e-3, alpha=1 / 255 + 1e-6)),
]


def _write_both(fmt, kw, cloud, tmp_path):
    h = get_handler(fmt)
    a, b = str(tmp_path / f"host{h.extension}"), str(tmp_path / f"dev{h.extension}")
    if fmt == "cc":
        from gsconverter_tpu_torch.ops import sh
        cloud = sh.add_rgb(cloud)
        dev = sh.add_rgb(cloud.replace(rgb=None).device("cpu"))
        np.testing.assert_array_equal(dev.rgb.numpy(), cloud.rgb)
    else:
        dev = cloud.device("cpu")
    h.write(cloud, a, device="cpu", **kw)
    h.write(dev, b, device="cpu", **kw)
    return a, b


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("degree", [0, 2])
@pytest.mark.parametrize("fmt,kw", EXACT)
def test_tensor_writer_bytes_equal_host_branch(fmt, kw, degree, tmp_path):
    a, b = _write_both(fmt, kw, _host_cloud(5000, degree=degree, seed=degree), tmp_path)
    assert _bytes(a) == _bytes(b)


@pytest.mark.parametrize("fmt,kw,steps", STEPS)
def test_tensor_writer_within_a_step_of_host_branch(fmt, kw, steps, tmp_path):
    a, b = _write_both(fmt, kw, _host_cloud(5000, degree=2, seed=1), tmp_path)
    h = get_handler(fmt)
    ca, cb = h.read(a), h.read(b)
    for name in ("pos", "sh_dc", "sh_rest", "quat"):
        np.testing.assert_array_equal(getattr(ca, name), getattr(cb, name), name)
    np.testing.assert_allclose(cb.log_scale, ca.log_scale, rtol=0, atol=steps["log_scale"])
    sig = lambda x: 1 / (1 + np.exp(-x.astype(np.float64)))  # noqa: E731
    assert np.abs(sig(ca.opacity) - sig(cb.opacity)).max() <= steps["alpha"]


def test_tensor_sog_matches_host_branch(tmp_path):
    """Every SOG entry but the position textures and meta.json's position
    bounds is byte-identical; those lie within one u16 step (torch's and
    numpy's f32 ``log1p`` differ by an ulp)."""
    a, b = _write_both("sog", dict(compression_level=1), _host_cloud(6000, degree=2, seed=2),
                       tmp_path)
    za, zb = zipfile.ZipFile(a), zipfile.ZipFile(b)
    names = [i.filename for i in za.infolist()]
    assert names == [i.filename for i in zb.infolist()]
    differ = {x for x in names if za.read(x) != zb.read(x)}
    assert differ <= {"means_l.webp", "means_u.webp", "meta.json"}
    import json

    ma, mb = json.loads(za.read("meta.json")), json.loads(zb.read("meta.json"))
    for key in ("scales", "quats", "sh0", "shN", "count", "version"):
        assert ma[key] == mb[key], key
    for key in ("mins", "maxs"):
        np.testing.assert_allclose(mb["means"][key], ma["means"][key], rtol=2.4e-7)
    from PIL import Image

    def u16(z):
        lo, hi = (np.asarray(Image.open(io.BytesIO(z.read(f"means_{s}.webp"))).convert("RGBA"))
                  .reshape(-1, 4)[:, :3].astype(np.int64) for s in "lu")
        return lo | (hi << 8)

    assert np.abs(u16(za) - u16(zb)).max() <= 1


def test_write_processed_tensor_cloud_to_every_format(tmp_path):
    """Converter.write_processed takes a tensor cloud through the format's
    SH cap, RGB and write; the .splat, .spz and compressed PLY files equal
    those of the host cloud's (splat within its scale ulp)."""
    c = _host_cloud(4000, degree=3, seed=6)
    for fmt in ("splat", "spz", "compressed_ply", "ksplat", "3dgs"):
        ext = get_handler(fmt).extension
        pa, pb = str(tmp_path / f"h_{fmt}{ext}"), str(tmp_path / f"d_{fmt}{ext}")
        Converter("in.ply", pa, fmt, device="cpu").write_processed(c, compression_level=1)
        out = Converter("in.ply", pb, fmt, device="cpu").write_processed(
            c.device("cpu"), compression_level=1)
        assert not out.is_host
        if fmt in ("spz", "compressed_ply", "3dgs"):
            assert _bytes(pa) == _bytes(pb), fmt
        else:
            assert len(_bytes(pa)) == len(_bytes(pb)), fmt


def test_write_processed_of_a_fresh_read_equals_run(tmp_path, jax_one_device):
    """A cloud fresh from a reader carries the structural degree of its
    columns (3 for a 45-coefficient PLY) above its content (2 here); the
    port's write_processed syncs the degree to the content, as run() does,
    so the .spz equals run()'s, where the JAX package's write_processed
    writes degree 3 with zero bands."""
    from gsconverter_tpu.converter import Converter as JConverter
    from gsconverter_tpu.formats import get_handler as jhandler

    src = str(tmp_path / "s.ply")
    get_handler("3dgs").write(_host_cloud(3000, degree=2, seed=8), src)
    cloud = get_handler("3dgs").read(src)
    assert cloud.active_sh_degree == 3
    run_out, wp_out, jax_out = (str(tmp_path / f"{x}.spz") for x in ("run", "wp", "jax"))
    Converter(src, run_out, "spz", device="cpu").run()
    for c in (cloud, cloud.device("cpu")):
        Converter(src, wp_out, "spz", device="cpu").write_processed(c)
        assert _bytes(wp_out) == _bytes(run_out)
    JConverter(src, jax_out, "spz").write_processed(jhandler("3dgs").read(src))
    assert get_handler("spz").read(jax_out).active_sh_degree == 3
    assert get_handler("spz").read(wp_out).active_sh_degree == 2

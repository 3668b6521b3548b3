""".sog codec of the PyTorch port against the JAX package, on the CPU.

Everything but the shN palette is byte-identical.  The palette is a
K-Means fit from a random init that the two packages draw differently, so
it is held three ways: with JAX's init injected into the port (the same
palette entries, decoded SH within a codebook step), with the port's own init (reconstruction error and
per-channel correlation), and through its building blocks (the u8
dequantization bit for bit, the host scalar codebook byte for byte).
"""

import io
import json
import threading
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsconverter_tpu.converter import convert as jax_convert
from gsconverter_tpu.formats import get_handler as jax_handler
from gsconverter_tpu.formats import sog as jsog
from gsconverter_tpu.ops import quant as jquant
from gsconverter_tpu_torch import main as torch_main
from gsconverter_tpu_torch.converter import convert as torch_convert
from gsconverter_tpu_torch.formats import get_handler as torch_handler
from gsconverter_tpu_torch.formats import sog as tsog
from gsconverter_tpu_torch.ops import kmeans as km
from gsconverter_tpu_torch.ops import quant as tquant
from tests.conftest import make_cloud
from tests.torch_port_helpers import (assert_clouds_equal, flyer_scene_ply,  # noqa: F401
                                      jax_chunk_init, jax_one_device, to_port)

_TEXTURES = ("means_l.webp", "means_u.webp", "quats.webp", "scales.webp", "sh0.webp")
_DIM = {1: 3, 2: 8, 3: 15}


def _entries(path):
    with zipfile.ZipFile(path) as zf:
        return [(i.filename, zf.read(i.filename)) for i in zf.infolist()]


def _palette(path, n):
    """(labels [n], centroid-index pixels, shN codebook) as written."""
    with zipfile.ZipFile(path) as zf:
        meta = json.load(zf.open("meta.json"))
        lab = tsog._read_webp_flat(zf, "shN_labels.webp", n)
        count, coeffs = meta["shN"]["count"], {1: 9, 2: 24, 3: 45}[meta["shN"]["bands"]]
        cent = tsog._read_webp_flat(zf, "shN_centroids.webp",
                                    64 * coeffs * -(-count // 64))
    labels = lab[:, 0].astype(np.int64) | (lab[:, 1].astype(np.int64) << 8)
    return labels, cent, np.array(meta["shN"]["codebook"], np.float32)


def _meta_without_codebook(entries):
    meta = json.loads(dict(entries)["meta.json"])
    meta.get("shN", {}).pop("codebook", None)
    return meta


def test_sog_quant_functions_byte_equal():
    r = np.random.default_rng(0)
    q = r.normal(0, 1, (5000, 4)).astype(np.float32)
    u8, alpha = tquant.pack_rot_sog(q)
    ju8, jalpha = jquant.pack_rot_sog(q)
    np.testing.assert_array_equal(u8, ju8)
    np.testing.assert_array_equal(alpha, jalpha)
    np.testing.assert_array_equal(tquant.unpack_rot_sog(u8, alpha),
                                  jquant.unpack_rot_sog(ju8, jalpha))
    # tensor inputs compute in torch: f32 scales may land one u8 step away
    tu8, talpha = tquant.pack_rot_sog(torch.from_numpy(q))
    assert np.abs(tu8.numpy().astype(int) - u8).max() <= 1
    np.testing.assert_array_equal(talpha.numpy(), alpha)
    np.testing.assert_allclose(
        tquant.unpack_rot_sog(torch.from_numpy(u8), torch.from_numpy(alpha)).numpy(),
        tquant.unpack_rot_sog(u8, alpha), atol=1e-6)
    cb = np.sort(r.normal(0, 1, 256)).astype(np.float32)
    for size in (1000, 2_100_000):  # the second one takes the threaded split
        v = r.normal(0, 1.2, size).astype(np.float32)
        idx = tquant.nearest_codebook_index(v, cb)
        assert idx.dtype == np.int32
        np.testing.assert_array_equal(idx, jquant.nearest_codebook_index(v, cb))
    np.testing.assert_array_equal(
        tquant.nearest_codebook_index(torch.from_numpy(v[:1000]), torch.from_numpy(cb)),
        idx[:1000])
    for n in (3000, 80_000):
        vals = r.normal(-4, 0.5, n).astype(np.float32)
        a = tsog._fit_scalar_codebook_host(vals, seed=1)
        b = jsog._fit_scalar_codebook_host(vals, seed=1)
        assert a.tobytes() == b.tobytes()


def test_dequant_matches_jax_bit_for_bit():
    r = np.random.default_rng(1)
    q8 = r.integers(0, 256, (20000, 24)).astype(np.uint8)
    scale, mn = 0.0021341, -0.41377
    want = np.asarray(jsog._dequant_u8(jnp.asarray(q8), jnp.float32(scale),
                                       jnp.float32(mn)))
    got = tsog._dequant_u8(torch.from_numpy(q8), scale, mn).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("deg", [1, 3])
def test_reader_reads_jax_sog(deg, tmp_path):
    path = str(tmp_path / "jax.sog")
    jax_handler("sog").write(make_cloud(3000, sh_degree=deg, seed=deg).to_numpy(), path)
    assert_clouds_equal(torch_handler("sog").read(path), jax_handler("sog").read(path))


def _scene(tmp_path, deg, n=10_000):
    src = str(tmp_path / "scene.ply")
    jax_handler("3dgs").write(make_cloud(n, sh_degree=deg, seed=20 + deg).to_numpy(), src)
    return src


def _convert_both(src, tmp_path, level, **kw):
    pj, pt = str(tmp_path / "jax.sog"), str(tmp_path / "torch.sog")
    jax_convert(src, pj, "sog", compression_level=level, force=True, **kw)
    torch_convert(src, pt, "sog", device="cpu", compression_level=level, force=True, **kw)
    ej, et = _entries(pj), _entries(pt)
    assert [name for name, _ in ej] == [name for name, _ in et]
    for name in _TEXTURES:
        assert dict(ej)[name] == dict(et)[name], name
    assert _meta_without_codebook(ej) == _meta_without_codebook(et)
    return pj, pt


@pytest.mark.parametrize("level", [0, 10])
@pytest.mark.parametrize("deg", [1, 2, 3])
def test_convert_to_sog_with_jax_init(deg, level, tmp_path, monkeypatch, jax_one_device):
    # 10,000 splats: 9 chunks of 911 (level 0) or 456 (level 10) centroids;
    # at level 0 a chunk holds 1,822 rows (the floor 911 times 2)
    src = _scene(tmp_path, deg)
    monkeypatch.setattr(km, "init_centroids", jax_chunk_init(100))
    pj, pt = _convert_both(src, tmp_path, level)
    lj, cj, cbj = _palette(pj, 10_000)
    lt, ct, _ = _palette(pt, 10_000)
    # same init, same distance roundings: the same palette entries
    assert (lj == lt).mean() >= 0.999
    assert (cj == ct).all(axis=1).mean() >= 0.99
    # The centroid sums are taken in another order than XLA's, so centroids
    # may differ by ulps; the host scalar codebook's 20 Lloyd iterations
    # spread that to shifts of a fraction of a codebook step, and a lookup
    # near a midpoint may flip one step.  Rows further off come from the
    # rare palette entries whose members differ.
    rj = np.asarray(jax_handler("sog").read(pj).sh_rest)
    rt = np.asarray(torch_handler("sog").read(pt).sh_rest)
    step = float(np.median(np.diff(cbj[np.abs(cbj) < 1e3])))
    far = (np.abs(rj - rt).reshape(len(rj), -1).max(1) > 2 * step).mean()
    assert far <= 0.01, far


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_convert_to_sog_own_init(deg, tmp_path, jax_one_device):
    # 3,000 splats: a 2,048-entry palette, fine enough to correlate
    src = _scene(tmp_path, deg, n=3000)
    level = 0
    pj, pt = _convert_both(src, tmp_path, level)
    ref = np.asarray(torch_handler("3dgs").read(src).sh_rest)
    ref = ref[tsog.morton_order(np.asarray(torch_handler("3dgs").read(src).pos))]
    dim = _DIM[deg]
    mse = {}
    for tag, path in (("jax", pj), ("torch", pt)):
        back = np.asarray(torch_handler("sog").read(path).sh_rest)
        mse[tag] = float(((back - ref)[:, :, :dim] ** 2).mean())
        assert back.shape[0] == ref.shape[0]
    for ch in range(3):
        r = np.corrcoef(ref[:, ch, :dim].ravel(), back[:, ch, :dim].ravel())[0, 1]
        assert r > 0.8, (ch, r)
    assert mse["torch"] <= 1.25 * mse["jax"], mse


def test_sog_after_the_config2_filter_chain(tmp_path, jax_one_device):
    src = flyer_scene_ply(tmp_path / "scene.ply")
    kw = dict(bbox=(-60, -60, -60, 60, 60, 60), min_opacity=5,
              density_sensitivity=0.5, sor_intensity=4)
    pj, pt = _convert_both(src, tmp_path, 1, **kw)
    assert json.loads(dict(_entries(pt))["meta.json"])["count"] < 5000
    back = torch_handler("sog").read(pt)
    assert back.active_sh_degree == 2 and np.isfinite(back.sh_rest).all()


def test_cli_writes_sog_on_cpu(tmp_path):
    src = _scene(tmp_path, 2, n=2000)
    out = str(tmp_path / "cli.sog")
    assert torch_main.main(["-i", src, "-o", out, "-f", "sog", "--device", "cpu",
                            "--force"]) == 0
    back = torch_handler("sog").read(out)
    assert back.n == 2000 and back.active_sh_degree == 2


def _pool_threads():
    return {t for t in threading.enumerate() if t.name.startswith("ThreadPoolExecutor")}


@pytest.mark.parametrize("where", ["webp", "quat"])
def test_failing_encode_leaves_no_worker_thread(where, tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("encode failed")

    if where == "webp":
        monkeypatch.setattr(tsog, "_webp_bytes", boom)
    else:
        monkeypatch.setattr(tquant, "pack_rot_sog", boom)
    cloud = to_port(make_cloud(1500, sh_degree=1))
    before = _pool_threads()
    with pytest.raises(RuntimeError, match="encode failed"):
        torch_handler("sog").write(cloud, str(tmp_path / "x.sog"), device="cpu")
    assert not (_pool_threads() - before)


def test_written_file_is_a_valid_zip_of_lossless_webp(tmp_path):
    path = str(tmp_path / "t.sog")
    torch_handler("sog").write(to_port(make_cloud(700, sh_degree=2)), path, device="cpu")
    from PIL import Image

    for name, data in _entries(path):
        if name.endswith(".webp"):
            assert Image.open(io.BytesIO(data)).format == "WEBP"

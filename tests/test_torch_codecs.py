"""The port's .ksplat, .spz, compressed PLY and Parquet codecs against the
JAX package, on the CPU.

Both packages write the same host cloud (``conftest.make_cloud`` carried
across with ``to_numpy``), the residency a cloud has on the conversion path,
where the JAX codecs take their numpy branch; the files must be
byte-identical, and each package reads the other's files to the same cloud.
gzip (.spz) and Parquet bytes depend on the zlib, pandas and pyarrow
builds, so they are compared within this one process.
"""

import functools
import gzip
import struct

import numpy as np
import pytest
import torch

import gsconverter_tpu
import gsconverter_tpu.ops.sor as jax_sor
from gsconverter_tpu.formats import get_handler as jax_handler
from gsconverter_tpu.formats.compressed_ply import morton_order as jax_morton_order
from gsconverter_tpu.ops import quant as jq
from gsconverter_tpu_torch import convert as torch_convert
from gsconverter_tpu_torch.converter import VALID_FORMATS, detect_format
from gsconverter_tpu_torch.formats import get_handler as torch_handler
from gsconverter_tpu_torch.formats.compressed_ply import morton_order
from gsconverter_tpu_torch.main import main as torch_main
from gsconverter_tpu_torch.ops import quant as tq
from gsconverter_tpu_torch.utils import ply as torch_ply
from tests.conftest import make_cloud
from tests.torch_port_helpers import (assert_clouds_equal, flyer_scene_ply,  # noqa: F401
                                      jax_one_device, to_port)

BBOX = (-60.0, -60.0, -60.0, 60.0, 60.0, 60.0)
#: BASELINE config 2's filter chain
CONFIG2 = dict(bbox=BBOX, min_opacity=5, density_sensitivity=0.5, sor_intensity=4)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _write_both(fmt, jcloud, tmp_path, **kw):
    """Both packages write the same host cloud; returns the two paths."""
    jcloud = jcloud.to_numpy()
    ext = jax_handler(fmt).extension
    pj, pt = str(tmp_path / f"jax{ext}"), str(tmp_path / f"torch{ext}")
    jax_handler(fmt).write(jcloud, pj, **kw)
    torch_handler(fmt).write(to_port(jcloud), pt, **kw)
    return pj, pt


def _assert_identical_and_cross_read(fmt, pj, pt):
    assert _bytes(pj) == _bytes(pt)
    # each package reads the other's file to the cloud the writer's own
    # package reads back
    assert_clouds_equal(torch_handler(fmt).read(pj), jax_handler(fmt).read(pt))
    assert_clouds_equal(torch_handler(fmt).read(pt), jax_handler(fmt).read(pj))


# ------------------------------------------------------------------ quant


@pytest.fixture(scope="module")
def quats():
    """Unit quaternions with axis-aligned and negated edge cases (the JAX
    package's quant parity set)."""
    r = np.random.default_rng(0)
    q = r.normal(size=(2000, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:8] = np.eye(4, 4)[[0, 1, 2, 3, 0, 1, 2, 3]]
    q[4:8] *= -1
    return q


def _port_both(fn, *arrays, **kw):
    """The port's function on numpy input and on CPU tensors (back as numpy)."""
    host = fn(*arrays, **kw)
    dev = fn(*(torch.from_numpy(np.asarray(a)) for a in arrays), **kw)
    if isinstance(dev, tuple):
        return host, tuple(d.numpy() for d in dev)
    return host, dev.numpy()


def _assert_equal_to(ref, got):
    if isinstance(ref, tuple):
        for a, b in zip(ref, got):
            _assert_equal_to(a, b)
        return
    assert isinstance(ref, np.ndarray)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["spz", "cply"])
def test_rotation_packers_equal_jax(name, quats):
    pack, unpack = f"pack_rot_{name}", f"unpack_rot_{name}"
    ref = getattr(jq, pack)(quats)
    assert ref.dtype == np.uint32
    for got in _port_both(getattr(tq, pack), quats):
        _assert_equal_to(ref, got)
    back = getattr(jq, unpack)(ref)
    for got in _port_both(getattr(tq, unpack), ref):
        _assert_equal_to(back, got)


def test_fixed24_equal_jax():
    r = np.random.default_rng(1)
    pos = (r.normal(size=(1000, 3)) * 5).astype(np.float32)
    pos[:4] = [[0, -0.0, 1e-6], [-2047.9, 2047.9, 0.5 / 4096], [-1.5 / 4096, 2.5 / 4096, 0], [3, -3, 7]]
    ref = jq.pos_to_fixed24(pos, 12)
    for got in _port_both(tq.pos_to_fixed24, pos, frac_bits=12):
        _assert_equal_to(ref, got)
    back = jq.fixed24_to_pos(ref, 12)
    for got in _port_both(tq.fixed24_to_pos, ref, frac_bits=12):
        _assert_equal_to(back, got)
    assert np.abs(back - pos).max() < 2 / 4096


def test_packed_u32_equal_jax():
    r = np.random.default_rng(2)
    pos = (r.normal(size=(1000, 3)) * 5).astype(np.float32)
    pos[:, 2] = pos[0, 2]  # a degenerate axis packs as 0
    mins, maxs = pos.min(0), pos.max(0)
    ref = jq.pack_11_10_11(pos, mins, maxs)
    assert ref.dtype == np.uint32
    for got in _port_both(tq.pack_11_10_11, pos, mins, maxs):
        _assert_equal_to(ref, got)
    back = jq.unpack_11_10_11(ref, mins, maxs)
    for got in _port_both(tq.unpack_11_10_11, ref, mins, maxs):
        _assert_equal_to(back, got)

    rgb = np.clip(r.normal(0.5, 0.3, (1000, 3)), 0, 1).astype(np.float32)
    alpha = r.random(1000).astype(np.float32)
    z3, o3 = np.zeros(3, np.float32), np.ones(3, np.float32)
    ref = jq.pack_8888(rgb, alpha, z3, o3)
    assert ref.dtype == np.uint32
    for got in _port_both(tq.pack_8888, rgb, alpha, z3, o3):
        _assert_equal_to(ref, got)
    back = jq.unpack_8888(ref, z3, o3)
    for got in _port_both(tq.unpack_8888, ref, z3, o3):
        _assert_equal_to(back, got)


def test_scalar_maps_equal_jax():
    r = np.random.default_rng(3)
    logits = (r.normal(size=1000) * 4).astype(np.float32)
    ref = jq.logit_to_u8(logits)
    for got in _port_both(tq.logit_to_u8, logits):
        _assert_equal_to(ref, got)
    # every u8 input
    u8 = np.arange(256, dtype=np.uint8)
    ref = jq.u8_to_logit(u8)
    host, dev = _port_both(tq.u8_to_logit, u8)
    _assert_equal_to(ref, host)
    # log in torch and in numpy's SIMD f32 log differ by an ulp on some
    # inputs: the tolerance of the JAX package's own numpy-vs-XLA check
    np.testing.assert_allclose(dev, ref, rtol=1e-5, atol=1e-6)
    sh = (r.normal(size=(1000, 9)) * 0.3).astype(np.float32)
    for bits in (4, 5):
        ref = jq.quant_sh_spz(sh, bits)
        for got in _port_both(tq.quant_sh_spz, sh, bits=bits):
            _assert_equal_to(ref, got)
    u8 = r.integers(0, 256, (1000, 9)).astype(np.uint8)
    for got in _port_both(tq.dequant_sh_spz, u8):
        _assert_equal_to(jq.dequant_sh_spz(u8), got)


# ------------------------------------------------------------------ Morton


def _morton_case(case):
    r = np.random.default_rng(4)
    pos = (r.normal(size=(3000, 3)) * 3).astype(np.float32)
    if case == "duplicates":
        pos[1000:2000] = pos[:1000]
        pos[2000:2100] = pos[7]
    elif case == "zero_extent":
        pos[:, 1] = 2.5
    elif case == "one_point":
        pos = pos[:1]
    return pos


@pytest.mark.parametrize("case", ["normal", "duplicates", "zero_extent", "one_point"])
def test_morton_order_equals_jax(case):
    pos = _morton_case(case)
    ref = np.asarray(jax_morton_order(pos))
    np.testing.assert_array_equal(morton_order(pos), ref)


# --------------------------------------------------------------- writers


@pytest.mark.parametrize("sizing", ["given", "auto"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 5000])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_ksplat_byte_identical(level, degree, n, sizing, tmp_path):
    jc = make_cloud(n, sh_degree=degree, rgb=True, seed=n + degree)
    kw = dict(compression_level=level)
    if sizing == "given":
        kw.update(bucket_size=128, block_size=9.0)
    pj, pt = _write_both("ksplat", jc, tmp_path, **kw)
    _assert_identical_and_cross_read("ksplat", pj, pt)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("level", [0, 6])
def test_spz_byte_identical(level, degree, tmp_path):
    jc = make_cloud(777, sh_degree=degree, seed=degree)
    pj, pt = _write_both("spz", jc, tmp_path, compression_level=level)
    _assert_identical_and_cross_read("spz", pj, pt)


@pytest.mark.parametrize("n", [1, 1000])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_compressed_ply_byte_identical(degree, n, tmp_path):
    jc = make_cloud(n, sh_degree=degree, seed=10 + degree)
    pj, pt = _write_both("compressed_ply", jc, tmp_path)
    _assert_identical_and_cross_read("compressed_ply", pj, pt)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_parquet_byte_identical_with_extras(degree, tmp_path):
    import jax.numpy as jnp

    jc = make_cloud(300, sh_degree=degree, seed=20 + degree).replace(
        extras={"label": jnp.arange(300, dtype=jnp.float32)})
    pj, pt = _write_both("parquet", jc, tmp_path)
    assert _bytes(pj) == _bytes(pt)
    # Parquet extras are not read back (the reader keeps the schema only)
    assert_clouds_equal(torch_handler("parquet").read(pj), jax_handler("parquet").read(pt))
    assert_clouds_equal(torch_handler("parquet").read(pt), jax_handler("parquet").read(pj))


#: (format, write kwargs, {leaf: largest difference}) of the files the JAX
#: package's jitted branch writes (a cloud of jnp leaves) against the port's:
#: XLA's CPU backend contracts ``sh_dc * SH_C0 + 0.5`` into an FMA, its exp
#: and sigmoid differ from numpy's by an ulp, and it sizes the ksplat block
#: in f32, so the files agree within a quantization step (``alpha``: of
#: sigmoid(opacity)), not byte for byte
ALPHA_STEP = 1 / 255 + 1e-6
JITTED_STEPS = [
    ("spz", {}, dict(pos=1 / 4096, sh_dc=1 / 255 / 0.15 + 1e-6, log_scale=1 / 16,
                     sh_rest=16 / 128, alpha=ALPHA_STEP)),
    ("compressed_ply", {}, dict(sh_dc=1e-6)),
    ("ksplat", dict(compression_level=0), dict(log_scale=1e-6, alpha=ALPHA_STEP)),
    ("ksplat", dict(compression_level=1), dict(pos="step", log_scale=1e-3, alpha=ALPHA_STEP)),
    ("ksplat", dict(compression_level=2), dict(pos="step", log_scale=1e-3, alpha=ALPHA_STEP)),
]


@pytest.mark.parametrize("degree", [0, 2])
@pytest.mark.parametrize("fmt,kw,steps", JITTED_STEPS)
def test_jitted_jax_branch_within_one_step(fmt, kw, steps, degree, tmp_path):
    jc = make_cloud(5000, sh_degree=degree, seed=degree)
    ext = torch_handler(fmt).extension
    pj, pt = str(tmp_path / f"jit{ext}"), str(tmp_path / f"port{ext}")
    jax_handler(fmt).write(jc, pj, **kw)
    handler = torch_handler(fmt)
    handler.write(to_port(jc.to_numpy()), pt, **kw)
    b = handler.read(pt)
    a = torch_handler(fmt).read(pj)
    for name in ("pos", "sh_dc", "sh_rest", "opacity", "log_scale", "quat"):
        tol = steps.get(name, 0.0)
        if tol == "step":
            tol = handler.metadata["sections"][0]["bucketBlockSize"] / 2 / 32767 + 1e-6
        diff = np.abs(getattr(a, name) - getattr(b, name))
        if name == "opacity":
            diff = np.abs(1 / (1 + np.exp(-a.opacity)) - 1 / (1 + np.exp(-b.opacity)))
            tol = steps.get("alpha", 0.0)
        assert diff.max() <= tol, (name, float(diff.max()))


def test_ksplat_without_sections_reads_empty(tmp_path):
    path = str(tmp_path / "empty.ksplat")
    header = bytearray(4096)
    header[1] = 1
    with open(path, "wb") as f:
        f.write(bytes(header))
    back = torch_handler("ksplat").read(path)
    assert back.n == 0 and back.is_host
    assert_clouds_equal(back, jax_handler("ksplat").read(path).to_numpy())


def test_spz_legacy_v2_read(tmp_path):
    """A v2 file (first-three u8 rotation) reads as the JAX package reads it."""
    r = np.random.default_rng(5)
    n = 50
    body = b"".join([
        r.integers(0, 256, n * 9, dtype=np.uint8).tobytes(),   # positions
        r.integers(0, 256, n, dtype=np.uint8).tobytes(),       # alpha
        r.integers(0, 256, n * 3, dtype=np.uint8).tobytes(),   # colors
        r.integers(0, 256, n * 3, dtype=np.uint8).tobytes(),   # scales
        r.integers(0, 256, n * 3, dtype=np.uint8).tobytes(),   # rotations
        r.integers(0, 256, n * 9, dtype=np.uint8).tobytes(),   # SH, degree 1
    ])
    path = str(tmp_path / "v2.spz")
    with open(path, "wb") as f:
        f.write(gzip.compress(struct.pack("<IIIBBBB", 0x5053474E, 2, n, 1, 12, 0, 0) + body))
    back = torch_handler("spz").read(path)
    assert back.n == n and back.active_sh_degree == 1
    assert_clouds_equal(back, jax_handler("spz").read(path))


def test_compressed_ply_reader_falls_back_to_3dgs(tmp_path):
    path = str(tmp_path / "plain.ply")
    jax_handler("3dgs").write(make_cloud(40, sh_degree=1).to_numpy(), path)
    back = torch_handler("compressed_ply").read(path)
    assert_clouds_equal(back, jax_handler("compressed_ply").read(path))


# ------------------------------------------- the JAX package's format tests


def _roundtrip(fmt, tmp_path, jc, **kw):
    path = str(tmp_path / f"rt{torch_handler(fmt).extension}")
    torch_handler(fmt).write(to_port(jc.to_numpy()), path, **kw)
    return torch_handler(fmt).read(path)


def _match_rows(a, b):
    """For each row of a, the index of the row of b at the same position."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.argmin(d, axis=1)


def test_spz_roundtrip(tmp_path):
    c = make_cloud(300, sh_degree=2)
    d = _roundtrip("spz", tmp_path, c)
    assert d.n == 300 and d.active_sh_degree == 2
    np.testing.assert_allclose(d.pos, c.pos, atol=2.0 / (1 << 12))
    np.testing.assert_allclose(d.log_scale, c.log_scale, atol=1.0 / 16.0)
    np.testing.assert_allclose(d.sh_dc, c.sh_dc, atol=(1.0 / 255.0) / 0.15 + 1e-3)
    assert np.all(np.abs(np.sum(np.asarray(c.quat) * d.quat, axis=1)) > 0.9999)
    # SH: 5-bit snapping on the first block, 4-bit above
    np.testing.assert_allclose(d.sh_rest[:, :, :3], np.asarray(c.sh_rest)[:, :, :3],
                               atol=8.5 / 128)
    np.testing.assert_allclose(d.sh_rest[:, :, 3:8], np.asarray(c.sh_rest)[:, :, 3:8],
                               atol=16.5 / 128)


def test_compressed_ply_roundtrip(tmp_path):
    c = make_cloud(600, sh_degree=2)
    d = _roundtrip("compressed_ply", tmp_path, c)
    assert d.n == 600
    idx = _match_rows(c.pos, d.pos)  # Morton order
    np.testing.assert_allclose(d.pos[idx], np.asarray(c.pos), atol=2e-2)
    np.testing.assert_allclose(d.log_scale[idx], np.clip(np.asarray(c.log_scale), -20, 20),
                               atol=3e-2)
    sig = lambda x: 1 / (1 + np.exp(-np.asarray(x)))  # noqa: E731
    np.testing.assert_allclose(sig(d.opacity)[idx], sig(c.opacity), atol=1.5 / 255)
    assert np.all(np.abs(np.sum(np.asarray(c.quat) * d.quat[idx], axis=1)) > 0.999)
    # the SH u8 truncates: a full 8/256 step
    np.testing.assert_allclose(d.sh_rest[idx][:, :, :8], np.asarray(c.sh_rest)[:, :, :8],
                               atol=8.0 / 256 + 1e-3)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_ksplat_roundtrip(level, tmp_path):
    c = make_cloud(300, sh_degree=2)
    d = _roundtrip("ksplat", tmp_path, c, compression_level=level)
    assert d.n == 300
    idx = _match_rows(c.pos, d.pos) if level >= 1 else np.arange(300)
    # level >= 1: within the auto-sized block's step
    meta_block = torch_handler("ksplat")
    meta_block.read(str(tmp_path / "rt.ksplat"))
    step = (meta_block.metadata["sections"][0]["bucketBlockSize"] / 2.0 / 32767
            if level else 0.0)
    np.testing.assert_allclose(d.pos[idx], c.pos, atol=1e-6 if level == 0 else step + 1e-6)
    np.testing.assert_allclose(d.log_scale[idx], c.log_scale,
                               atol=1e-3 if level == 0 else 2e-2)
    assert np.all(np.abs(np.sum(np.asarray(c.quat) * d.quat[idx], axis=1)) > 0.999)
    tol_sh = {0: 1e-6, 1: 2e-3, 2: 4.0 / 255 + 1e-3}[level]
    np.testing.assert_allclose(d.sh_rest[idx][:, :, :8], np.asarray(c.sh_rest)[:, :, :8],
                               atol=tol_sh)
    assert np.all(d.sh_rest[:, :, 8:] == 0)  # degree capped at 2


def test_spz_header_bytes(tmp_path):
    path = str(tmp_path / "t.spz")
    torch_handler("spz").write(to_port(make_cloud(123, sh_degree=1).to_numpy()), path)
    raw = gzip.decompress(_bytes(path))
    assert struct.unpack("<IIIBBBB", raw[:16]) == (0x5053474E, 3, 123, 1, 12, 1, 0)
    # pos 9 B + alpha 1 + color 3 + scale 3 + rot 4 + SH 3*3
    assert len(raw) - 16 == 123 * (9 + 1 + 3 + 3 + 4 + 9)


def test_ksplat_header_offsets(tmp_path):
    path = str(tmp_path / "t.ksplat")
    torch_handler("ksplat").write(to_port(make_cloud(300, sh_degree=2).to_numpy()), path,
                                  compression_level=1, bucket_size=128)
    raw = _bytes(path)
    assert raw[0] == 0 and raw[1] == 1
    assert [struct.unpack_from("<I", raw, o)[0] for o in (4, 8, 12, 16)] == [1, 1, 300, 300]
    assert struct.unpack_from("<H", raw, 20)[0] == 1
    sec = raw[4096:4096 + 1024]
    assert [struct.unpack_from("<I", sec, o)[0] for o in (0, 8, 12, 24, 32, 36)] == \
        [300, 128, 3, 32767, 2, 1]
    assert struct.unpack_from("<H", sec, 40)[0] == 2
    # pfb u32 + centers 3*12 + 300 * (6+6+8+4 + 24*2)
    assert len(raw) == 4096 + 1024 + 4 + 3 * 12 + 300 * (24 + 48)


def test_compressed_ply_element_layout(tmp_path):
    path = str(tmp_path / "t.ply")
    torch_handler("compressed_ply").write(to_port(make_cloud(300, sh_degree=1).to_numpy()),
                                          path)
    plyf = torch_ply.read(path)
    assert [e.name for e in plyf.elements] == ["chunk", "vertex", "sh"]
    assert len(plyf["chunk"].data) == 2
    assert plyf["chunk"].data.dtype.names[:6] == (
        "min_x", "min_y", "min_z", "max_x", "max_y", "max_z")
    vert = plyf["vertex"].data
    assert vert.dtype.names == ("packed_position", "packed_rotation", "packed_scale",
                                "packed_color")
    assert all(vert.dtype[n] == np.dtype("<u4") for n in vert.dtype.names)
    assert len(plyf["sh"].data.dtype.names) == 9


# ------------------------------------------------------------- converter


def test_every_format_is_detected_and_listed(tmp_path, capsys):
    c = to_port(make_cloud(100, sh_degree=1, rgb=True).to_numpy())
    for fmt in VALID_FORMATS:
        path = str(tmp_path / f"d_{fmt}{torch_handler(fmt).extension}")
        torch_handler(fmt).write(c, path, device="cpu")
        assert detect_format(path) == fmt, fmt
        assert torch_main(["-i", path, "--info"]) == 0
        out = capsys.readouterr().out
        assert f"Format Detected: {fmt.upper()}" in out and "Points: 100" in out, fmt
    path = str(tmp_path / "d_ksplat.ksplat")
    torch_handler("ksplat").write(c, path, compression_level=1)
    torch_main(["-i", path, "--info"])
    assert "Compression Level: 1" in capsys.readouterr().out


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return flyer_scene_ply(tmp_path_factory.mktemp("scene") / "scene.ply")


@pytest.mark.parametrize("fmt,kw", [
    ("ksplat", dict(compression_level=0)),
    ("ksplat", dict(compression_level=1)),
    ("ksplat", dict(compression_level=2)),
    ("spz", dict(compression_level=6)),
    ("compressed_ply", {}),
    ("parquet", {}),
])
def test_convert_byte_identical_config2(fmt, kw, scene, tmp_path, monkeypatch,
                                        jax_one_device):
    """ply -> each new format through the config-2 filter chain: the JAX
    package's SOR runs its Pallas kernel in interpret mode, the port's its
    K1 wrapper's plain version."""
    monkeypatch.setattr(jax_sor, "sor_mask",
                        functools.partial(jax_sor.sor_mask, impl="pallas_interpret"))
    ext = torch_handler(fmt).extension
    oj, ot = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    cj = gsconverter_tpu.convert(scene, oj, fmt, **CONFIG2, **kw)
    ct = torch_convert(scene, ot, fmt, device="cpu", **CONFIG2, **kw)
    assert ct.n == cj.n and 2048 < ct.n < 5000
    assert _bytes(oj) == _bytes(ot)
    assert torch_handler(fmt).read(ot).n == ct.n


def test_format_matrix_n_to_n(tmp_path):
    """Every format read back after a conversion from a 3DGS PLY."""
    src = str(tmp_path / "scene.ply")
    torch_handler("3dgs").write(to_port(make_cloud(800, sh_degree=2).to_numpy()), src)
    for fmt in ["3dgs", "cc", "splat", "spz", "compressed_ply", "ksplat", "parquet", "sog"]:
        out = str(tmp_path / f"m{torch_handler(fmt).extension}")
        torch_convert(src, out, fmt, device="cpu", force=True)
        assert torch_handler(fmt).read(out).n == 800, fmt


def test_cli_ksplat_on_cpu(tmp_path):
    src = str(tmp_path / "scene.ply")
    torch_handler("3dgs").write(to_port(make_cloud(500, sh_degree=2).to_numpy()), src)
    out = str(tmp_path / "out.ksplat")
    assert torch_main(["-i", src, "-o", out, "-f", "ksplat", "--compression_level", "1",
                       "--min_opacity", "5", "--device", "cpu", "--force"]) == 0
    back = torch_handler("ksplat").read(out)
    assert 0 < back.n <= 500 and back.active_sh_degree == 2

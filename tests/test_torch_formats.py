"""Codecs of the PyTorch port against the JAX package, on the CPU.

For the same cloud (``conftest.make_cloud``, carried across with
``SplatCloud.from_numpy(cloud.to_numpy())``) both packages write the same
bytes, and each reads the other's files to the same cloud.
"""

import numpy as np
import pytest

from gsconverter_tpu.cloud import SplatCloud as JaxCloud
from gsconverter_tpu.converter import convert as jax_convert
from gsconverter_tpu.formats import get_handler as jax_handler
from gsconverter_tpu.formats.ply_gs import vertex_array_from_cloud
from gsconverter_tpu.utils import ply as jax_ply
from gsconverter_tpu_torch.converter import convert as torch_convert
from gsconverter_tpu_torch.formats import get_handler as torch_handler
from gsconverter_tpu_torch.utils import ply as torch_ply
from tests.conftest import make_cloud
from tests.torch_port_helpers import (assert_clouds_equal, jax_one_device,  # noqa: F401
                                      to_port)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _write_both(fmt, jcloud, tmp_path, **kw):
    """Both packages write the same host cloud, the residency a cloud has on
    the conversion path (the JAX package's host codec paths)."""
    jcloud = jcloud.to_numpy()
    ext = jax_handler(fmt).extension
    pj, pt = str(tmp_path / f"jax{ext}"), str(tmp_path / f"torch{ext}")
    jax_handler(fmt).write(jcloud, pj, **kw)
    torch_handler(fmt).write(to_port(jcloud), pt, **kw)
    return pj, pt


@pytest.mark.parametrize("fmt,sh_degree,rgb,kw", [
    ("3dgs", 3, False, {}),
    ("3dgs", 1, False, {"crop_sh": True}),
    ("3dgs", 2, True, {}),
    ("cc", 3, True, {}),
    ("cc", 0, False, {}),
    ("splat", 0, True, {}),
    ("splat", 3, False, {}),
])
def test_writes_byte_identical_and_cross_read(fmt, sh_degree, rgb, kw, tmp_path):
    jc = make_cloud(257, sh_degree=sh_degree, rgb=rgb, seed=sh_degree)
    if fmt == "splat" and not rgb:
        from gsconverter_tpu.ops import sh

        jc = sh.add_rgb(jc)
    pj, pt = _write_both(fmt, jc, tmp_path, **kw)
    assert _bytes(pj) == _bytes(pt)
    # each package reads the other's file to the cloud the writer's own
    # package reads back
    assert_clouds_equal(torch_handler(fmt).read(pj), jax_handler(fmt).read(pt))
    assert_clouds_equal(torch_handler(fmt).read(pt), jax_handler(fmt).read(pj))


def test_extras_passthrough_byte_identical(tmp_path):
    import jax.numpy as jnp

    jc = make_cloud(64).replace(
        extras={"my_label": jnp.arange(64, dtype=jnp.float32)})
    pj, pt = _write_both("3dgs", jc, tmp_path)
    assert _bytes(pj) == _bytes(pt)
    back = torch_handler("3dgs").read(pj)
    np.testing.assert_array_equal(back.extras["my_label"], np.arange(64))


def test_empty_and_single_splat(tmp_path):
    for n, jc in ((0, JaxCloud.zeros(0)), (1, make_cloud(1))):
        for fmt in ("3dgs", "splat"):
            if fmt == "splat" and n:
                from gsconverter_tpu.ops import sh

                jc = sh.add_rgb(jc)
            pj, pt = _write_both(fmt, jc, tmp_path)
            assert _bytes(pj) == _bytes(pt)
            assert torch_handler(fmt).read(pj).n == n


def test_ascii_ply_read(tmp_path):
    path = str(tmp_path / "a.ply")
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\nelement vertex 2\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float f_dc_0\nproperty float f_dc_1\nproperty float f_dc_2\n"
            "property float opacity\n"
            "property float scale_0\nproperty float scale_1\nproperty float scale_2\n"
            "property float rot_0\nproperty float rot_1\nproperty float rot_2\nproperty float rot_3\n"
            "end_header\n"
            "1 2 3 0.1 0.2 0.3 0.5 -4 -4 -4 1 0 0 0\n"
            "4 5 6 0.4 0.5 0.6 1.5 -3 -3 -3 0 1 0 0\n"
        )
    d = torch_handler("3dgs").read(path)
    assert d.n == 2
    np.testing.assert_allclose(d.pos[0], [1, 2, 3])
    assert_clouds_equal(d, jax_handler("3dgs").read(path))


def _vertex_names(n_rest):
    return (["x", "y", "z", "nx", "ny", "nz"]
            + [f"f_dc_{i}" for i in range(3)]
            + [f"f_rest_{i}" for i in range(n_rest)]
            + ["opacity", "scale_0", "scale_1", "scale_2",
               "rot_0", "rot_1", "rot_2", "rot_3"])


def test_big_endian_read(tmp_path):
    n = 8
    r = np.random.default_rng(2)
    names = _vertex_names(0)
    arr = np.zeros(n, dtype=[(nm, ">f4") for nm in names])
    for nm in names:
        arr[nm] = r.normal(size=n).astype(np.float32)
    header = ("ply\nformat binary_big_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property float {nm}\n" for nm in names)
              + "end_header\n")
    path = str(tmp_path / "be.ply")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(arr.tobytes())
    d = torch_handler("3dgs").read(path)
    np.testing.assert_array_equal(d.pos[:, 0], arr["x"].astype("<f4"))
    assert_clouds_equal(d, jax_handler("3dgs").read(path))


def test_double_precision_columns(tmp_path):
    n = 64
    r = np.random.default_rng(0)
    names = _vertex_names(9)
    arr = np.zeros(n, dtype=[(nm, "<f8") for nm in names])
    for nm in names:
        arr[nm] = r.normal(size=n)
    path = str(tmp_path / "dbl.ply")
    torch_ply.write(path, [torch_ply.PlyElement("vertex", arr)])
    d = torch_handler("3dgs").read(path)
    assert d.pos.dtype == np.float32 and d.active_sh_degree == 1
    assert_clouds_equal(d, jax_handler("3dgs").read(path))


def test_mixed_width_core_fields(tmp_path):
    n = 32
    r = np.random.default_rng(1)
    dt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("weird_id", "<u2"),
          ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
          ("f_dc_0", "<f4"), ("f_dc_1", "<f4"), ("f_dc_2", "<f4"),
          ("opacity", "<f4"),
          ("scale_0", "<f4"), ("scale_1", "<f4"), ("scale_2", "<f4"),
          ("rot_0", "<f4"), ("rot_1", "<f4"), ("rot_2", "<f4"), ("rot_3", "<f4")]
    arr = np.zeros(n, dtype=dt)
    for nm, t in dt:
        arr[nm] = (r.integers(0, 100, n) if t == "<u2"
                   else r.normal(size=n).astype(np.float32))
    path = str(tmp_path / "mixed.ply")
    jax_ply.write(path, [jax_ply.PlyElement("vertex", arr)])
    d = torch_handler("3dgs").read(path)
    np.testing.assert_array_equal(d.extras["weird_id"], arr["weird_id"])
    assert_clouds_equal(d, jax_handler("3dgs").read(path))


def test_nonstandard_f_rest_count(tmp_path):
    n = 4
    names = _vertex_names(30)
    arr = np.zeros(n, dtype=[(nm, "<f4") for nm in names])
    arr["x"] = np.arange(n)
    arr["f_rest_8"], arr["f_rest_9"], arr["rot_0"] = 0.25, 0.5, 1.0
    path = str(tmp_path / "deg30.ply")
    torch_ply.write(path, [torch_ply.PlyElement("vertex", arr)])
    d = torch_handler("3dgs").read(path)
    assert d.active_sh_degree == 3
    np.testing.assert_allclose(d.sh_rest[:, 0, 8], 0.25)
    assert_clouds_equal(d, jax_handler("3dgs").read(path))


def test_list_property_roundtrip(tmp_path):
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    verts = np.zeros(3, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
    for mod, path in ((jax_ply, pj), (torch_ply, pt)):
        face = mod.PlyElement(
            "face", np.zeros(1, dtype=[("_", "u1")]),
            list_props={"vertex_indices": ("uchar", "int", [np.array([0, 1, 2])])})
        mod.write(path, [mod.PlyElement("vertex", verts), face])
    assert _bytes(pj) == _bytes(pt)
    back = torch_ply.read(pj)
    np.testing.assert_array_equal(back["face"].list_props["vertex_indices"][2][0],
                                  [0, 1, 2])


def test_extra_elements_through_converter(tmp_path, jax_one_device):
    c = make_cloud(50)
    src = str(tmp_path / "s.ply")
    arr = np.zeros(2, dtype=[("fx", "<f4"), ("fy", "<f4")])
    arr["fx"] = [500.0, 600.0]
    verts = vertex_array_from_cloud(c, crop_sh=False, prefix_nonspatial=False)
    jax_ply.write(src, [jax_ply.PlyElement("vertex", verts),
                        jax_ply.PlyElement("intrinsic", arr)])
    for keep in (True, False):
        oj, ot = str(tmp_path / f"j{keep}.ply"), str(tmp_path / f"t{keep}.ply")
        jax_convert(src, oj, "3dgs", maintain_extra_elements=keep,
                    min_opacity=1, force=True)
        torch_convert(src, ot, "3dgs", device="cpu",
                      maintain_extra_elements=keep, min_opacity=1, force=True)
        assert _bytes(oj) == _bytes(ot)
        assert ("intrinsic" in torch_ply.read(ot)) == keep


def test_unported_formats_raise():
    for fmt in ("ksplat", "spz", "sog", "parquet", "compressed_ply"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            torch_handler(fmt)

"""The PyTorch port's main path against the JAX package, on the CPU.

PLY -> SH detect/cap -> bbox -> alpha -> density -> SOR -> one compaction
-> RGB -> .splat / 3DGS PLY.  The port runs with ``device="cpu"``, where
the SOR kernel's wrapper takes its plain PyTorch version; the JAX side runs
SOR through its Pallas kernel in interpret mode.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import gsconverter_tpu
import gsconverter_tpu.ops.sor as jax_sor
from gsconverter_tpu.ops import filters as jfilters
from gsconverter_tpu.ops import sh as jsh
from gsconverter_tpu_torch import convert as torch_convert
from gsconverter_tpu_torch.formats import get_handler as torch_handler
from gsconverter_tpu_torch.ops import filters as tfilters
from gsconverter_tpu_torch.ops import sh as tsh
from gsconverter_tpu_torch.ops import sor as torch_sor
from tests.conftest import make_cloud
from tests.torch_port_helpers import (INNER_FLYERS, StageSpy, flyer_scene_ply,
                                      jax_one_device, to_port)  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BBOX = (-60.0, -60.0, -60.0, 60.0, 60.0, 60.0)


def _multi_blob(n=4000, seed=3):
    """Two dense blobs, a sparse third one and far flyers: a host cloud."""
    r = np.random.default_rng(seed)
    pos = np.concatenate([
        r.normal(0, 1.0, (n // 2, 3)),
        r.normal(0, 0.7, (n // 4, 3)) + [6.0, 0.0, 0.0],
        r.normal(0, 3.0, (n // 4 - 30, 3)) + [0.0, 8.0, 0.0],
        r.uniform(-90, 90, (30, 3)),
    ]).astype(np.float32)
    return make_cloud(n, sh_degree=2, seed=seed).replace(
        pos=jnp.asarray(pos)).to_numpy()


@pytest.mark.parametrize("stage", ["bbox", "alpha", "density", "density_multi"])
def test_filter_masks_identical(stage, jax_one_device):
    jc = _multi_blob()
    tc = to_port(jc)
    run = {
        "bbox": lambda f, c: f.crop_by_bbox(c, (-5, -5, -5, 7, 9, 5)),
        "alpha": lambda f, c: f.alpha_filter(c, 40),
        "density": lambda f, c: f.density_filter(c, sensitivity=0.5),
        "density_multi": lambda f, c: f.density_filter(c, 1.0, 0.2,
                                                       keep_multicluster=True),
    }[stage]
    outj, outt = run(jfilters, jc), run(tfilters, tc)
    assert 0 < outt.n < tc.n
    np.testing.assert_array_equal(outt.pos, np.asarray(outj.pos))
    np.testing.assert_array_equal(outt.opacity, np.asarray(outj.opacity))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_detect_cap_and_rgb_equal(degree):
    jc = make_cloud(300, sh_degree=degree, seed=degree).to_numpy()
    tc = to_port(jc)
    assert tsh.detect_active_degree(tc) == jsh.detect_active_degree(jc) == degree
    for cap in range(degree + 1):
        capt, capj = tsh.cap_degree(tc, cap), jsh.cap_degree(jc, cap)
        assert capt.active_sh_degree == capj.active_sh_degree
        np.testing.assert_array_equal(np.asarray(capt.sh_rest),
                                      np.asarray(capj.sh_rest))
        assert tsh.detect_active_degree(capt) == jsh.detect_active_degree(capj)
    rgbt, rgbj = tsh.add_rgb(tc).rgb, jsh.add_rgb(jc).rgb
    assert rgbt.tobytes() == np.asarray(rgbj).tobytes()
    # the tensor route of the port gives the same bytes
    dev = tc.to_device("cpu")
    assert tsh.detect_active_degree(dev) == degree
    assert tsh.add_rgb(dev).rgb.numpy().tobytes() == rgbt.tobytes()


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def scene(tmp_path_factory):
    return flyer_scene_ply(tmp_path_factory.mktemp("scene") / "scene.ply")


@pytest.mark.parametrize("fmt", ["splat", "3dgs"])
def test_convert_byte_identical_without_sor(fmt, scene, tmp_path, jax_one_device):
    kw = dict(bbox=BBOX, min_opacity=5, density_sensitivity=0.5)
    ext = ".splat" if fmt == "splat" else ".ply"
    oj, ot = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    cj = gsconverter_tpu.convert(scene, oj, fmt, **kw)
    ct = torch_convert(scene, ot, fmt, device="cpu", **kw)
    assert ct.n == cj.n and 2048 < ct.n < 5000
    assert _bytes(oj) == _bytes(ot)


@pytest.mark.parametrize("density", [True, False], ids=["config2", "no_density"])
@pytest.mark.parametrize("fmt", ["splat", "3dgs"])
def test_convert_with_sor_matches_pallas(fmt, density, scene, tmp_path,
                                         monkeypatch, jax_one_device):
    monkeypatch.setattr(jax_sor, "sor_mask",
                        functools.partial(jax_sor.sor_mask, impl="pallas_interpret"))
    sor_j, sor_t = StageSpy(monkeypatch, jfilters), StageSpy(monkeypatch, tfilters)
    kw = dict(bbox=BBOX, min_opacity=5, sor_intensity=4)
    if density:
        kw["density_sensitivity"] = 0.5
    ext = ".splat" if fmt == "splat" else ".ply"
    oj, ot = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    launches = torch_sor.KERNEL_LAUNCHES
    cj = gsconverter_tpu.convert(scene, oj, fmt, **kw)
    ct = torch_convert(scene, ot, fmt, device="cpu", **kw)
    # the CPU run takes the plain version, never the CUDA launch
    assert torch_sor.KERNEL_LAUNCHES == launches
    assert ct.n == cj.n
    # both SOR stages saw the same rows and kept the same number
    assert sor_t.calls == sor_j.calls and len(sor_t.calls) == 1
    (n_in, n_out), = sor_t.calls
    if density:
        # the density filter runs first and takes the inner flyers with it,
        # so SOR finds none left
        assert n_out == n_in and n_in < 5000 - 40 - INNER_FLYERS
    else:
        # the bbox drops the cluster at +80; SOR drops the inner flyers
        assert n_in - n_out == INNER_FLYERS
    assert np.all(np.abs(np.asarray(ct.pos)) < 20)
    # byte-identical: the SOR masks agree on every row
    assert _bytes(oj) == _bytes(ot)


def test_convert_reaches_k1_wrapper_with_kernel_sized_input(scene, tmp_path,
                                                            monkeypatch):
    """The SOR stage of the main path pads to a multiple of 512 and calls
    the K1 wrapper (here on the CPU, where it runs the plain version)."""
    calls = []
    orig = torch_sor._sor_window_loop_kernel

    def spy(spos, k, window, iters):
        calls.append((tuple(spos.shape), k, window, iters))
        return orig(spos, k, window, iters)

    monkeypatch.setattr(torch_sor, "_sor_window_loop_kernel", spy)
    out = str(tmp_path / "o.splat")
    ct = torch_convert(scene, out, "splat", device="cpu", bbox=BBOX,
                       min_opacity=5, density_sensitivity=0.5, sor_intensity=4)
    assert len(calls) == 1
    (n, three), k, window, iters = calls[0]
    assert n % 512 == 0 and n < 8192 and three == 3
    assert (k, window, iters) == (23, 256, 7)
    assert os.path.getsize(out) == 32 * ct.n
    back = torch_handler("splat").read(out)
    assert back.n == ct.n and np.isfinite(back.pos).all()


def test_convert_without_device_needs_a_gpu(scene, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "o.splat")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_convert(scene, out, "splat", sor_intensity=4)
    assert not os.path.exists(out)
    from gsconverter_tpu_torch.main import main

    assert main(["-i", scene, "-o", out, "-f", "splat", "--force"]) == 1
    assert not os.path.exists(out)
    assert main(["-i", scene, "-o", out, "-f", "splat", "--force",
                 "--device", "cpu"]) == 0
    assert os.path.getsize(out) == 32 * 5000


def test_import_loads_no_jax():
    code = ("import sys, gsconverter_tpu_torch, gsconverter_tpu_torch.main, "
            "gsconverter_tpu_torch.ops.sor, gsconverter_tpu_torch.utils.cuda_build, "
            "gsconverter_tpu_torch.ops.compaction, gsconverter_tpu_torch.ops.density, "
            "gsconverter_tpu_torch.utils.transfer, gsconverter_tpu_torch.utils.validate, "
            "gsconverter_tpu_torch.utils.checkpoint\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gsconverter_tpu')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr

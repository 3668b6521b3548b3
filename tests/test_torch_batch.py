"""The port's batch conversion (``gsconverter_tpu_torch.batch``) on the CPU.

One read and filter chain per scene, N format writes: every output must be
byte-identical to a standalone conversion of the same format, and to the
JAX package's ``convert_batch`` (whose SOR runs its Pallas kernel in
interpret mode, as the port's runs K1's plain version).
"""

import functools
import os

import pytest

import gsconverter_tpu.ops.sor as jax_sor
from gsconverter_tpu.batch import convert_batch as jax_convert_batch
from gsconverter_tpu_torch import convert
from gsconverter_tpu_torch.batch import convert_batch
from gsconverter_tpu_torch.formats import get_handler
from gsconverter_tpu_torch.ops import filters as tfilters
from gsconverter_tpu_torch.ops import sor as torch_sor
from tests.conftest import make_cloud
from tests.torch_port_helpers import StageSpy, jax_one_device, to_port  # noqa: F401


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _scene(path, n, degree, seed):
    get_handler("3dgs").write(to_port(make_cloud(n, sh_degree=degree, seed=seed).to_numpy()),
                              str(path))
    return str(path)


def _batched(out_dir, base, fmt):
    return os.path.join(out_dir, f"{base}_{fmt}{get_handler(fmt).extension}")


def test_convert_batch_matches_standalone(tmp_path, monkeypatch):
    """Formats with tighter SH caps than the first one written (caps 0 / 3 /
    2) write what a standalone run writes; the scene's filter chain, K1's
    wrapper included (SOR takes it from 2049 rows on), runs once."""
    src = _scene(tmp_path / "s0.ply", 3000, 2, 9)
    fmts = ["splat", "spz", "ksplat"]
    kw = dict(min_opacity=20, sor_intensity=4.0, force=True, compression_level=1)
    calls = []
    wrapper = torch_sor._sor_window_loop_kernel

    def spy(*args):
        calls.append(args[0].shape[0])
        return wrapper(*args)

    monkeypatch.setattr(torch_sor, "_sor_window_loop_kernel", spy)
    sor_stage = StageSpy(monkeypatch, tfilters)
    done = convert_batch(src, str(tmp_path / "b"), fmts, device="cpu", **kw)
    assert len(calls) == 1 and len(sor_stage.calls) == 1
    assert [d[1] for d in done] == ["spz", "ksplat", "splat"]  # loosest cap first
    for fmt in fmts:
        solo = str(tmp_path / f"solo_{fmt}{get_handler(fmt).extension}")
        convert(src, solo, fmt, device="cpu", **kw)
        assert _bytes(solo) == _bytes(_batched(tmp_path / "b", "s0", fmt)), fmt
    assert len(calls) == 1 + len(fmts)


@pytest.mark.parametrize("deg", [0, 3])
def test_convert_batch_byte_identity_matrix(tmp_path, deg):
    """Degree-0 and degree-3 sources through every codec with SH
    (splat, spz, sog, 3dgs, ksplat, compressed PLY, Parquet)."""
    src = _scene(tmp_path / "s0.ply", 600, deg, 3 + deg)
    fmts = ["splat", "spz", "sog", "3dgs", "ksplat", "compressed_ply", "parquet"]
    kw = dict(min_opacity=10, force=True)
    convert_batch(src, str(tmp_path / "b"), fmts, device="cpu", **kw)
    for fmt in fmts:
        solo = str(tmp_path / f"solo_{fmt}{get_handler(fmt).extension}")
        convert(src, solo, fmt, device="cpu", **kw)
        assert _bytes(solo) == _bytes(_batched(tmp_path / "b", "s0", fmt)), (fmt, deg)


def test_convert_batch_matches_jax_convert_batch(tmp_path, monkeypatch, jax_one_device):
    """Two scenes through the config-2 filter chain to the formats both
    packages write the same bytes for."""
    monkeypatch.setattr(jax_sor, "sor_mask",
                        functools.partial(jax_sor.sor_mask, impl="pallas_interpret"))
    for i in range(2):
        _scene(tmp_path / f"s{i}.ply", 3000, 2, 30 + i)
    fmts = ["3dgs", "splat", "ksplat", "spz", "compressed_ply", "parquet"]
    kw = dict(min_opacity=5, density_sensitivity=0.5, sor_intensity=4,
              bbox=(-60.0, -60.0, -60.0, 60.0, 60.0, 60.0), compression_level=2, force=True)
    dj = jax_convert_batch(str(tmp_path / "s*.ply"), str(tmp_path / "j"), fmts, **kw)
    dt = convert_batch(str(tmp_path / "s*.ply"), str(tmp_path / "t"), fmts, device="cpu", **kw)
    assert [d[:2] for d in dt] == [d[:2] for d in dj] and len(dt) == 12
    for (_, fmt, oj), (_, _, ot) in zip(dj, dt):
        assert _bytes(oj) == _bytes(ot), fmt


def test_convert_batch_job_fallback_when_few_scenes(tmp_path):
    """With fewer scenes than processes each (scene, format) job is a unit,
    so both processes work."""
    _scene(tmp_path / "s0.ply", 200, 1, 1)
    fmts = ["splat", "spz", "ksplat"]
    a = convert_batch(str(tmp_path / "s*.ply"), str(tmp_path / "o"), fmts,
                      process_index=0, process_count=2, device="cpu", force=True)
    b = convert_batch(str(tmp_path / "s*.ply"), str(tmp_path / "o"), fmts,
                      process_index=1, process_count=2, device="cpu", force=True)
    assert len(a) > 0 and len(b) > 0
    assert len(a) + len(b) == 3
    assert not ({x[2] for x in a} & {x[2] for x in b})


def test_convert_batch_matrix(tmp_path):
    """Three scenes to two formats: six files, each read back whole."""
    for i in range(3):
        _scene(tmp_path / f"s{i}.ply", 500, 1, i)
    done = convert_batch(str(tmp_path / "s*.ply"), str(tmp_path / "out"), ["splat", "spz"],
                         device="cpu", force=True)
    assert len(done) == 6
    for _, fmt, out in done:
        assert get_handler(fmt).read(out).n == 500


def test_convert_batch_round_robin(tmp_path):
    """Two processes share the scenes disjointly."""
    for i in range(2):
        _scene(tmp_path / f"s{i}.ply", 300, 0, i)
    args = (str(tmp_path / "s*.ply"), str(tmp_path / "out"), ["splat", "spz"])
    a = convert_batch(*args, process_index=0, process_count=2, device="cpu", force=True)
    b = convert_batch(*args, process_index=1, process_count=2, device="cpu", force=True)
    assert len(a) == 2 and len(b) == 2
    assert not ({x[2] for x in a} & {x[2] for x in b})


def test_convert_batch_rejects_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="Unknown target format"):
        convert_batch([], str(tmp_path / "o"), ["splat", "nope"], device="cpu")

"""The port's checkpoint / resume, validation and transfer helpers against
the JAX package, on the CPU.

Snapshots share the JAX package's file format, so each package loads the
other's; a resumed conversion writes the first run's bytes; deferred and
per-stage compaction agree; ``validate_cloud`` reports what JAX's reports.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsconverter_tpu.utils import checkpoint as jckpt
from gsconverter_tpu.utils.validate import validate_cloud as jvalidate
from gsconverter_tpu_torch import config
from gsconverter_tpu_torch.converter import Converter, convert
from gsconverter_tpu_torch.formats import get_handler
from gsconverter_tpu_torch.utils import checkpoint
from gsconverter_tpu_torch.utils.transfer import cloud_is_host, is_host, to_host, tree_to_host
from gsconverter_tpu_torch.utils.validate import validate_cloud
from tests.conftest import make_cloud
from tests.torch_port_helpers import (StageSpy, assert_clouds_equal,  # noqa: F401
                                      flyer_scene_ply, jax_one_device, to_port)


def _port_cloud(n, degree=3, rgb=False, seed=0):
    return to_port(make_cloud(n, sh_degree=degree, rgb=rgb, seed=seed))


# ------------------------------------------------------------ checkpoint


@pytest.mark.parametrize("residency", ["host", "tensor"])
def test_save_load_roundtrip(residency, tmp_path):
    c = _port_cloud(128, degree=2, rgb=True)
    c = c.replace(extras={"lbl": np.arange(128, dtype=np.float32)})
    if residency == "tensor":
        c = c.device("cpu")
    checkpoint.save(c, str(tmp_path), "after_density")
    d = checkpoint.load(str(tmp_path), "after_density")
    assert d.is_host  # load returns a host cloud, as JAX's does
    assert_clouds_equal(d, c.to_numpy())
    assert d.active_sh_degree == 2


def test_latest_stage(tmp_path):
    stages = ["read", "density", "sor", "write"]
    c = _port_cloud(16)
    assert checkpoint.latest_stage(str(tmp_path), stages) is None
    checkpoint.save(c, str(tmp_path), "read")
    checkpoint.save(c, str(tmp_path), "density")
    assert checkpoint.latest_stage(str(tmp_path), stages) == "density"


def test_jax_snapshot_loads_in_the_port_and_back(tmp_path):
    jc = make_cloud(200, sh_degree=2, rgb=True, seed=3)
    jc = jc.replace(extras={"w": jnp.arange(200, dtype=jnp.float32) * 0.5})
    jckpt.save(jc, str(tmp_path / "jax"), "sor")
    port = checkpoint.load(str(tmp_path / "jax"), "sor")
    assert_clouds_equal(port, jc.to_numpy())
    # a port snapshot (from a tensor cloud) in the JAX package
    checkpoint.save(port.device("cpu"), str(tmp_path / "port"), "alpha")
    back = jckpt.load(str(tmp_path / "port"), "alpha")
    assert_clouds_equal(back, jc.to_numpy())
    for name in ("pos", "sh_rest", "rgb"):
        assert np.asarray(getattr(back, name)).dtype == np.asarray(getattr(jc, name)).dtype


def test_each_rank_writes_its_shard(tmp_path, monkeypatch):
    """Under a mesh every rank holds the whole cloud and rank r writes
    ``shard{r}``, its ``shard_bounds`` rows; rank 0 writes the manifest,
    and ``load`` gives the cloud back in order."""
    a = _port_cloud(31, seed=1)
    monkeypatch.setattr(checkpoint, "_rank_and_size", lambda: (1, 2))
    checkpoint.save(a, str(tmp_path), "sor")
    assert not os.path.exists(tmp_path / "sor" / "manifest.json")
    with np.load(tmp_path / "sor" / "shard1.npz") as z:
        np.testing.assert_array_equal(z["pos"], a.pos[16:])
    monkeypatch.setattr(checkpoint, "_rank_and_size", lambda: (0, 2))
    checkpoint.save(a, str(tmp_path), "sor")
    got = checkpoint.load(str(tmp_path), "sor")
    assert_clouds_equal(got, a)
    assert sorted(os.listdir(tmp_path / "sor")) == ["manifest.json", "shard0.npz", "shard1.npz"]


def test_rank_is_zero_without_a_process_group():
    assert checkpoint._rank_and_size() == (0, 1)


def _config2(tmp_path, n=5000):
    src = flyer_scene_ply(tmp_path / "scene.ply", n=n, seed=7)
    return src, dict(bbox=(-60.0, -60.0, -60.0, 60.0, 60.0, 60.0), min_opacity=5,
                     density_sensitivity=0.5, sor_intensity=4)


def test_pipeline_checkpoints_and_resumes(tmp_path, monkeypatch):
    from gsconverter_tpu_torch.ops import filters

    src, kw = _config2(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    out = str(tmp_path / "o.splat")
    cloud1 = convert(src, out, "splat", device="cpu", checkpoint_dir=ckpt, **kw)
    for stage in ("bbox", "alpha", "density", "sor"):
        assert os.path.exists(os.path.join(ckpt, stage, "manifest.json")), stage

    # a resumed run restores the SOR snapshot and runs no filter again
    spy = StageSpy(monkeypatch, filters)
    out2 = str(tmp_path / "o2.splat")
    conv = Converter(src, out2, "splat", device="cpu")
    cloud2 = conv.run(checkpoint_dir=ckpt, **kw)
    assert spy.calls == [] and "checkpoint_load" in conv.timer.report()
    assert cloud2.n == cloud1.n
    np.testing.assert_array_equal(np.asarray(cloud2.pos), np.asarray(cloud1.pos))
    with open(out, "rb") as f1, open(out2, "rb") as f2:
        assert f1.read() == f2.read()


def test_resume_after_a_middle_stage(tmp_path):
    """A run stopped after density (its SOR snapshot missing) resumes
    there, runs SOR, and writes the uninterrupted run's bytes."""
    src, kw = _config2(tmp_path)
    ckpt = str(tmp_path / "ck")
    full = str(tmp_path / "full.spz")
    convert(src, full, "spz", device="cpu", checkpoint_dir=ckpt, **kw)
    os.remove(os.path.join(ckpt, "sor", "manifest.json"))
    resumed = str(tmp_path / "resumed.spz")
    conv = Converter(src, resumed, "spz", device="cpu")
    conv.run(checkpoint_dir=ckpt, **kw)
    assert "sor" in conv.timer.report() and "density" not in conv.timer.report()
    with open(full, "rb") as f1, open(resumed, "rb") as f2:
        assert f1.read() == f2.read()


def test_deferred_compaction_matches_per_stage(tmp_path):
    src, kw = _config2(tmp_path, n=4000)
    kw = dict(kw, density_sensitivity=0.3)
    fast, slow = str(tmp_path / "fast.splat"), str(tmp_path / "slow.splat")
    convert(src, fast, "splat", device="cpu", **kw)
    convert(src, slow, "splat", device="cpu", checkpoint_dir=str(tmp_path / "ck"), **kw)
    with open(fast, "rb") as f1, open(slow, "rb") as f2:
        assert f1.read() == f2.read()


def test_port_resume_matches_jax_checkpointed_run(tmp_path, jax_one_device):
    """The port's checkpointed conversion and the JAX package's write the
    same .ksplat, and the port resumes from the JAX package's snapshots."""
    from gsconverter_tpu.converter import convert as jconvert

    src, kw = _config2(tmp_path, n=4000)
    kw = dict(kw, compression_level=1)
    jout, tout = str(tmp_path / "jax.ksplat"), str(tmp_path / "port.ksplat")
    jconvert(src, jout, "ksplat", checkpoint_dir=str(tmp_path / "jck"), **kw)
    convert(src, tout, "ksplat", device="cpu", checkpoint_dir=str(tmp_path / "jck"), **kw)
    with open(jout, "rb") as f1, open(tout, "rb") as f2:
        assert f1.read() == f2.read()


def test_debug_validates_each_stage(tmp_path, capsys, monkeypatch):
    c = _port_cloud(500, seed=2)
    pos = c.pos.copy()
    pos[:3] = np.nan
    src = str(tmp_path / "bad.ply")
    get_handler("3dgs").write(c.replace(pos=pos), src)
    monkeypatch.setattr(config, "DEBUG", True)
    convert(src, str(tmp_path / "o.ply"), "3dgs", device="cpu", min_opacity=1)
    out = capsys.readouterr().out
    assert "[validate:alpha] pos: " in out


def test_debug_validation_of_the_deferred_proxy(tmp_path, monkeypatch, jax_one_device):
    """The filters of a host conversion run on a proxy cloud whose quat and
    log-scale have no columns; JAX's validation raises on its empty
    log-scale, the port's skips those leaves."""
    from gsconverter_tpu import config as jconfig
    from gsconverter_tpu.converter import convert as jconvert

    src = str(tmp_path / "s.ply")
    get_handler("3dgs").write(_port_cloud(300, seed=3), src)
    monkeypatch.setattr(config, "DEBUG", True)
    monkeypatch.setattr(jconfig, "DEBUG", True)
    convert(src, str(tmp_path / "o.ply"), "3dgs", device="cpu", min_opacity=1)
    with pytest.raises(ValueError, match="zero-size"):
        jconvert(src, str(tmp_path / "j.ply"), "3dgs", min_opacity=1)


# -------------------------------------------------------------- validate


def _bad_clouds():
    c = make_cloud(400, seed=4).to_numpy()
    pos = np.array(c.pos)
    pos[5] = np.inf
    quat = np.array(c.quat)
    quat[:7] *= 1.5
    ls = np.array(c.log_scale)
    ls[2, 1] = -45.0
    rest = np.array(c.sh_rest)
    rest[9, 0, 0] = np.nan
    return {
        "healthy": c,
        "nonfinite": c.replace(pos=pos, sh_rest=rest),
        "quat": c.replace(quat=quat),
        "scale": c.replace(log_scale=ls),
        "all": c.replace(pos=pos, quat=quat, log_scale=ls, sh_rest=rest),
        "empty": make_cloud(0).to_numpy(),
    }


@pytest.mark.parametrize("kind", ["healthy", "nonfinite", "quat", "scale", "all", "empty"])
def test_validate_cloud_matches_jax(kind, capsys):
    jc = _bad_clouds()[kind]
    want = jvalidate(jc, where="sor")
    port = to_port(jc)
    assert validate_cloud(port, where="sor") == want
    assert validate_cloud(port.device("cpu"), where="sor") == want
    assert (want == []) == (kind in ("healthy", "empty"))


# -------------------------------------------------------------- transfer


def test_to_host_round_trips():
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert is_host(a) and is_host(np.float32(1)) and not is_host(torch.zeros(1))
    assert to_host(a) is a
    t = torch.from_numpy(a).requires_grad_(True) * 1.0
    np.testing.assert_array_equal(to_host(t), a)
    tree = {"a": torch.ones(2, dtype=torch.uint8), "b": [a, None], "c": (torch.arange(3),)}
    got = tree_to_host(tree)
    assert isinstance(got["a"], np.ndarray) and got["a"].dtype == np.uint8
    assert got["b"][0] is a and got["b"][1] is None
    np.testing.assert_array_equal(got["c"][0], np.arange(3))
    # packed u32 words (the codecs' torch branches) come back as numpy uint32
    words = np.array([0, 1, 2**31, 2**32 - 1], np.uint32)
    w = to_host(torch.from_numpy(words.astype(np.int64)).to(torch.uint32))
    assert w.dtype == np.uint32
    np.testing.assert_array_equal(w, words)
    c = _port_cloud(50)
    assert cloud_is_host(c) and not cloud_is_host(c.device("cpu"))
    assert_clouds_equal(c.device("cpu").to_numpy(), c)

"""The port's automatic multi-device dispatch on the CPU: the filters, the
K-Means and the ``Converter`` under a mesh of gloo ranks, against the same
calls with no mesh and against the JAX package on a mesh of as many
devices.  One world a world size runs every scenario for the module
(``tests/torch_dist_helpers.py``); the Converter runs at world size 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gsconverter_tpu_torch.formats import get_handler as tget
from gsconverter_tpu_torch.parallel.io import shard_bounds
from tests.conftest import cpu_devices, make_cloud
from tests.torch_dist_helpers import cloud_leaves, run_world
from tests.torch_port_helpers import to_port

WORLDS = (2, 4)


def _flyer_cloud(n=20000, n_fly=200, seed=3, scatter=False):
    """test_mesh_pipeline.py's scene: a dense blob and flyers, a far blob
    (density-filter bait) or isolated scattered points (SOR outliers)."""
    c = make_cloud(n, sh_degree=1, seed=seed)
    r = np.random.default_rng(seed)
    pos = np.array(c.pos)
    if scatter:
        pos[-n_fly:] = r.uniform(40.0, 200.0, (n_fly, 3)).astype(np.float32) \
            * r.choice([-1.0, 1.0], (n_fly, 3)).astype(np.float32)
    else:
        pos[-n_fly:] = r.normal(0, 1.0, (n_fly, 3)).astype(np.float32) + 60.0
    return c.replace(pos=jnp.asarray(pos))


def jax_mesh(w):
    from gsconverter_tpu.parallel.mesh import make_mesh

    return make_mesh(devices=cpu_devices()[:w])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from gsconverter_tpu.formats import get_handler

    root = tmp_path_factory.mktemp("mesh_pipeline")
    scene = str(root / "scene.ply")
    get_handler("3dgs").write(_flyer_cloud(), scene)
    out = {}
    for w in WORLDS:
        inputs = dict(
            flyers=cloud_leaves(to_port(_flyer_cloud(4096 + 24 + 3, n_fly=24, scatter=True))),
            chunked_x=np.random.default_rng(0).normal(0, 1, (16384, 8)).astype(np.float32),
            scene=scene, converter=w == 2)
        out[w] = run_world("pipeline", w, root, inputs)
    return out


@pytest.mark.parametrize("w", WORLDS)
def test_remove_flyers_mesh_dispatch_matches(worlds, w):
    from gsconverter_tpu.ops import filters as jfilters
    from gsconverter_tpu.parallel.mesh import clear_active_mesh, set_active_mesh

    res = worlds[w]
    n = 4096 + 24 + 3
    for r in range(w):
        pos_m, pos_s, sor_calls = res[r]["flyers"]
        assert sor_calls == 1  # the sharded SOR took the mask
        np.testing.assert_array_equal(pos_m, pos_s)
        assert pos_m.shape[0] < n
    set_active_mesh(jax_mesh(w))
    try:
        out_j = jfilters.remove_flyers(_flyer_cloud(n, n_fly=24, scatter=True), intensity=5)
    finally:
        clear_active_mesh()
    # test_mesh_pipeline.py's bar for the mesh against one device
    assert abs(out_j.n - res[0]["flyers"][0].shape[0]) <= int(0.01 * n)


@pytest.mark.parametrize("w", WORLDS)
def test_kmeans_chunked_mesh_dispatch(worlds, w):
    res = worlds[w]
    for r in range(w):
        c, lab, c1, lab1, calls = res[r]["chunked"]
        assert calls == 1
        np.testing.assert_array_equal(c, c1)
        np.testing.assert_array_equal(lab, lab1)
        # 3 chunks do not split over the ranks: the single-device path
        c, lab, c1, lab1, calls = res[r]["chunked_declined"]
        assert calls == 0
        np.testing.assert_array_equal(c, c1)
        np.testing.assert_array_equal(lab, lab1)
        assert res[r]["dispatch"] == [True, True, True, True]


def test_converter_writes_splat_and_sog_once_byte_identical(worlds):
    res = worlds[2]
    for label in ("splat", "sog"):
        mesh_digest, single_digest, _ = res[0][label]
        assert mesh_digest == single_digest, label
        for r in range(2):
            assert res[r][f"{label}_calls"]["sor"] == 1  # sharded SOR on every rank
    # written once, by rank 0: rank 1 writes no .splat, and joins the
    # .sog writer's palette fit without opening the file
    assert res[0]["splat_calls"]["writes"] == ["splat"]
    assert res[1]["splat_calls"]["writes"] == []
    assert res[0]["sog_calls"]["writes"] == res[1]["sog_calls"]["writes"] == ["sog"]
    assert res[0]["sog_calls"]["bundles"] == 1 and res[1]["sog_calls"]["bundles"] == 0
    # the kept splats' .sog has 19 palette chunks: they do not split over
    # two ranks, so both fit on their own
    assert res[0]["sog_calls"]["chunked"] == 0


def test_converter_splat_agrees_with_jax_mesh(worlds, tmp_path):
    from gsconverter_tpu.converter import convert as jconvert
    from gsconverter_tpu.formats import get_handler as jget
    from gsconverter_tpu.parallel.mesh import clear_active_mesh, set_active_mesh

    src = tmp_path / "scene.ply"
    jget("3dgs").write(_flyer_cloud(), str(src))
    set_active_mesh(jax_mesh(2))
    try:
        jconvert(str(src), str(tmp_path / "jax.splat"), "splat", sor_intensity=5,
                 density_sensitivity=0.5)
    finally:
        clear_active_mesh()
    port = tget("splat").read(worlds[2][0]["splat"][2])
    ref = tget("splat").read(str(tmp_path / "jax.splat"))
    # test_mesh_pipeline.py's bar: flyers gone, keep-sets within 1%
    assert port.n < 20000 and float(np.max(port.pos[:, 0])) < 30.0
    assert abs(port.n - ref.n) <= int(0.01 * 20000)


def test_converter_checkpoint_and_resume_under_mesh(worlds):
    res = worlds[2]
    r0 = res[0]
    man = r0["manifest"]
    assert man["shards"] == 2 and man["stage"] == "sor"
    # rank r snapshots its shard_bounds rows; together they hold n rows
    assert r0["shard_rows"] == [hi - lo for lo, hi in
                                (shard_bounds(man["n"], s, 2) for s in range(2))]
    assert sum(r0["shard_rows"]) == man["n"]
    # the run and its resume write the one-process .splat's bytes
    assert r0["ckpt"] == r0["splat"][1]
    assert all(res[r]["resume_sor_calls"] == 0 for r in range(2))


def test_cli_overwrite_prompt_runs_on_rank0_alone(worlds):
    """Under a mesh of two ranks, only rank 0 asks; every rank takes its
    answer (no answer, an EOF, cancels) and returns the same code; the
    source and target info print once."""
    res = worlds[2]
    for answer, converted in (("n", False), ("y", True), ("eof", False)):
        r0, r1 = res[0][f"cli_{answer}"], res[1][f"cli_{answer}"]
        assert r0["prompts"] == ["Overwrite? [y/N]: "] and r1["prompts"] == [], answer
        assert r0["rc"] == r1["rc"] == 0, answer
        assert (r0["size"] > 0) == converted and r1["size"] == r0["size"], answer
        assert (r0["source_info"], r1["source_info"]) == ((1, 0) if converted else (0, 0))
        assert (r0["target_info"], r1["target_info"]) == ((1, 0) if converted else (0, 0))

"""The port's multi-device layer (``gsconverter_tpu_torch.parallel``) on the
CPU, against the single-device port and the JAX package.

One gloo world of W processes a world size (``tests/torch_dist_helpers.py``)
runs every scenario once for the module; the tests read its results.  The
JAX side runs here, on a W-device slice of the virtual CPU mesh.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsconverter_tpu.ops import kmeans as jkm
from gsconverter_tpu.ops.padding import PAD_POS, next_pow2
from gsconverter_tpu_torch.ops import sor as tsor
from gsconverter_tpu_torch.parallel.io import shard_bounds
from gsconverter_tpu_torch.parallel.sharding import pad_cloud
from tests.conftest import cpu_devices, make_cloud
from tests.torch_dist_helpers import cloud_leaves, run_world
from tests.torch_port_helpers import to_port

WORLDS = (2, 4)
CHUNKED_16K = dict(n=16384, d=8, chunks=8, k=32, iters=5, seed=0)
KMEANS_INIT = dict(n=6000, d=8, k=16, iters=10, seed=0)
#: JAX's single-device SOR masks of a scene by route, formed once a module
JAX_SOR_ROUTES = {}


def jax_mesh(w):
    from gsconverter_tpu.parallel.mesh import make_mesh

    return make_mesh(devices=cpu_devices()[:w])


def parallel_scene():
    """test_parallel.py's scene: a dense blob and 24 flyers, 4024 points."""
    r = np.random.default_rng(1)
    dense = r.normal(0, 1.0, (4000, 3)).astype(np.float32)
    flyers = r.normal(0, 1.0, (24, 3)).astype(np.float32) + 100.0
    return np.concatenate([dense, flyers])


def scattered_flyer_scene(n=4096 + 24 + 3, n_fly=24, seed=3):
    """test_mesh_pipeline.py's isolated scattered flyers (odd N)."""
    c = make_cloud(n, sh_degree=1, seed=seed)
    r = np.random.default_rng(seed)
    pos = np.array(c.pos)
    pos[-n_fly:] = r.uniform(40.0, 200.0, (n_fly, 3)).astype(np.float32) \
        * r.choice([-1.0, 1.0], (n_fly, 3)).astype(np.float32)
    return pos


def chunked_jax_inits(x, chunks, k, seed):
    """JAX's k-means++ init of each chunk as ``kmeans_chunked`` pads them."""
    n, d = x.shape
    chunk = next_pow2(-(-n // chunks), floor=max(256, k))
    xp = np.full((chunk * chunks, d), PAD_POS, np.float32)
    xp[:n] = x
    out = []
    for i in range(chunks):
        valid = i * chunk + np.arange(chunk) < n
        out.append(np.asarray(jkm.init_centroids(
            jnp.asarray(xp[i * chunk:(i + 1) * chunk]), k,
            jax.random.fold_in(jax.random.PRNGKey(seed), i), valid=jnp.asarray(valid))))
    return np.stack(out)


def kmeans_pool_jax_init(x, k, seed, w):
    """JAX's ``sharded_kmeans`` init for ``kmeans(x)`` on a W-device mesh:
    k-means++ on the strided pool, its padding rows replaced by the first
    valid one (JAX distributed.py:182-211)."""
    n = x.shape[0]
    p = next_pow2(n)
    xp = np.full((p, x.shape[1]), PAD_POS, np.float32)
    xp[:n] = x
    n_local = p // w
    sub = min(8192, n_local)
    stride = max(1, n_local // sub)
    idx = np.concatenate([s * n_local + np.arange(0, sub * stride, stride)
                          for s in range(w)])
    pool, pvalid = xp[idx], idx < n
    pool[~pvalid] = pool[np.argmax(pvalid)]
    return np.asarray(jkm.init_centroids(jnp.asarray(pool), k, jax.random.PRNGKey(seed)))


def kmeans_inputs(seed, n, d):
    return np.random.default_rng(seed).normal(0, 1, (n, d)).astype(np.float32)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request, tmp_path_factory):
    w = request.param
    k5, sigma5 = tsor.intensity_to_params(5)
    x16 = kmeans_inputs(0, CHUNKED_16K["n"], CHUNKED_16K["d"])
    xkm = kmeans_inputs(4, KMEANS_INIT["n"], KMEANS_INIT["d"])
    r = np.random.default_rng(0)
    centers = np.array([[0, 0], [20, 0], [0, 20], [20, 20]], np.float32)
    xq = np.concatenate([r.normal(0, 0.3, (512, 2)).astype(np.float32) + t
                         for t in centers])
    inputs = dict(
        cloud=cloud_leaves(to_port(make_cloud(1000))),
        # (name, positions, k, sigma, the halo JAX's sharded_sor_mask is given)
        sor=[("parallel", parallel_scene(), 15, 2.0, 256),
             ("flyers", scattered_flyer_scene(), k5, sigma5, 4096)],
        chunked=[("16k", x16, CHUNKED_16K["chunks"], CHUNKED_16K["k"],
                  CHUNKED_16K["iters"], CHUNKED_16K["seed"],
                  chunked_jax_inits(x16, CHUNKED_16K["chunks"], CHUNKED_16K["k"],
                                    CHUNKED_16K["seed"])),
                 # 1,100 rows over 4 chunks of 512: chunk 3 padding only
                 ("trailing", kmeans_inputs(6, 1100, 3), 4, 16, 3, 1, None)],
        kmeans_quality=(xq, 4),
        kmeans_jax_init=(xkm, KMEANS_INIT["k"], KMEANS_INIT["iters"], KMEANS_INIT["seed"],
                         kmeans_pool_jax_init(xkm, KMEANS_INIT["k"], KMEANS_INIT["seed"], w)),
        ply_cloud=cloud_leaves(to_port(make_cloud(1003, sh_degree=3))),
        splat_cloud=cloud_leaves(to_port(make_cloud(1001, sh_degree=0, rgb=True))),
    )
    return w, inputs, run_world("parallel", w, tmp_path_factory.mktemp("world"), inputs)


def test_shard_bounds_and_pad_cloud_match_jax():
    from gsconverter_tpu.parallel import io as jio
    from gsconverter_tpu.parallel.sharding import pad_cloud as jpad

    for n in (0, 1, 10, 1003):
        for s in (1, 2, 3, 4, 8):
            assert [shard_bounds(n, i, s) for i in range(s)] == \
                [jio.shard_bounds(n, i, s) for i in range(s)]
    c = make_cloud(1001, rgb=True)
    padded, valid_n = pad_cloud(to_port(c), 8)
    jp, jn = jpad(c, 8)
    assert valid_n == jn == 1001 and padded.n == 1008
    for name in ("pos", "sh_dc", "sh_rest", "opacity", "log_scale", "quat", "normal", "rgb"):
        np.testing.assert_array_equal(getattr(padded, name), np.asarray(getattr(jp, name)),
                                      name)
    # the tensor branch pads alike
    tpad, _ = pad_cloud(to_port(c).device("cpu"), 8)
    np.testing.assert_array_equal(tpad.pos.numpy(), padded.pos)
    np.testing.assert_array_equal(tpad.quat.numpy(), padded.quat)


def test_shard_cloud_rows_are_jax_device_shards(world):
    from gsconverter_tpu.parallel.sharding import shard_cloud as jshard

    w, _, res = world
    sharded, valid_n = jshard(make_cloud(1000), jax_mesh(w))
    for name in ("pos", "sh_dc", "sh_rest", "opacity", "log_scale", "quat", "normal"):
        shards = sorted(getattr(sharded, name).addressable_shards,
                        key=lambda s: s.index[0].start)
        assert len(shards) == w
        for r in range(w):
            np.testing.assert_array_equal(res[r]["shard"][name], np.asarray(shards[r].data),
                                          f"{name} rank {r}")
    assert all(res[r]["shard_valid_n"] == valid_n == 1000 for r in range(w))
    # place_cloud: GSPMD's ceil-sized split, unpadded
    per = -(-1000 // w)
    pos = np.asarray(make_cloud(1000).pos)
    for r in range(w):
        np.testing.assert_array_equal(res[r]["place_pos"], pos[r * per:(r + 1) * per])


@pytest.mark.parametrize("scene", ["parallel", "flyers"])
def test_sharded_sor_mask_equals_single_device(world, scene):
    w, inputs, res = world
    pos = dict((s[0], s[1]) for s in inputs["sor"])[scene]
    for r in range(w):
        mask = res[r][f"sor_{scene}"]
        assert mask.shape == (pos.shape[0],)
        np.testing.assert_array_equal(mask, res[r][f"sor_{scene}_single"])
        np.testing.assert_array_equal(mask, res[0][f"sor_{scene}"])
    # and the single-device port in this process
    name, _, k, sigma, _ = next(s for s in inputs["sor"] if s[0] == scene)
    # each pass sends both ring neighbours the window's rows rounded up to
    # a block (at most a slab), 3 f32 each
    n = pos.shape[0]
    passes, window, _ = tsor.window_settings(sigma, min(k, tsor.MAX_K))
    _, _, block = tsor.window_route(n, window)
    per = -(-n // (w * block)) * block
    halo = min(-(-window // block) * block, per)
    for r in range(w):
        assert res[r][f"sor_{scene}_halo_bytes"] == passes * 2 * halo * 3 * 4
    np.testing.assert_array_equal(res[0][f"sor_{scene}"],
                                  tsor.sor_mask(torch.from_numpy(pos), k, sigma).numpy())


@pytest.mark.parametrize("scene", ["parallel", "flyers"])
def test_sharded_sor_mask_agrees_with_jax(world, scene):
    """The port's route from the 4096 bucket up is K1's bisection; the JAX
    mesh's route on the CPU is its exact top-k window loop (XLA), where the
    JAX package's single device takes the Pallas bisection on its kernel
    route.  So the port's sharded mask equals JAX's bisection on every row,
    JAX's sharded mask equals its XLA route, and the two sharded masks
    agree on every row where JAX's own two routes agree."""
    from gsconverter_tpu.ops import sor as jsor
    from gsconverter_tpu.parallel.distributed import sharded_sor_mask as jsharded

    w, inputs, res = world
    _, pos, k, sigma, halo = next(s for s in inputs["sor"] if s[0] == scene)
    mj = np.asarray(jsharded(jnp.asarray(pos), jax_mesh(w), k=k, sigma=sigma, halo=halo))
    if scene not in JAX_SOR_ROUTES:
        JAX_SOR_ROUTES[scene] = [
            np.asarray(jsor.sor_mask(jnp.asarray(pos), k, sigma, impl=impl))
            for impl in ("pallas_interpret", "xla")]
    jp, jx = JAX_SOR_ROUTES[scene]
    mt = res[0][f"sor_{scene}"]
    np.testing.assert_array_equal(mt, jp)
    np.testing.assert_array_equal(mj, jx)
    same = jp == jx
    np.testing.assert_array_equal(mt[same], mj[same])
    assert (mt == mj).mean() >= min(0.999, same.mean())
    if scene == "parallel":
        assert mt[4000:].mean() < 0.2 and mj[4000:].mean() < 0.2
    else:
        assert mt[-24:].mean() < 0.5 and mj[-24:].mean() < 0.5


@pytest.mark.parametrize("case", ["16k", "trailing"])
def test_sharded_kmeans_chunked_bit_identical(world, case):
    w, inputs, res = world
    for r in range(w):
        c, lab, c1, lab1 = res[r][f"chunked_{case}"]
        np.testing.assert_array_equal(c, c1)
        np.testing.assert_array_equal(lab, lab1)
        np.testing.assert_array_equal(c, res[0][f"chunked_{case}"][2])
    _, x, chunks, k, iters, seed, _ = next(s for s in inputs["chunked"] if s[0] == case)
    c = res[0][f"chunked_{case}"][0]
    if case == "trailing":
        # the padding-only chunks keep PAD_POS centroids, as on one device
        assert (c[3 * k:] == np.float32(PAD_POS)).all() and np.isfinite(c).all()
        assert res[0][f"chunked_{case}"][1].max() < 3 * k


def test_sharded_kmeans_chunked_matches_jax_with_its_init(world):
    from gsconverter_tpu.parallel.mesh import clear_active_mesh, set_active_mesh

    w, inputs, res = world
    _, x, chunks, k, iters, seed, _ = inputs["chunked"][0]
    set_active_mesh(jax_mesh(w))
    try:
        cj, lj = jkm.kmeans_chunked(x, chunks, k, max_iter=iters, seed=seed)
    finally:
        clear_active_mesh()
    cj, lj = np.asarray(cj), np.asarray(lj)
    cp, lp = res[0]["chunked_16k_jax_init"]
    # test_torch_kmeans.py's bar for kmeans_chunked against JAX
    assert (lj == lp).mean() >= 0.999
    same = np.array([np.array_equal(lj == j, lp == j) for j in range(chunks * k)])
    assert same.mean() > 0.9
    np.testing.assert_allclose(cp[same], cj[same], rtol=1e-4, atol=1e-4)


def test_sharded_kmeans_quality(world):
    w, _, res = world
    centers = np.array([[0, 0], [20, 0], [0, 20], [20, 20]], np.float32)
    for r in range(w):
        c, labels = res[r]["kmeans_quality"]
        for t in centers:
            assert np.min(np.linalg.norm(c - t, axis=1)) < 0.3
        assert labels.shape == (2048,)
        np.testing.assert_array_equal(c, res[0]["kmeans_quality"][0])


def test_sharded_kmeans_matches_jax_with_its_init(world):
    from gsconverter_tpu.parallel.mesh import clear_active_mesh, set_active_mesh

    w, inputs, res = world
    x, k, iters, seed, _ = inputs["kmeans_jax_init"]
    set_active_mesh(jax_mesh(w))
    try:
        cj, lj = jkm.kmeans(x, k, max_iter=iters, seed=seed)
    finally:
        clear_active_mesh()
    cj, lj = np.asarray(cj), np.asarray(lj)
    p = next_pow2(x.shape[0])
    for r in range(w):
        cp, lp, pools = res[r]["kmeans_jax_init"]
        # kmeans took the sharded path: one init, on the gathered pool
        assert pools == [(w * min(8192, p // w), x.shape[1])]
        assert lp.shape == (x.shape[0],)
        np.testing.assert_allclose(cp, cj, rtol=0, atol=1e-4 * np.abs(x).max())
        assert (lp == lj).mean() >= 0.999


def test_strided_ply_write_is_byte_identical_and_truncates(world, tmp_path):
    from gsconverter_tpu.formats import get_handler as jget

    w, inputs, res = world
    r0 = res[0]
    assert r0["ply_strided"] == r0["ply_single"]
    # a longer stale file at the path ends at the right size (the JAX
    # package's write leaves its trailing bytes)
    assert r0["ply_stale"] == r0["ply_single"]
    assert r0["ply_stale_size"] == r0["ply_single_size"]
    assert all(res[r]["strided_mismatch_raised"] for r in range(w))
    # the single write is the JAX package's
    path = tmp_path / "jax.ply"
    jget("3dgs").write(make_cloud(1003, sh_degree=3), str(path))
    assert hashlib.sha256(path.read_bytes()).hexdigest() == r0["ply_single"]
    pos = np.concatenate([res[r]["read_sharded_pos"] for r in range(w)])
    np.testing.assert_array_equal(pos, inputs["ply_cloud"]["pos"])
    for r in range(w):
        lo, hi = shard_bounds(1003, r, w)
        assert res[r]["read_sharded_pos"].shape[0] == hi - lo


def test_gather_and_write(world):
    w, _, res = world
    r0 = res[0]
    # .ply from read shards: the strided write, no writer call
    assert r0["gathered_ply"] == r0["ply_single"]
    # .splat: gathered to rank 0, which alone writes
    assert r0["gathered_splat"] == r0["single_splat"]
    assert r0["gather_writes"] == ["gathered.splat"]
    assert all(res[r]["gather_writes"] == [] for r in range(1, w))

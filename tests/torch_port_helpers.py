"""Shared pieces of the tests that hold ``gsconverter_tpu_torch`` against
``gsconverter_tpu`` on the CPU."""

import numpy as np
import pytest

from gsconverter_tpu_torch.cloud import SplatCloud as TorchCloud


@pytest.fixture
def jax_one_device():
    """Pin the JAX pipeline to one device for the test.

    The test process has eight virtual CPU devices, over which the JAX
    converter would shard the cloud; the port has no mesh, and the
    comparison is with the JAX package's single-device path.
    """
    from gsconverter_tpu.parallel.mesh import clear_active_mesh, set_active_mesh

    set_active_mesh(None)
    yield
    clear_active_mesh()


def jax_chunk_init(seed):
    """A stand-in for the port's ``ops.kmeans.init_centroids`` that returns
    the JAX package's k-means++ init of each chunk, drawn from the key the
    JAX ``kmeans_chunked`` gives chunk i: ``fold_in(PRNGKey(seed), i)``."""
    import jax
    import jax.numpy as jnp
    import torch

    from gsconverter_tpu.ops import kmeans as jkm

    def init(x, k, seed_, valid=None, n_valid=None):
        assert seed_ == seed and x.dim() == 3
        out = [np.asarray(jkm.init_centroids(
            jnp.asarray(x[i].numpy()), k,
            jax.random.fold_in(jax.random.PRNGKey(seed), i),
            valid=jnp.asarray(valid[i].numpy()))) for i in range(x.shape[0])]
        return torch.from_numpy(np.stack(out))

    return init


def to_port(jax_cloud) -> TorchCloud:
    """The JAX package's cloud carried across as the port's host cloud."""
    return TorchCloud.from_numpy(jax_cloud.to_numpy())


class StageSpy:
    """Counts rows into and out of a filter module's ``remove_flyers`` (the
    SOR stage) while patched in with ``monkeypatch``."""

    def __init__(self, monkeypatch, filters_module):
        self.calls = []
        orig = filters_module.remove_flyers

        def spy(cloud, *args, **kwargs):
            out = orig(cloud, *args, **kwargs)
            self.calls.append((cloud.n, out.n))
            return out

        monkeypatch.setattr(filters_module, "remove_flyers", spy)


def assert_clouds_equal(a, b):
    """Leaf-by-leaf equality of two clouds (either package)."""
    for name in ("pos", "sh_dc", "sh_rest", "opacity", "log_scale", "quat",
                 "normal"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), name)
    assert (a.rgb is None) == (b.rgb is None)
    if a.rgb is not None:
        np.testing.assert_array_equal(np.asarray(a.rgb), np.asarray(b.rgb))
    assert sorted(a.extras) == sorted(b.extras)
    for k in a.extras:
        np.testing.assert_array_equal(np.asarray(a.extras[k]),
                                      np.asarray(b.extras[k]), k)
    assert a.active_sh_degree == b.active_sh_degree


#: isolated flyers inside the bbox of the scene below, 25-45 from its blob
INNER_FLYERS = 8


def flyer_scene_ply(path, n=5000, seed=7):
    """Mint a 3DGS PLY: a dense N(0, 1.2) blob, INNER_FLYERS isolated flyers
    inside the +-60 bbox, a far flyer cluster at +80 outside it (the last 40
    rows) and SH degree 2, written by the JAX package."""
    import jax.numpy as jnp

    from gsconverter_tpu.cloud import SplatCloud
    from gsconverter_tpu.formats import get_handler

    r = np.random.default_rng(seed)
    u = r.normal(size=(INNER_FLYERS, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = np.concatenate([r.normal(0, 1.2, (n - 40 - INNER_FLYERS, 3)),
                          u * r.uniform(25.0, 45.0, (INNER_FLYERS, 1)),
                          r.normal(0, 0.3, (40, 3)) + 80.0]).astype(np.float32)
    quat = r.normal(0, 1, (n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    rest = np.zeros((n, 3, 15), np.float32)
    rest[:, :, :8] = r.normal(0, 0.1, (n, 3, 8))
    cloud = SplatCloud(
        pos=jnp.asarray(pos),
        sh_dc=jnp.asarray(r.normal(0, 0.5, (n, 3)).astype(np.float32)),
        sh_rest=jnp.asarray(rest),
        opacity=jnp.asarray(r.normal(1, 2, (n,)).astype(np.float32)),
        log_scale=jnp.asarray(r.normal(-4, 0.5, (n, 3)).astype(np.float32)),
        quat=jnp.asarray(quat),
        normal=jnp.zeros((n, 3), jnp.float32),
        active_sh_degree=2,
    )
    get_handler("3dgs").write(cloud, str(path))
    return str(path)


def to_port_camera(jax_cam):
    """The JAX package's camera carried across as the port's (CPU)."""
    from gsconverter_tpu_torch.render.camera import Camera

    return Camera.from_numpy(np.asarray(jax_cam.world_to_cam), np.asarray(jax_cam.fx),
                             np.asarray(jax_cam.fy), np.asarray(jax_cam.cx),
                             np.asarray(jax_cam.cy), jax_cam.width, jax_cam.height)


def clamp_edge_windows():
    """Compositing windows [C=3, M=16] (numpy f32: geo [C, M, 8], alpha
    [C, M], origin [C, 2], counts [C] int32) whose pairs sit on the edges
    the backward must keep:
      tile 0: a splat 2^-20 px off a pixel center under conic 8192, so
        power = -2^-28 lies in (-3e-8, 0): gauss rounds to 1, yet
        d_power = d_gauss * gauss is not 0;
      tile 1: alpha 0.99 centered on a pixel: raw is exactly 0.99 there
        (not live), below it on its neighbours;
      tile 2: alpha f32(1/255) centered on a pixel: a is exactly 1/255
        there (live), 0 on its neighbours.
    Every tile also holds ordinary splats before and after its edge splat,
    all origins at 0 (pixel centers 0.5 ... 15.5)."""
    r = np.random.default_rng(13)
    c_sz, m = 3, 16
    mean = r.uniform(0.0, 16.0, (c_sz, m, 2))
    sig = r.uniform(1.0, 4.0, (c_sz, m))
    conic = np.stack([1 / sig ** 2, np.zeros_like(sig), 1 / sig ** 2], -1)
    color = r.uniform(0, 1, (c_sz, m, 3))
    alpha = r.uniform(0.05, 0.5, (c_sz, m))
    geo = np.concatenate([mean, conic, color], -1).astype(np.float32)
    alpha = alpha.astype(np.float32)
    center = np.float32(8.5)
    geo[0, 5, 0:2] = [center - np.float32(2.0 ** -20), center]
    geo[0, 5, 2:5] = [8192.0, 0.0, 8192.0]
    alpha[0, 5] = 0.5
    geo[1, 6, 0:5] = [center, center, 0.5, 0.0, 0.5]
    alpha[1, 6] = np.float32(0.99)
    geo[2, 7, 0:5] = [center, center, 0.5, 0.0, 0.5]
    alpha[2, 7] = np.float32(1.0 / 255.0)
    origin = np.zeros((c_sz, 2), np.float32)
    counts = np.full(c_sz, m, np.int32)
    return geo, alpha, origin, counts

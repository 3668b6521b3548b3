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

"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here needs a CUDA card and skips without one.  The module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; there, skip the JAX-importing ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gsconverter_tpu_torch import convert
from gsconverter_tpu_torch.cloud import SplatCloud
from gsconverter_tpu_torch.formats import get_handler
from gsconverter_tpu_torch.ops import sor
from gsconverter_tpu_torch.ops.padding import PAD_POS, pad_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K1 (csrc/sor_window.cu) has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flyer_scene(n=3000, seed=7):
    """Dense blob plus a far flyer cluster (the last 64 rows)."""
    r = np.random.default_rng(seed)
    return np.concatenate([r.normal(0, 1.0, (n - 64, 3)),
                           r.normal(0, 1.0, (64, 3)) + 30.0]).astype(np.float32)


def _sorted_padded(pos, device, size=4096):
    """The first pass's Morton-sorted input, pad rows at PAD_POS."""
    posp = pad_rows(torch.from_numpy(pos).to(device), size, PAD_POS)
    valid = torch.arange(size, device=device) < pos.shape[0]
    key = sor._morton_key(posp, valid, None, (0.0, 0.0, 0.0))
    return posp[torch.sort(key, stable=True).indices].contiguous()


@pytest.mark.parametrize("k,window,iters", [(25, 512, 10), (23, 256, 7), (50, 128, 7)])
def test_kernel_matches_plain_version(card, k, window, iters):
    spos = _sorted_padded(_flyer_scene(), card)
    launches = sor.KERNEL_LAUNCHES
    md_k = sor._sor_window_loop_kernel(spos, k, window, iters)
    torch.cuda.synchronize()
    assert sor.KERNEL_LAUNCHES == launches + 1
    md_p = sor._sor_window_loop_ref(spos, k, window, iters)
    real = spos[:, 0] < sor._D_VALID_MAX
    assert int(real.sum()) == 3000
    rel = ((md_k - md_p).abs() / md_p.clamp_min(1e-12))[real]
    # identical distances and bisection steps; only the f32 sums may be
    # taken in another order
    assert float(rel.max()) <= 1e-5, float(rel.max())
    assert bool(torch.isfinite(md_k[real]).all())


def test_kernel_rejects_what_it_does_not_take(card):
    with pytest.raises(ValueError, match="contiguous"):
        sor._sor_window_loop_kernel(torch.zeros(3, 1024, device=card).T, 25, 256, 7)
    with pytest.raises(ValueError, match="multiple of 512"):
        sor._sor_window_loop_kernel(torch.zeros(1000, 3, device=card), 25, 256, 7)


@pytest.mark.parametrize("k,sigma,flyers_go", [(23, 14.33, False), (25, 2.0, True)])
def test_sor_mask_on_card_matches_cpu(card, k, sigma, flyers_go):
    pos = _flyer_scene()
    launches = sor.KERNEL_LAUNCHES
    m_gpu = sor.sor_mask(torch.from_numpy(pos).to(card), k, sigma)
    assert sor.KERNEL_LAUNCHES > launches
    m_cpu = sor.sor_mask(torch.from_numpy(pos), k, sigma)
    assert m_gpu.device.type == "cuda"
    assert float((m_gpu.cpu() == m_cpu).float().mean()) >= 0.999
    # the flyer cluster is 64 points strong: only the tight sigma drops it
    assert (float(m_gpu[-64:].float().mean()) < 0.1) == flyers_go


def test_convert_on_card_matches_cpu(card, tmp_path):
    r = np.random.default_rng(3)
    n = 6000
    pos = np.concatenate([r.normal(0, 1.2, (n - 40, 3)),
                          r.uniform(-40.0, 40.0, (40, 3))]).astype(np.float32)
    quat = r.normal(0, 1, (n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    cloud = SplatCloud(
        pos=pos, sh_dc=r.normal(0, 0.5, (n, 3)).astype(np.float32),
        sh_rest=np.zeros((n, 3, 15), np.float32),
        opacity=r.normal(1, 2, (n,)).astype(np.float32),
        log_scale=r.normal(-4, 0.5, (n, 3)).astype(np.float32),
        quat=quat, normal=np.zeros((n, 3), np.float32), active_sh_degree=0)
    src = str(tmp_path / "scene.ply")
    get_handler("3dgs").write(cloud, src)
    out = {}
    for dev in ("cuda", "cpu"):
        path = str(tmp_path / f"{dev}.splat")
        launches = sor.KERNEL_LAUNCHES
        kept = convert(src, path, "splat", device=dev, min_opacity=5,
                       sor_intensity=10).n
        out[dev] = (kept, open(path, "rb").read(), sor.KERNEL_LAUNCHES - launches)
    assert out["cuda"][2] == 1 and out["cpu"][2] == 0
    assert out["cuda"][0] < n - 30  # the scattered flyers are gone
    assert out["cuda"][:2] == out["cpu"][:2]

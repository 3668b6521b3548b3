"""gsconverter_tpu_torch — the Gaussian-splat converter on PyTorch and CUDA.

The port of ``gsconverter_tpu`` to an NVIDIA Hopper card: the same
canonical SoA splat cloud, codecs and filter chain, with the statistical
outlier filter's window search (``csrc/sor_window.cu``), the K-Means
behind the SOG palette (``csrc/kmeans.cu``, ``csrc/kmeans_update.cu``)
and the differentiable rasterizer's tile compositing and its backward
(``csrc/composite.cu``, used by ``render``) as hand-written CUDA kernels.
Entry points run their device stages on the card unless the caller passes
``device="cpu"``.
"""

from .cloud import SH_C0, SplatCloud
from .config import ConvertOptions
from .converter import Converter, convert

__version__ = "0.1.0"

__all__ = [
    "SplatCloud",
    "SH_C0",
    "Converter",
    "convert",
    "ConvertOptions",
    "__version__",
]

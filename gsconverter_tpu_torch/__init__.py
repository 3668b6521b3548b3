"""gsconverter_tpu_torch — the Gaussian-splat converter on PyTorch and CUDA.

The port of ``gsconverter_tpu`` to an NVIDIA Hopper card: the same
canonical SoA splat cloud, codecs and filter chain, with the statistical
outlier filter's window search as a hand-written CUDA kernel
(``csrc/sor_window.cu``).  Entry points run their device stages on the card
unless the caller passes ``device="cpu"``.
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

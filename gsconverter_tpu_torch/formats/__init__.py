"""Format codec registry — importing this package registers every codec."""

from .base import BaseFormat, get_handler, known_formats
from .compressed_ply import CompressedPlyFormat
from .ksplat import KSplatFormat
from .parquet import ParquetFormat
from .ply_gs import Ply3DGSFormat, PlyCCFormat
from .sog import SogFormat
from .splat import SplatFormat
from .spz import SpzFormat

__all__ = [
    "BaseFormat",
    "get_handler",
    "known_formats",
    "CompressedPlyFormat",
    "KSplatFormat",
    "ParquetFormat",
    "Ply3DGSFormat",
    "PlyCCFormat",
    "SogFormat",
    "SplatFormat",
    "SpzFormat",
]

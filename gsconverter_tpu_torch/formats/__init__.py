"""Format codec registry — importing this package registers the codecs."""

from .base import NOT_PORTED, BaseFormat, get_handler, known_formats
from .ply_gs import Ply3DGSFormat, PlyCCFormat
from .splat import SplatFormat

__all__ = [
    "NOT_PORTED",
    "BaseFormat",
    "get_handler",
    "known_formats",
    "Ply3DGSFormat",
    "PlyCCFormat",
    "SplatFormat",
]

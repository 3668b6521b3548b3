"""Format codec protocol + registry.

Mirrors the reference's ``BaseFormat`` ABC.  Codecs read into / write from
the canonical :class:`SplatCloud`.  Reader side-channel state matches the
reference: ``self.extra_elements`` (non-vertex PLY elements) and
``self.metadata`` — carried on the handler instance.

Formats the JAX package supports but this package has not ported yet are
known by name: asking for one raises ``NotImplementedError`` naming the
ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Any

from ..cloud import SplatCloud

_REGISTRY: dict[str, type["BaseFormat"]] = {}

#: formats of gsconverter_tpu still to port -> the ROADMAP item that ports them
NOT_PORTED = {
    "ksplat": "queue 1, formats/ksplat.py",
    "spz": "queue 1, remaining codecs + batch",
    "compressed_ply": "queue 1, remaining codecs + batch",
    "parquet": "queue 1, remaining codecs + batch",
}


def register(cls: type["BaseFormat"]) -> type["BaseFormat"]:
    _REGISTRY[cls.name] = cls
    return cls


def get_handler(name: str) -> "BaseFormat":
    """Factory (reference converter.py:74-92)."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"format '{name}' is not ported to gsconverter_tpu_torch yet "
            f"(ROADMAP {NOT_PORTED[name]})"
        )
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"Unsupported format: {name}") from None


def known_formats() -> list[str]:
    return list(_REGISTRY)


class BaseFormat:
    #: registry key, e.g. "3dgs"
    name: str = ""
    #: default file extension including dot
    extension: str = ""
    #: per-format SH degree cap (reference converter.py:154-163)
    max_sh_degree: int = 3
    #: target formats that force RGB synthesis (reference converter.py:244)
    needs_rgb: bool = False
    #: whether raw extra PLY elements survive a write (reference converter.py:275)
    supports_extra_elements: bool = False

    def __init__(self) -> None:
        self.extra_elements: tuple = ()
        self.metadata: dict[str, Any] = {}

    def read(self, path: str, **kwargs: Any) -> SplatCloud:
        raise NotImplementedError

    def write(self, cloud: SplatCloud, path: str, **kwargs: Any) -> None:
        raise NotImplementedError

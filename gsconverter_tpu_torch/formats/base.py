"""Format codec protocol + registry.

Mirrors the reference's ``BaseFormat`` ABC.  Codecs read into / write from
the canonical :class:`SplatCloud`.  Reader side-channel state matches the
reference: ``self.extra_elements`` (non-vertex PLY elements) and
``self.metadata`` — carried on the handler instance.
"""

from __future__ import annotations

from typing import Any

from ..cloud import SplatCloud

_REGISTRY: dict[str, type["BaseFormat"]] = {}


def register(cls: type["BaseFormat"]) -> type["BaseFormat"]:
    _REGISTRY[cls.name] = cls
    return cls


def get_handler(name: str) -> "BaseFormat":
    """Factory (reference converter.py:74-92)."""
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
    #: whether ``write`` runs collectives under a multi-rank mesh, so every
    #: rank calls it (only rank 0 writes the file)
    collective_write: bool = False

    def __init__(self) -> None:
        self.extra_elements: tuple = ()
        self.metadata: dict[str, Any] = {}

    def read(self, path: str, **kwargs: Any) -> SplatCloud:
        raise NotImplementedError

    def write(self, cloud: SplatCloud, path: str, **kwargs: Any) -> None:
        raise NotImplementedError

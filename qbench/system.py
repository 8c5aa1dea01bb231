"""What a system module builds: the objects an entry drives."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class System:
    """The system under test. ``engine`` answers ``search_slots``; ``ivf``
    is the IVF engine whose ``block_topw`` calls the roofline counts,
    ``ivf_span`` the span its calls are recorded under."""

    engine: Any = None
    ivf: Any = None
    ivf_span: str = ""
    info: dict = field(default_factory=dict)

"""One finding of the port's runtime checks (port of
``repro.analysis.jaxpr.Violation``)."""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Violation:
    """One analyzer finding: ``rule`` id, ``where`` it was found (e.g.
    ``"quafl×lattice/round"``), human-readable ``detail``."""
    rule: str
    where: str
    detail: str

    def as_dict(self) -> Dict[str, str]:
        return {"rule": self.rule, "where": self.where,
                "detail": self.detail}

"""RPR001 fixture: inline suppression silences the finding."""
from dataclasses import dataclass


@dataclass(frozen=True)
class Annotated:
    kept: int = 0  # sentinel: ignore[RPR001]  (provenance-only field)

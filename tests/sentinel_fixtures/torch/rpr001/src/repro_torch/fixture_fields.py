"""RPR001 fixture: one unread field, one read field, one swept class."""
from dataclasses import dataclass
from typing import NamedTuple


@dataclass(frozen=True)
class LaneSpec:
    lanes: int
    ghost: int  # TP: written at construction, read nowhere


def width(s: LaneSpec) -> int:
    return s.lanes  # near miss: `lanes` is read


class Swept(NamedTuple):
    a: int
    b: int


# near miss: a `_fields` sweep makes Swept's reads untrackable by name,
# so the rule must skip the whole class
_ALL_FIELDS = Swept._fields

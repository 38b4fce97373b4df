"""Best-known specialization configs per (arch, shape): the persistent
output of the hillclimbs, with the reference's API.

The online explorer *discovers* these; the table warm-starts the next
deployment so exploration begins from the incumbent instead of the
generic config.

``TUNED`` starts empty.  The reference's entries are hillclimb winners on
a TPU mesh and say nothing about the card; the table is filled only from
runs of the port's hillclimb on the card (ROADMAP M12b).  Until then
:func:`best_spec` returns the generic (empty) config for every key.
"""
from __future__ import annotations

import json

__all__ = ["TUNED", "best_spec", "spec_json"]

#: (arch, shape name) -> spec-point overrides, from card runs only
TUNED: dict[tuple[str, str], dict] = {}


def best_spec(arch: str, shape: str) -> dict:
    """Best-known config, falling back to the generic (empty) config."""
    return dict(TUNED.get((arch, shape), {}))


def spec_json(arch: str, shape: str) -> str:
    return json.dumps(best_spec(arch, shape))

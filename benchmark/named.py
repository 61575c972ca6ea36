"""The harness's parts found by name: metrics/<name>.py, detectors/<demod>.py,
signals/<kind>.py. A missing file is a SetupError that names it.

SEARCH gives, for each kind, the directories looked in, in order; a test
may put a directory of its own in front.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

__all__ = ["HERE", "SEARCH", "SetupError", "module"]

HERE = Path(__file__).resolve().parent
SEARCH: dict[str, list[Path]] = {k: [HERE / k] for k in ("metrics", "detectors", "signals")}


class SetupError(RuntimeError):
    """A failure before the window: the run fails and says so (no retry)."""


def module(kind: str, name: str):
    """<kind>/<name>.py, from the first of SEARCH[kind] that holds it, as a
    module."""
    dirs = SEARCH[kind]
    path = next((d / f"{name}.py" for d in dirs if (d / f"{name}.py").is_file()), None)
    if path is None:
        raise SetupError(f"no {kind[:-1]} named {name!r}: {dirs[-1] / f'{name}.py'} is missing")
    tag = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(f"{kind[:-1]}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

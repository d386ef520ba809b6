"""The comparison that decides ``correct`` fails what it has to fail.

The control (the reference in the program's place, in single-pass TF32)
and a run whose timed path is broken underneath by each fault of its
system (``benchmark/faults/<system>.py``) come out not correct, at a tiny
size on the CPU; the same runs unbroken come out correct."""

from __future__ import annotations

import pytest

from conftest import (CELLS, REQUIRED_FAULTS, ROOT, cell_of, faults_of, run_tiny,
                      systems_of)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    res = run_tiny(name, control=True)
    assert res["failed"] == 0 and res["info"]["judged"] > 0
    assert not res["correct"], res["checks"]
    assert res["checks"]["score_err"]["value"] > 1e-6


@pytest.mark.parametrize("name", CELLS)
def test_unbroken_is_correct(name):
    assert run_tiny(name)["correct"]


def _declared(name: str) -> dict:
    """The faults of cell ``name``'s system; none where it has no faults
    module, which ``test_every_system_has_its_faults`` names."""
    try:
        return faults_of(cell_of(name).config["system"])
    except ModuleNotFoundError:
        return {}


#: each cell with each fault its system declares
CASES = [pytest.param(name, fault, id=f"{name}-{fault}") for name in CELLS
         for fault in _declared(name)]


@pytest.mark.parametrize("name, fault", CASES)
def test_fault_fails(name, fault):
    fn, least = faults_of(cell_of(name).config["system"])[fault]
    res = run_tiny(name, fault=fn)
    assert not res["correct"], (fault, res["checks"])
    for check, value in least.items():
        assert res["checks"][check]["value"] > value, (fault, check, res["checks"])


@pytest.mark.parametrize("bench", ["repository", "new_cell"])
def test_every_system_has_its_faults(bench, request):
    """Each configuration's system has a module in ``benchmark/faults/``
    that gives at least ``stale``, ``half`` and ``altered``."""
    path = ROOT / "BENCHMARK.json" if bench == "repository" else \
        request.getfixturevalue("new_cell")[1]
    for system in systems_of(path):
        try:
            faults = faults_of(system)
        except ModuleNotFoundError:
            pytest.fail(f"system {system!r} has no benchmark/faults/{system}.py")
        assert set(REQUIRED_FAULTS) <= set(faults), (system, sorted(faults))

"""The reference's async regression gate on its rows sync, full and
bounded1_det: tests/test_torch_async_gate.py's test (its method, fixture
and helpers) over the rest of `GATE_ROWS`.  About 200 s on one worker."""

import pytest

from test_torch_async_gate import _gate_row, gate_bundles  # noqa: F401 (the fixture, for this file's tests)


@pytest.mark.parametrize("mode", ["analytic", "measured"])
@pytest.mark.parametrize("label", ["bounded1_det", "full", "sync"])
def test_gate_rows_equal_the_reference(gate_bundles, label, mode, monkeypatch):
    """tests/test_torch_async_gate.py's test, on these rows."""
    _gate_row(gate_bundles, label, mode, monkeypatch)

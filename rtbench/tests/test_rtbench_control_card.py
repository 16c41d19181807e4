"""On the card: the control (the reference with its colour state in
bfloat16, put in the program's place) is not correct, and the program is,
on the tiny cells (``pytest -m gpu rtbench/tests``). The cells' own
readings come from ``rtbench/calibrate.py`` at their full size."""

from __future__ import annotations

import pytest
import torch

from rtbench import calibrate, check
from rtbench.tests import helpers


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tiny.tinywalk1", "tiny.tinystill16"])
def test_control_fails_where_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = helpers.cell(name)
    rows = calibrate.readings(cell, [21, 22, 23], 3.0, "cuda", control=3)
    for row in rows:
        ok, _, _ = check.judge(dict(row["program"], per_frame_bad_pct=[]), cell.limits)
        assert ok, row
        assert row["control"]["film_err_p50"] > cell.limits["film_err_p50"], row

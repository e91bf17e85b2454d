"""On the card: the program's job and the control (the reference with
TF32 on) at phi4-mini's published widths, one layer and two rounds of
the cell's traffic; the program holds the phi4 cell's limits and the
control does not, and the digest sweep's sums are kept for the warm round
alone (the replays run in a graph). Run there with ``python -m pytest
fl_bench/tests/test_card.py``."""
import dataclasses

import pytest

from fl_bench import check, harness
from fl_bench.tests.conftest import CELLS

pytestmark = pytest.mark.card
SEEDS = (2 ** 31 + 1, 2 ** 33 + 2, 2 ** 34 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_program_holds_and_control_fails(card, seed):
    real = harness.load_cell(CELLS[0])
    cell = dataclasses.replace(
        real, config={**real.config, "n_layers": 1},
        traffic={**real.traffic, "rounds": 2})
    program = harness.Program(cell, card)
    w = harness.make_weights(seed, cell, card)
    tokens = harness.make_batch(seed, 0, cell, 2, card)
    result = program.job(harness.port_weights(cell, w), tokens, seed)
    program.release()
    assert result.dispatch["driver"] == "graph"
    assert sorted(result.digest_sums) == [0]      # the warm round's
    values = check.check_job(cell, program, w, seed, 0, result, card)
    assert check.judge(values, cell.limits)[0], values
    want = check.reference_job(cell, w, tokens)
    got = check.reference_job(cell, w, tokens, tf32=True)
    control = {**check.numbers(got, want), "mine_mismatch": 0}
    assert not check.judge(control, cell.limits)[0], control

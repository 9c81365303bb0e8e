"""chip_smoke's four-card phase, rehearsed on four virtual CPU devices."""

import numpy as np

import chip_smoke
from twenty_first_tpu.parallel import make_mesh


def test_phase_four_cards_on_virtual_mesh():
    res = chip_smoke.phase_four_cards(10, make_mesh(4),
                                      np.random.default_rng(5), reps=1)
    assert res["bit_exact"] == "ok"

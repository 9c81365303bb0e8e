"""chip_smoke.py at tiny sizes on the CPU: the device check refuses to run,
and each phase function agrees with its native host oracle."""

import numpy as np
import pytest

import chip_smoke


def test_check_device_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.check_device()


def test_main_exits_without_result_on_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_phase_anchors():
    res = chip_smoke.phase_anchors()
    assert res["tip5_hash10_snapshot"] == "ok"


@pytest.mark.parametrize("log_n", [10, 17])
def test_phase_ntt(log_n):
    res = chip_smoke.phase_ntt(log_n, np.random.default_rng(log_n), reps=1)
    assert res["bit_exact"] == "ok"


def test_phase_merkle():
    leafs, root = chip_smoke.merkle_inputs(9, np.random.default_rng(1))
    assert chip_smoke.phase_merkle(leafs, root, reps=1)["bit_exact"] == "ok"


def test_phase_commit_w10():
    trace, root = chip_smoke.commit_inputs(6, 10, 4, np.random.default_rng(2))
    res = chip_smoke.phase_commit(trace, root, 4, reps=1)
    assert res["bit_exact"] == "ok"


def test_commit_oracle_detects_a_changed_trace():
    trace, root = chip_smoke.commit_inputs(4, 3, 2, np.random.default_rng(3))
    trace[1, 5] ^= 1
    assert not np.array_equal(chip_smoke.commit_oracle(trace, 2), root)


def test_phase_kernel_interpret():
    res = chip_smoke.phase_kernel(8, np.random.default_rng(4), reps=1,
                                  interpret=True)
    assert res["bit_exact"] == "ok"


def test_xla_tip5_restores_dispatch():
    from twenty_first_tpu.tip5 import kernel

    before = kernel.use_kernel
    with chip_smoke.xla_tip5():
        assert not kernel.use_kernel(1 << 20, "gpu")
    assert kernel.use_kernel is before

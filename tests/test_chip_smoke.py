"""chip_smoke.py: refuses to run without a GPU, and its phases run end to
end at tiny sizes on the CPU (the device routes opted in)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_phase_msm_tiny():
    chip_smoke.phase_msm([10, 12])


def test_phase_sumcheck_tiny():
    chip_smoke.phase_sumcheck(5)


def test_phase_sound_tiny(monkeypatch):
    from tnsh.commit import kzg

    monkeypatch.setenv("TNSH_DEVICE_MSM", "1")
    monkeypatch.setattr(kzg, "_DEVICE_MSM_MIN", 1 << 6)
    chip_smoke.phase_sound(3, 6)


def test_phase_bits_tiny():
    chip_smoke.phase_bits(3, 6, 5)


def test_phases_four_tiny():
    import jax

    devices = jax.devices()[:4]
    assert len(devices) == 4
    chip_smoke.four_preflight(devices)
    state = chip_smoke.start_four_msm(devices, 2)
    chip_smoke.phase_four_sopd(devices, 6, sharded_rounds=2)
    chip_smoke.phase_four_msm(state)


def test_parse_args_defaults_are_full_size():
    a = chip_smoke.parse_args([])
    assert (a.four, a.log_msm, a.log_lanes, a.sound, a.bits,
            a.bits_device_t) == (False, "18,20", 20, "10,18", "10,20", 18)


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    """The whole smoke test at rehearsal sizes, where JAX has a GPU."""
    assert chip_smoke.main(["--log-msm", "12", "--log-lanes", "10",
                            "--sound", "4,8", "--bits", "4,8",
                            "--bits-device-t", "6"]) == 0

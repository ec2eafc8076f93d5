"""CPI corner-turn buffering + checkpoint/resume (SURVEY §5.4)."""

import numpy as np
import pytest

from rsp_chains.configs import RuntimeConfig
from rsp_chains.io.cpi import CpiBuffer, load_state, save_state


def test_cpi_assembly(rng):
    buf = CpiBuffer(num_pulses=4, n_range=16, channels=2)
    pulses = rng.randn(10, 2, 16).astype(np.complex64)
    cpis = []
    for p in pulses:
        got = buf.push(p)
        if got is not None:
            cpis.append(got)
    assert len(cpis) == 2
    np.testing.assert_array_equal(cpis[0], pulses[:4].transpose(1, 0, 2))
    np.testing.assert_array_equal(cpis[1], pulses[4:8].transpose(1, 0, 2))


def test_cpi_overlap_hop(rng):
    buf = CpiBuffer(num_pulses=4, n_range=8, hop=2)
    pulses = rng.randn(8, 8).astype(np.complex64)
    cpis = [c for p in pulses if (c := buf.push(p)) is not None]
    # first CPI after 4 pulses, then every 2: pulses [0:4], [2:6], [4:8]
    assert len(cpis) == 3
    np.testing.assert_array_equal(cpis[1][0], pulses[2:6])


def test_checkpoint_roundtrip(tmp_path, rng):
    rt = RuntimeConfig.make(fft_size=512, ref_window_size=16, guard_window_size=2,
                            threshold_scaler=4.5)
    buf = CpiBuffer(num_pulses=4, n_range=8)
    buf.push(rng.randn(8).astype(np.complex64))
    buf.push(rng.randn(8).astype(np.complex64))
    path = tmp_path / "ckpt.npz"
    save_state(path, rt, buf, seq=np.asarray(41))

    buf2 = CpiBuffer(num_pulses=4, n_range=8)
    rt2, extras = load_state(path, buf2)
    assert int(rt2.log2_fft_size) == 9
    assert float(rt2.threshold_scaler) == 4.5
    assert extras["seq"] == 41
    np.testing.assert_array_equal(buf2.state()["buf"], buf.state()["buf"])
    assert buf2.state()["count"] == 2
    # resuming produces the same CPI as the original would
    p3, p4 = rng.randn(8).astype(np.complex64), rng.randn(8).astype(np.complex64)
    buf.push(p3)
    buf2.push(p3)
    c1, c2 = buf.push(p4), buf2.push(p4)
    np.testing.assert_array_equal(c1, c2)


def test_invalid_hop():
    with pytest.raises(ValueError):
        CpiBuffer(num_pulses=4, n_range=8, hop=5)


def test_checkpoint_path_without_suffix_round_trips(tmp_path):
    """np.savez appends '.npz' but np.load does not — suffix-less paths must
    still round-trip."""
    from rsp_chains import RuntimeConfig
    from rsp_chains.io.cpi import load_state, save_state

    rt = RuntimeConfig.make(fft_size=256, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=4.5)
    p = tmp_path / "ckpt"          # no extension
    save_state(p, rt)
    rt2, extras = load_state(p)
    assert float(rt2.threshold_scaler) == 4.5
    assert int(rt2.log2_fft_size) == 8


def test_checkpoint_carries_plfg_profile(tmp_path):
    """The PLFG profile RAM is part of the restartable state."""
    import numpy as np

    from rsp_chains.configs import RuntimeConfig
    from rsp_chains.io.cpi import load_state, save_state

    prof = np.linspace(0, 7, 64).astype(np.float32)
    rt = RuntimeConfig.make(fft_size=64, ref_window_size=8,
                            guard_window_size=2, plfg_profile=prof)
    save_state(tmp_path / "ck", rt)
    rt2, _ = load_state(tmp_path / "ck")
    np.testing.assert_array_equal(np.asarray(rt2.plfg_profile), prof)
    # and absent state restores as absent
    rt3 = RuntimeConfig.make(fft_size=64, ref_window_size=8,
                             guard_window_size=2)
    save_state(tmp_path / "ck2", rt3)
    rt4, _ = load_state(tmp_path / "ck2")
    assert rt4.plfg_profile is None


def test_checkpoint_from_older_register_file_restores_defaults(tmp_path):
    """A checkpoint written before a register was added must restore that
    register to its make() default, not None (code-review r3 finding)."""
    import numpy as np

    from rsp_chains.configs import RuntimeConfig
    from rsp_chains.io.cpi import load_state, save_state

    rt = RuntimeConfig.make(fft_size=64, ref_window_size=8,
                            guard_window_size=2, threshold_scaler=7.0)
    save_state(tmp_path / "old", rt)
    # simulate a pre-upgrade checkpoint: strip the mem CSRs
    z = dict(np.load(tmp_path / "old.npz"))
    z.pop("rt_mem_start_reading")
    z.pop("rt_mem_run_last")
    np.savez(tmp_path / "old.npz", **z)
    rt2, _ = load_state(tmp_path / "old")
    assert int(rt2.mem_start_reading) == 1    # make() default, not None
    assert int(rt2.mem_run_last) == 1
    assert float(rt2.threshold_scaler) == 7.0  # saved registers kept
    assert rt2.plfg_profile is None

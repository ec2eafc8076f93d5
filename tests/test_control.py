"""Debug control port (jtag2mm analog, SURVEY §2.7): peek/poke the register
file of a RUNNING StreamingPipeline from a second, independent control master."""

import threading
import time

import numpy as np
import pytest

import rsp_chains as rsp
from rsp_chains.io.control import ControlServer, poke
from rsp_chains.io.stream import StreamingPipeline


@pytest.fixture(scope="module")
def chain():
    cfg = rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=256),
        cfar=rsp.CfarConfig(max_ref_window=16, max_fft_size=256),
    )
    return rsp.fft_mag_cfar_chain(cfg)


def _rt(**kw):
    base = dict(fft_size=256, ref_window_size=8, guard_window_size=2,
                threshold_scaler=3.5, div_sum=3)
    base.update(kw)
    return rsp.RuntimeConfig.make(**base)


def test_peek_returns_live_register_file(chain):
    pipe = StreamingPipeline(chain.jit(), _rt())
    with pipe, ControlServer(lambda: pipe.runtime, pipe.reconfigure,
                             cfar_cfg=chain.cfg.cfar) as srv:
        regs = poke("127.0.0.1", srv.port)["regs"]
    assert regs["fft_size"] == 256
    assert regs["threshold_scaler"] == pytest.approx(3.5)
    assert regs["ref_window_size"] == 8
    # the peek dict round-trips through make()
    rt2 = rsp.RuntimeConfig.make(**regs)
    assert int(rt2.log2_fft_size) == 8


def test_poke_applies_to_next_cpi(chain):
    """A debug-master write lands in the stream at a CPI boundary: CPIs after
    the poke run with the new threshold scaler (config-before-enable ordering,
    SURVEY §3.3)."""
    results = {}
    lock = threading.Lock()

    def on_result(seq, out, m):
        with lock:
            results[seq] = int(np.asarray(out.peaks).sum())

    iq = rsp.golden.three_tone_signal(256, shift_range_factor=4)
    pipe = StreamingPipeline(chain.jit(), _rt(), on_result=on_result)
    with pipe, ControlServer(lambda: pipe.runtime, pipe.reconfigure,
                             cfar_cfg=chain.cfg.cfar) as srv:
        pipe.submit(0, iq[None])
        deadline = time.time() + 60
        while 0 not in results and time.time() < deadline:
            time.sleep(0.01)
        # hostile-threshold poke: nothing can beat a 1e6x scaler
        resp = poke("127.0.0.1", srv.port, {"threshold_scaler": 1e6})
        assert resp["regs"]["threshold_scaler"] == pytest.approx(1e6)
        pipe.submit(1, iq[None])
        while 1 not in results and time.time() < deadline:
            time.sleep(0.01)
    assert results[0] > 0          # tones detected at the normal scaler
    assert results[1] == 0         # poked scaler suppresses every detection


def test_poke_validation_rejects_bad_writes(chain):
    """Out-of-range registers are rejected with the stream undisturbed — the
    elaborated maxima bind the debug master too."""
    pipe = StreamingPipeline(chain.jit(), _rt())
    with pipe, ControlServer(lambda: pipe.runtime, pipe.reconfigure,
                             cfar_cfg=chain.cfg.cfar) as srv:
        with pytest.raises(RuntimeError, match="max_ref_window"):
            poke("127.0.0.1", srv.port, {"ref_window_size": 64})
        with pytest.raises(RuntimeError, match="unknown registers"):
            poke("127.0.0.1", srv.port, {"no_such_reg": 1})
        # register file unchanged after the rejected writes
        regs = poke("127.0.0.1", srv.port)["regs"]
    assert regs["ref_window_size"] == 8


def test_cli_poke_roundtrip(chain, capsys):
    """The ``poke`` CLI subcommand drives the same protocol."""
    from rsp_chains import cli

    pipe = StreamingPipeline(chain.jit(), _rt())
    with pipe, ControlServer(lambda: pipe.runtime, pipe.reconfigure,
                             cfar_cfg=chain.cfg.cfar) as srv:
        rc = cli.main(["poke", "--port", str(srv.port),
                       "--set", "threshold_scaler=4.5"])
        assert rc == 0
        out = capsys.readouterr().out
        assert '"threshold_scaler": 4.5' in out
        assert float(np.asarray(pipe.runtime.threshold_scaler)) == 4.5


def test_poke_rmw_atomic_vs_concurrent_reconfigure(chain):
    """The poke's read-merge-write runs under the pipeline's rt lock
    (update_runtime), so a data-plane config write can never be reverted by a
    debug-master poke that snapshotted the registers before it landed."""
    pipe = StreamingPipeline(chain.jit(), _rt())
    gate = threading.Event()

    class SlowMergePipe:
        """Wrap update_runtime so the merge stalls until the data-plane write
        has been ISSUED (it must then block on the lock, not interleave)."""

        def update_runtime(self, fn):
            def slow(cur):
                gate.wait(timeout=5)
                time.sleep(0.05)  # give the racing reconfigure time to block
                return fn(cur)
            return pipe.update_runtime(slow)

    with pipe, ControlServer(lambda: pipe.runtime, pipe.reconfigure,
                             cfar_cfg=chain.cfg.cfar,
                             update_rt=SlowMergePipe().update_runtime) as srv:
        t = threading.Thread(
            target=lambda: poke("127.0.0.1", srv.port, {"peak_grouping": 1}))
        t.start()
        # data-plane write races the in-flight poke's merge
        racer = threading.Thread(
            target=lambda: (gate.wait(timeout=5),
                            pipe.reconfigure(_rt(threshold_scaler=9.0))))
        racer.start()
        gate.set()
        t.join(timeout=10)
        racer.join(timeout=10)
        regs = poke("127.0.0.1", srv.port)["regs"]
    # both writes survive in SOME serialization: the poke merged either
    # before or after the reconfigure, but never dropped it silently AND
    # the poke's own register landed
    assert regs["peak_grouping"] == 1 or regs["threshold_scaler"] == pytest.approx(9.0)
    # the poke was ordered against the reconfigure atomically: if the merge
    # ran second it preserved the racer's scaler
    if regs["peak_grouping"] == 1 and regs["threshold_scaler"] != pytest.approx(9.0):
        # merge ran FIRST under the lock; the racer's write then replaced the
        # whole file — peak_grouping goes back to the racer's value (0).
        # That combination means the lock ordering broke.
        raise AssertionError(f"lost update: {regs}")


def test_concurrent_pokes_never_tear_the_register_file(chain):
    """SURVEY §5.2 (race detection): many concurrent debug masters hammer
    single-register writes while the data plane streams CPIs. Every write is
    a read-merge-write under the pipeline's runtime lock, so the final file
    must reflect exactly one interleaving — no torn/partial states, no lost
    profile RAM — and every intermediate peek must round-trip make()."""
    import queue

    from rsp_chains.ops.plfg import PlfgProgram, Segment, compile_program

    prof = compile_program(
        PlfgProgram(chirps=((Segment(num_samples=256),),)),
        None, 256)
    rt0 = rsp.RuntimeConfig.make(fft_size=256, ref_window_size=8,
                                 guard_window_size=2, threshold_scaler=3.5,
                                 div_sum=3, plfg_profile=prof)
    pipe = StreamingPipeline(chain.jit(), rt0)
    errors: queue.Queue = queue.Queue()
    iq = (np.random.RandomState(0).randn(256)
          + 1j * np.random.RandomState(1).randn(256)).astype(np.complex64)

    with pipe, ControlServer(lambda: pipe.runtime, pipe.reconfigure,
                             cfar_cfg=chain.cfg.cfar,
                             update_rt=pipe.update_runtime) as srv:
        def hammer(reg, values):
            try:
                for v in values:
                    r = poke("127.0.0.1", srv.port, {reg: v})
                    assert r["ok"], r
                    regs = r["regs"]
                    rsp.RuntimeConfig.make(**regs)  # never torn: re-validates
            except Exception as e:  # noqa: BLE001
                errors.put(e)

        threads = [
            threading.Thread(target=hammer, args=("threshold_scaler",
                                                  [float(v) for v in
                                                   range(2, 22)])),
            threading.Thread(target=hammer, args=("guard_window_size",
                                                  [1, 2] * 10)),
            threading.Thread(target=hammer, args=("peak_grouping",
                                                  [0, 1] * 10)),
        ]
        feeder_stop = threading.Event()

        def feeder():
            seq = 0
            while not feeder_stop.is_set():
                pipe.submit(seq, iq[None])
                seq += 1
                time.sleep(0.002)

        ft = threading.Thread(target=feeder)
        for t in threads:
            t.start()
        ft.start()
        for t in threads:
            t.join(timeout=60)
        feeder_stop.set()
        ft.join(timeout=10)
        assert errors.empty(), errors.get()
        final = pipe.runtime
    # the last write of each hammered register is one of its written values,
    # untouched registers kept their initial values, and the profile RAM
    # survived every scalar merge
    assert float(final.threshold_scaler) == 21.0
    assert int(final.guard_window_size) in (1, 2)
    assert int(final.peak_grouping) in (0, 1)
    assert int(final.ref_window_size) == 8
    np.testing.assert_array_equal(np.asarray(final.plfg_profile), prof)
    assert pipe.stats.frames_failed == 0

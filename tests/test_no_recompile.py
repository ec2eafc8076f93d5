"""The control-plane contract: runtime register changes never recompile.

This is the analog of the reference's AXI4 register writes — reconfiguring a
running chain must be as cheap as a bus write, not a re-elaboration (SURVEY §L3)."""

import numpy as np
import jax.numpy as jnp

from rsp_chains import (
    ChainConfig, CfarAlgorithm, CfarConfig, CfarMode, CfarVariant, FftConfig,
    MagMode, RuntimeConfig, fft_mag_cfar_chain,
)
from rsp_chains.golden import three_tone_signal


def test_full_register_sweep_single_compile():
    cfg = ChainConfig(
        fft=FftConfig(max_size=1024),
        cfar=CfarConfig(max_ref_window=64, variant=CfarVariant.GOSCA,
                        include_cash=True),
    )
    chain = fft_mag_cfar_chain(cfg)
    f = chain.jit()
    iq = jnp.asarray(three_tone_signal(1024, shift_range_factor=12), jnp.complex64)

    sweeps = [
        dict(),
        dict(fft_size=256),
        dict(fft_size=64),
        dict(mag_mode=MagMode.SQR),
        dict(mag_mode=MagMode.LOG2, log_or_linear=0, threshold_scaler=2.0),
        dict(cfar_mode=CfarMode.GREATEST_OF),
        dict(cfar_mode=CfarMode.SMALLEST_OF),
        dict(cfar_mode=CfarMode.CASH, sub_window_size=8),
        dict(cfar_algorithm=CfarAlgorithm.GOS, index_lagg=20, index_lead=20),
        dict(ref_window_size=16, guard_window_size=2, div_sum=4),
        dict(ref_window_size=64, guard_window_size=8, div_sum=6),
        dict(peak_grouping=1),
        dict(threshold_scaler=10.0),
    ]
    for kw in sweeps:
        base = dict(fft_size=1024, ref_window_size=32, guard_window_size=4)
        base.update(kw)
        out = f(iq, RuntimeConfig.make(**base))
        out.threshold.block_until_ready()
    assert f._cache_size() == 1, "runtime register change triggered a recompile"

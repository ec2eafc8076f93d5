"""Preset chain topologies — the analogs of the reference's four chain tops and
their elaboration Apps (SURVEY §2.8-2.11, §L6).

| preset                     | reference top                                      |
|----------------------------|----------------------------------------------------|
| ``fft_mag_cfar_chain``     | ``FftMagCfarChainVanilla`` (FftMagCfarChain.scala:31-49) |
| ``rsp_chain_vanilla``      | ``RspChainVanilla`` (RspChain.scala:39-61)         |
| ``chain_with_mem``         | ``ChainWithMem`` + MemForTestingFFT ROM (FftMagCfarChainWithMem.scala:21-54) |
| ``rx_fft_mag_cfar_tx_chain`` | ``RxFftMagCfarTxChain`` UART-looped top (RxFftCfarMagTxChain.scala:24-78) |
| ``pulse_compression_chain``| BASELINE config 2 (north-star addition)            |
| ``range_doppler_chain``    | BASELINE config 3 (flagship 2-D CPI chain)         |
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from .chain import Chain, Stage
from .configs import (
    ChainConfig,
    DopplerConfig,
    FftConfig,
    MatchedFilterConfig,
    RuntimeConfig,
)
from .ops.cfar import cfar_op
from .ops.doppler import doppler_fft
from .ops.fft import fft_op
from .ops.logmag import logmag
from .ops.matched_filter import matched_filter
from .ops.nco import nco
from .ops.plfg import PlfgProgram
from . import packing


# ---------------------------------------------------------------------------
# stage factories
# ---------------------------------------------------------------------------


def _bit_true(cfg: ChainConfig) -> bool:
    return cfg.fixed_point.enabled and cfg.fixed_point.bit_true


def fft_stage(cfg: ChainConfig) -> Stage:
    if _bit_true(cfg):
        from .ops.bit_true import fft_int_op

        return Stage("fft_int",
                     lambda x, rt: fft_int_op(x, rt.log2_fft_size, cfg.fft))
    return Stage("fft", lambda x, rt: fft_op(x, rt.log2_fft_size, cfg.fft))


def mag_stage(cfg: ChainConfig) -> Stage:
    if _bit_true(cfg):
        # the full integer LogMagMux menu, runtime-muxed like the hardware
        # (RspChainTesterUtils.scala:197-216; the tester's default write is
        # mode 2 = JPL, RspChainVanillaTester.scala:98)
        from .ops.bit_true import mag_int_op

        return Stage("logmag_int",
                     lambda x, rt: mag_int_op(x, rt.mag_mode, cfg.mag))
    return Stage("logmag", lambda x, rt: logmag(x, rt.mag_mode, cfg.mag))


def cfar_stage(cfg: ChainConfig) -> Stage:
    if _bit_true(cfg):
        # covers every elaborated variant: CA family plus GOS/GOSCA rank
        # select and CASH sub-windows (the reference's shipped RspChainVanilla
        # is integer GOSCA + CASH, RspChain.scala:118,130-140)
        from .ops.bit_true import cfar_int

        return Stage("cfar_int", lambda x, rt: cfar_int(x, rt, cfg.cfar),
                     terminal=True)
    return Stage("cfar", lambda x, rt: cfar_op(x, rt, cfg.cfar), terminal=True)


def core_stages(cfg: ChainConfig) -> list[Stage]:
    """The FFT->MAG->CFAR core as a stage list (float or bit-true integer,
    per ``cfg.fixed_point``)."""
    return [fft_stage(cfg), *tail_stages(cfg)]


def tail_stages(cfg: ChainConfig) -> list[Stage]:
    """The logmag+CFAR tail as a stage list."""
    return [mag_stage(cfg), cfar_stage(cfg)]


def _wire_rx_stage() -> Stage:
    """Packed 32-bit beat words -> IQ pair (the shared serving ingress)."""
    return Stage("rx_unpack", lambda words, rt: packing.unpack_iq_pair(words))


def _wire_tx_stage(cfg: ChainConfig) -> Stage:
    """CfarOutput -> packed ``{threshold | bin | peak}`` words (the shared
    serving egress; the elaborated bin width and sendCut field selection are
    the ONE wire contract both serving tops must agree on)."""
    def tx(out, rt):
        log2n = cfg.fft.log2_max  # word layout uses the elaborated bin width
        # sendCut elaboration: pack the cell-under-test value in the bin field
        # (CFARParams.sendCut, RspChainVanillaTester.scala:232)
        cut = out.cut if cfg.cfar.send_cut else None
        return packing.pack_cfar_words(out.threshold, out.peaks, log2n,
                                       cut=cut)

    return Stage("tx_pack", tx, terminal=True)


def matched_filter_stage(cfg: ChainConfig, taps: np.ndarray) -> Stage:
    mf_cfg = cfg.matched_filter or MatchedFilterConfig()
    taps_np = np.asarray(taps)  # host-side; split to a real pair inside the op
    if mf_cfg.method == "overlap_save":
        from .ops.matched_filter import matched_filter_os

        return Stage("matched_filter_os",
                     lambda x, rt: matched_filter_os(x, taps_np, mf_cfg))
    return Stage("matched_filter", lambda x, rt: matched_filter(x, taps_np, mf_cfg))


def doppler_stage(cfg: ChainConfig) -> Stage:
    dop_cfg = cfg.doppler or DopplerConfig()
    return Stage("doppler_fft", lambda x, rt: doppler_fft(x, dop_cfg))


def plfg_nco_stage(cfg: ChainConfig, program: PlfgProgram) -> Stage:
    """Self-stimulus source: PLFG profile + NCO synthesis (``RspChain.scala:57``:
    ``nco.freq := plfg.streamNode``). The compiled profile holds word offsets; the
    runtime start value (base+5*bb register) is ``rt.nco_freq_word`` — a traced
    scalar, so re-steering the chirp never recompiles. The whole profile can
    ALSO be reprogrammed at runtime: when ``rt.plfg_profile`` carries a
    compiled array (``ops.plfg.compile_program``), it replaces the chain's
    program like the hardware's chirp-RAM write on a running bitstream
    (``RspChainVanillaTester.scala:86-94``) — a traced operand, no recompile."""
    # keep the compiled default profile as HOST numpy: a device-resident
    # closure constant would be fetched back to the host during jit lowering
    # (constant embedding)
    from .ops.plfg import compile_program

    profile = compile_program(program, cfg.plfg, cfg.fft.max_size)

    def fn(_, rt: RuntimeConfig):
        if rt.plfg_profile is not None:
            assert rt.plfg_profile.shape[-1] == cfg.fft.max_size, (
                "plfg_profile must be compiled to the elaborated frame length "
                f"({cfg.fft.max_size}); use ops.plfg.compile_program")
            prof = rt.plfg_profile.astype(jnp.float32)
        else:
            prof = jnp.asarray(profile)
        words = prof + rt.nco_freq_word.astype(jnp.float32)
        # pair output: the device-native complex representation
        return nco(words, cfg.nco, phase_offset=rt.phase_offset, pair=True)

    return Stage("plfg_nco", fn)


# ---------------------------------------------------------------------------
# preset chains
# ---------------------------------------------------------------------------


def fft_mag_cfar_chain(cfg: Optional[ChainConfig] = None) -> Chain:
    """``process(iq) -> detections``: the reusable core subchain (SURVEY §2.9).
    Input: complex [..., max_fft_size] frames. Output: ``CfarOutput``."""
    cfg = cfg or ChainConfig()
    return Chain(cfg, core_stages(cfg))


def rsp_chain_vanilla(
    cfg: Optional[ChainConfig] = None, program: Optional[PlfgProgram] = None
) -> Chain:
    """Full self-stimulus chain PLFG->NCO->FFT->MAG->CFAR (SURVEY §2.8). Call with
    ``x = None``; the source generates the signal on-chip, as in the hardware
    (``RspChain.scala:41-45,57-58``)."""
    if cfg is None:
        # the reference elaborates this chain in integer fixed point (binPoint = 0,
        # RspChain.scala:118); enabling the fidelity mode by default also floors
        # float numerical noise the way 16-bit truncation does in hardware, so a
        # pure NCO tone doesn't scatter CFAR detections across the e-4 noise floor
        from .configs import FixedPointConfig

        cfg = ChainConfig(
            fixed_point=FixedPointConfig(enabled=True, width=16, bin_point=0)
        )
    if program is None:
        # one constant-frequency chirp segment (<= 2^maxNumOfSamplesWidth samples),
        # repeated to fill the frame — the repeatedChirpNums mechanism
        # (RspChainVanillaTester.scala:91)
        from .ops.plfg import Segment

        seg = 1 << cfg.plfg.max_num_samples_width
        reps = max(1, cfg.fft.max_size // seg)
        program = PlfgProgram(
            chirps=((Segment(num_samples=min(seg, cfg.fft.max_size)),),),
            repeat_counts=(reps,),
            chirp_ordinals=(0,),
        )
    return Chain(
        cfg,
        [plfg_nco_stage(cfg, program), *core_stages(cfg)],
    )


def chain_with_mem(cfg: Optional[ChainConfig] = None, rom: Optional[np.ndarray] = None) -> Chain:
    """ROM-stimulus test top (SURVEY §2.10): a stored three-tone+noise frame
    (``MemForTestingFFT``'s tones at relative freqs 1/8, 1/4, 1/2 + noise,
    ``MemForTesting.scala:27-40``) streamed into the core subchain.

    The mem block's CSRs are runtime registers: ``rt.mem_start_reading`` gates
    the ROM stream (``MemForTesting.scala:81-85`` — no valid beats until set;
    the whole-array analog is a zero frame, so the tail emits no detections),
    and ``rt.mem_run_last`` drives the emitted stream's ``last`` flag
    (``:86-93``; honored as FLAG_LAST by the serving layer)."""
    from .golden.fixtures import three_tone_signal

    cfg = cfg or ChainConfig()
    if rom is None:
        rom = three_tone_signal(cfg.fft.max_size, shift_range_factor=13)
    from .cplx import C

    # host-side split kept as numpy (see plfg_nco_stage for why)
    rom_np = np.asarray(rom)
    rom_re = np.ascontiguousarray(rom_np.real.astype(np.float32))
    rom_im = np.ascontiguousarray(rom_np.imag.astype(np.float32))

    def mem_fn(_, rt):
        gate = (rt.mem_start_reading != 0).astype(jnp.float32)
        return C(jnp.asarray(rom_re) * gate, jnp.asarray(rom_im) * gate)

    mem = Stage("mem_rom", mem_fn)
    return Chain(cfg, [mem, *core_stages(cfg)])


def rx_fft_mag_cfar_tx_chain(cfg: Optional[ChainConfig] = None) -> Chain:
    """Deployment/served top (SURVEY §2.11): packed 32-bit IQ beat words in ->
    packed CFAR output words out, mirroring the UART-looped
    ``RxFftMagCfarTxChain`` wire format end to end
    (``RspChainTesterUtils.scala:105-109`` in; ``RspChainVanillaTester.scala:164-172`` out)."""
    cfg = cfg or ChainConfig()
    return Chain(cfg, [_wire_rx_stage(), *core_stages(cfg),
                       _wire_tx_stage(cfg)])


def real_rx_chain(cfg: Optional[ChainConfig] = None) -> Chain:
    """Real-ADC ingest chain: real samples -> packed rfft -> logmag -> CFAR.

    The reference's test vectors are real tones (``getTone``,
    ``RspChainTesterUtils.scala:39-41``) fed as zero-imag complex; a real ADC
    front-end needs no imaginary lane, and the rfft pack trick
    (``ops.fft.rfft_op``) halves the transform work. Input: real float frames
    of ``cfg.fft.max_size`` samples; the spectrum keeps bins [0, N/2) (the
    one-sided band; the Nyquist bin is dropped to keep the CFAR frame a power
    of two), so the CFAR tail runs at N/2 cells — ``RuntimeConfig.make(
    fft_size=N, cfar_fft_size=N//2)`` is the matching register setting.
    Static-size transform (no runtime size register — an ADC frame length is a
    board property, not a per-dwell knob)."""
    import dataclasses

    from .ops.fft import _scale_factor, rfft_op

    cfg = cfg or ChainConfig()
    n = cfg.fft.max_size
    # the rfft front end is a fixed natural-order float transform — reject
    # elaboration flags it cannot honor rather than silently ignore them
    if cfg.fft.window is not None:
        raise ValueError("real_rx_chain does not window the rfft; elaborate "
                         "window=None (or pre-window the ADC frames)")
    if cfg.fft.expand_logic is not None or (
            cfg.fft.keep_msb_or_lsb is not None
            and not all(cfg.fft.keep_msb_or_lsb)):
        raise ValueError("per-stage expand/LSB-keep scaling has no analog in "
                         "the rfft front end; use FftScaling")
    half_cfg = dataclasses.replace(cfg, fft=dataclasses.replace(cfg.fft,
                                                                max_size=n // 2))

    def rx(x, rt):
        out = rfft_op(jnp.asarray(x, jnp.float32), pair=True)
        return out[..., : n // 2]  # drop Nyquist: power-of-two CFAR frame

    scale = _scale_factor(n, cfg.fft.scaling)

    def scaled_rx(x, rt):
        y = rx(x, rt)
        return y * scale if scale != 1.0 else y

    return Chain(cfg, [Stage("rfft", scaled_rx), *tail_stages(half_cfg)])


def pulse_compression_chain(
    cfg: Optional[ChainConfig] = None, taps: Optional[np.ndarray] = None
) -> Chain:
    """BASELINE config 2: matched filter -> range FFT -> logmag -> CFAR, per pulse.

    The matched filter's frequency-domain form makes the stage pair
    ``matched_filter -> fft`` algebraically collapsible at full runtime size:
    ``FFT(IFFT(FFT(x)·H)) = FFT(x)·H`` (circular, frame-sized). The collapsed
    ``spectral_mf`` stage replaces THREE four-step FFT evaluations with one
    plus an elementwise spectral multiply — exact, not an approximation.
    Runtime FFT sizes below the elaborated max change the matched filter
    itself, so the smaller sizes keep the literal stage composition under one
    ``lax.cond``."""
    cfg = cfg or ChainConfig(
        fft=FftConfig(max_size=4096),
        matched_filter=MatchedFilterConfig(fft_size=4096),
    )
    if taps is None:
        from .golden.fixtures import lfm_chirp

        taps = lfm_chirp(cfg.matched_filter.num_taps if cfg.matched_filter else 128)
    mf_cfg = cfg.matched_filter or MatchedFilterConfig()
    taps_np = np.asarray(taps)
    n = cfg.fft.max_size
    collapsible = (
        mf_cfg.method == "freq"
        and cfg.fft.window is None
        and cfg.fft.use_bit_reverse
        and not _bit_true(cfg)
        and taps_np.shape[-1] <= n
        and (cfg.fft.keep_msb_or_lsb is None
             or all(cfg.fft.keep_msb_or_lsb))   # LSB-keep: no float analog
    )
    if collapsible:
        import jax

        from .cplx import C, as_pair
        from .ops.matched_filter import matched_filter_spectrum

        h = matched_filter_spectrum(taps_np, n, mf_cfg.normalize)
        hr = h.real.astype(np.float32)
        hi = h.imag.astype(np.float32)

        def spectral_mf(x, rt: RuntimeConfig):
            xp = as_pair(x)

            def full(xq):
                s = fft_op(xq, None, cfg.fft)       # static full-size branch
                return s * C(jnp.asarray(hr), jnp.asarray(hi))

            def small(xq):
                y = matched_filter(xq, taps_np, mf_cfg)
                return fft_op(y, rt.log2_fft_size, cfg.fft)

            if not cfg.fft.runtime_size:
                return full(xp)
            return jax.lax.cond(rt.log2_fft_size >= cfg.fft.log2_max,
                                full, small, xp)

        return Chain(cfg, [Stage("spectral_mf", spectral_mf),
                           *tail_stages(cfg)])
    return Chain(
        cfg,
        [matched_filter_stage(cfg, taps), fft_stage(cfg), mag_stage(cfg), cfar_stage(cfg)],
    )


def range_doppler_chain(
    cfg: Optional[ChainConfig] = None, taps: Optional[np.ndarray] = None
) -> Chain:
    """BASELINE config 3 (flagship): per-CPI 2-D processing.

    Input: complex CPI blocks [..., P, N] (P pulses slow time, N fast-time range
    samples). Pipeline: matched filter (range) -> Doppler FFT (pulses) -> logmag ->
    CFAR along range per Doppler bin. One jitted program per CPI."""
    cfg = cfg or ChainConfig(doppler=DopplerConfig())
    if (cfg.fft.keep_msb_or_lsb is not None
            and not all(cfg.fft.keep_msb_or_lsb)):
        # the RD chain has no FFT register stage for the flag to govern; a
        # silent float path would contradict the LSB-keep contract (see
        # ops/fft.py) — reject at elaboration like the FFT-bearing chains
        raise ValueError(
            "keepMSBorLSB = LSB has no analog in the range-Doppler chain "
            "(its matched filter is a float frequency-domain correlation, "
            "not the register-mapped FFT stage); elaborate all-MSB")
    if cfg.matched_filter is None:
        # no MF elaborated -> no MF stage, matching the sharded pipeline's
        # semantics (parallel/sharded.py: ``if mf_cfg is None: y = x``) so
        # sharded == unsharded holds for the same config. Fabricating a
        # default filter here would silently filter what the user never
        # asked to filter.
        if taps is not None:
            raise ValueError(
                "taps given but cfg.matched_filter is None — elaborate a "
                "MatchedFilterConfig for the filter stage to exist")
        dop = doppler_stage(cfg)
        return Chain(cfg, [dop, *tail_stages(cfg)])
    if taps is None:
        from .golden.fixtures import lfm_chirp

        taps = lfm_chirp(cfg.matched_filter.num_taps)
    return Chain(
        cfg,
        [
            matched_filter_stage(cfg, taps),
            doppler_stage(cfg),
            *tail_stages(cfg),
        ],
    )


def rx_rd_tx_chain(
    cfg: Optional[ChainConfig] = None, taps: Optional[np.ndarray] = None
) -> Chain:
    """Wire-format flagship serving top: packed 32-bit IQ beat words
    [..., P, N] in -> packed ``{threshold | bin | peak}`` words per RD-map
    cell out — the ``RxFftMagCfarTxChain`` wire contract
    (``RspChainTesterUtils.scala:105-109`` in,
    ``RspChainVanillaTester.scala:164-172`` out) around the fused
    range-Doppler chain."""
    cfg = cfg or ChainConfig(doppler=DopplerConfig())
    core = range_doppler_chain(cfg, taps=taps)
    return Chain(cfg, [_wire_rx_stage(), *core.stages, _wire_tx_stage(cfg)])


def beamformed_rd_chain(
    cfg: Optional[ChainConfig] = None,
    taps: Optional[np.ndarray] = None,
    angles_rad: Optional[np.ndarray] = None,
    num_channels: int = 8,
    fft_beams: bool = False,
) -> Chain:
    """Multi-channel front end: element-space CPI -> beams -> range-Doppler.

    The reference processes one channel per elaborated chain; an array front
    end would be N chain instances behind an analog/digital beamformer
    (SURVEY §2.15 "data parallel over channels/beams"). Here beam formation is
    one ``[beams, channels]`` complex matmul (``ops/beamform.py``)
    ahead of the RD chain — the beam axis then plays the channel role.
    ``fft_beams=True`` uses the DFT beam space (``fft_beamform``: C uniform
    beams at spatial frequencies k/C) instead of steered ULA beams.

    Input: ``[..., C, P, N]`` element-space IQ CPI blocks (C array channels).
    Output: ``CfarOutput`` over ``[..., B, P, N]`` per-beam RD maps."""
    from .cplx import C as _C, as_pair
    from .ops.beamform import beamform, fft_beamform, ula_steering

    cfg = cfg or ChainConfig(doppler=DopplerConfig())
    if angles_rad is None:
        angles_rad = np.deg2rad(np.linspace(-60, 60, 8))
    weights = None if fft_beams else ula_steering(num_channels, angles_rad)

    def bf(x, rt):
        xp = as_pair(x)
        c, p, n = xp.shape[-3:]
        assert c == num_channels, (c, num_channels)
        flatt = xp.reshape(xp.shape[:-2] + (p * n,))   # [..., C, P*N]
        y = fft_beamform(flatt) if fft_beams else beamform(flatt, weights)
        return y.reshape(y.shape[:-1] + (p, n))

    rd = range_doppler_chain(cfg, taps=taps)
    return Chain(cfg, [Stage("fft_beamform" if fft_beams else "beamform", bf),
                       *rd.stages])


def integrated_search_chain(
    cfg: Optional[ChainConfig] = None,
    taps: Optional[np.ndarray] = None,
    mode: str = "noncoherent",
    m_of_n: int = 0,
) -> Chain:
    """Search-mode pulse integration (no Doppler filter bank): matched filter
    per pulse, then one of the three classic integration gains
    (``ops/integrate.py``) ahead of or behind the CFAR:

    * ``mode='noncoherent'`` — magnitude sum over pulses, CFAR on the
      integrated range profile (post-detection integration gain);
    * ``mode='coherent'`` — complex pulse sum before the magnitude (full
      10·log10(P) gain for phase-stable returns);
    * ``mode='binary'`` — per-pulse CFAR decisions fused m-of-n
      (``m_of_n`` ≥ 1; the classic double-threshold detector).

    Input: ``[..., P, N]`` IQ CPI. Output: ``CfarOutput`` over ``[..., N]``
    (binary mode: peaks are the m-of-n fusion; threshold is the per-pulse
    mean threshold for observability)."""
    from .ops.integrate import (
        binary_integration, coherent_integration, noncoherent_integration,
    )

    cfg = cfg or ChainConfig()
    if taps is None:
        from .golden.fixtures import lfm_chirp

        n_taps = (cfg.matched_filter or MatchedFilterConfig()).num_taps
        taps = lfm_chirp(n_taps)
    assert mode in ("noncoherent", "coherent", "binary"), mode
    if mode == "binary":
        assert m_of_n >= 1, "binary integration needs m_of_n >= 1"

    mf = matched_filter_stage(cfg, taps)
    mag = mag_stage(cfg)
    cfar = cfar_stage(cfg)

    if mode == "coherent":
        def integ(x, rt):
            from .cplx import C as _C

            return _C(coherent_integration(x.re), coherent_integration(x.im))

        stages = [mf, Stage("coherent_integration", integ), mag, cfar]
    elif mode == "noncoherent":
        stages = [
            mf, mag,
            Stage("noncoherent_integration",
                  lambda m, rt: noncoherent_integration(m)),
            cfar,
        ]
    else:
        def fuse(out, rt):
            from .ops.cfar import CfarOutput

            return CfarOutput(
                threshold=jnp.mean(out.threshold, axis=-2),
                peaks=binary_integration(out.peaks, m_of_n),
                noise=None, cut=None,
            )

        stages = [mf, mag, cfar,
                  Stage("binary_integration", fuse, terminal=True)]
    return Chain(cfg, stages)

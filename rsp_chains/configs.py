"""Two-tier configuration system.

The reference splits every block's configurability into (i) elaboration-time Scala
case-class parameters that fix maxima / bit widths / which algorithm variants get
silicon (e.g. ``FFTParams.fixed`` at ``src/test/scala/RspChainVanillaTester.scala:205-217``,
``CFARParams`` at ``:228-239``) and (ii) runtime AXI4 registers written per run
(``RunTimeRspChainParams`` at ``src/test/scala/RspChainVanillaTester.scala:35-62`` and
the register-write sequence at ``:96-146``).

The mapping onto JAX:

* ``*StaticConfig`` — frozen Python dataclasses. Changing one changes traced shapes or
  compiled branches and therefore triggers (intentional) recompilation. These mirror the
  elaboration parameters: maximum FFT size, maximum window sizes, which CFAR algorithm
  variants are compiled in, dtype/fixed-point policy.
* ``RuntimeConfig`` — a JAX pytree of *traced scalars*. Every field mirrors a runtime
  register of the reference (CFAR register map reconstructed at
  ``src/test/scala/RspChainVanillaTester.scala:113-146``). Changing a value between calls
  of a jitted chain must NOT trigger recompilation; this is asserted by
  ``tests/test_no_recompile.py``.

Validation rules are ported from the reference's ``require(...)`` constraints
(``RspChainVanillaTester.scala:50-61``): windows powers of two, ref > guard,
GOS rank indices < window, CASH sub-window < ref window.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# enums (compiled-in algorithm variants & runtime mode codes)
# ---------------------------------------------------------------------------


class MagMode(enum.IntEnum):
    """LogMagMux runtime mode register (base+0).

    The reference muxes the magnitude function at runtime
    (``RspChainVanillaTester.scala:98`` writes 2 = JPL). Mode codes follow the
    reference's menu (abs/sqr/jpl/log2 — mode 2 = JPL is pinned by the tester;
    others inferred from the golden menu at ``RspChainTesterUtils.scala:197-216``,
    whose default case is plain ``c.abs``).
    """

    ABS = 0          # exact |x| (golden default case)
    SQR = 1          # |x|^2 = re^2 + im^2
    JPL = 2          # max(u + v/8, 7u/8 + v/2), u = max(|re|,|im|), v = min
    LOG2 = 3         # log2(jpl(x))


class CfarMode(enum.IntEnum):
    """CFAR mode register (base+6*beatBytes), codes from
    ``RspChainVanillaTester.scala:100-106``."""

    CELL_AVERAGING = 0  # "Cell Averaging"
    GREATEST_OF = 1     # "Greatest Of"
    SMALLEST_OF = 2     # "Smallest Of"
    CASH = 3            # "CASH"


class CfarAlgorithm(enum.IntEnum):
    """Runtime CA/GOS select (base+5*beatBytes) — only meaningful when the GOSCA
    variant is compiled in (``RspChainVanillaTester.scala:124-132``)."""

    CA = 0
    GOS = 1


class CfarVariant(enum.Enum):
    """Elaboration-time algorithm variant (``CFARAlgorithm`` in CFARParams:
    CACFARType / GOSCFARType / GOSCACFARType, ``RspChainVanillaTester.scala:238``)."""

    CA = "CA"
    GOS = "GOS"
    GOSCA = "GOSCA"  # both compiled in; runtime-switchable


class FftScaling(enum.Enum):
    """SDF-FFT stage-scaling policy (``expandLogic``/``keepMSBorLSB`` arrays,
    ``RspChainVanillaTester.scala:213-214``). The tested configuration (expand=0,
    keep MSB at each stage) halves at every stage => output = FFT(x)/N, matching the
    tester golden ``fourierTr(...)/fftSize`` (``FftMagCfarChainTester.scala:77``)."""

    DIV_N = "div_n"       # divide by N (reference default behaviour)
    NONE = "none"         # raw unscaled FFT (expand logic all-on)
    SQRT_N = "sqrt_n"     # unitary scaling


class Rounding(enum.Enum):
    """Fixed-point rounding mode (``roundingMode = RoundHalfUp``,
    ``RspChainVanillaTester.scala:201``)."""

    HALF_UP = "half_up"
    HALF_EVEN = "half_even"
    TRUNCATE = "truncate"


class EdgePolicy(enum.Enum):
    """CFAR behaviour where reference windows hang off the frame edge.

    The reference's streaming CFAR (submodule not vendored) sees fewer cells near
    edges; we expose the choice. PARTIAL = clamp window to available cells but keep
    the configured divider (closest to a shift-register implementation that divides
    by a fixed power of two)."""

    PARTIAL = "partial"
    REFLECT = "reflect"
    WRAP = "wrap"


# ---------------------------------------------------------------------------
# static (elaboration-time) configs — one per op, mirroring §2 of SURVEY.md
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FixedPointConfig:
    """Fixed-point fidelity policy, mirroring dsptools ``FixedPoint(width, bp)``.

    The reference instantiates chains with 16-bit data at binary point 0
    (``RspChain.scala:118``) or 12 (``FftMagCfarChain.scala:89``). When ``enabled``
    the chain quantizes stage boundaries to this grid so outputs can be compared
    against fixed-point reference streams within an SNR bound."""

    enabled: bool = False
    width: int = 16
    bin_point: int = 0
    rounding: Rounding = Rounding.HALF_UP
    # Exact-arithmetic emulation (ops/bit_true.py): every stage computes in
    # integers with the hardware's per-stage truncation, so packed int16 wire
    # streams are bit-exact against golden.int_models — not just SNR-close.
    # Requires bin_point 0; covers every CFAR variant (CA/GOS/GOSCA + CASH)
    # and the full runtime magnitude menu.
    bit_true: bool = False

    @property
    def scale(self) -> float:
        return float(2 ** self.bin_point)

    @property
    def max_int(self) -> int:
        return 2 ** (self.width - 1) - 1

    @property
    def min_int(self) -> int:
        return -(2 ** (self.width - 1))


@dataclass(frozen=True)
class PlfgConfig:
    """PLFG elaboration parameters (``FixedPLFGParams``,
    ``RspChainVanillaTester.scala:182-191``).

    The PLFG emits piecewise-linear frequency-ramp words organized as
    frames -> chirps -> segments, with small instruction memory describing segments
    (SURVEY §2.1)."""

    max_num_segments: int = 4
    max_num_different_chirps: int = 8
    max_num_repeated_chirps: int = 8
    max_chirp_ordinal_num: int = 4
    max_num_frames: int = 4
    max_num_samples_width: int = 8   # log2 of max segment length
    output_width_int: int = 16
    output_width_frac: int = 0

    def __post_init__(self):
        assert self.max_num_segments > 0
        assert self.max_num_frames > 0


@dataclass(frozen=True)
class NcoConfig:
    """NCO elaboration parameters (``FixedNCOParams``,
    ``RspChainVanillaTester.scala:192-204``).

    ``table_size`` entries of a quarter-wave(!)-less full sine LUT of ``table_width``
    bits; ``phase_width``-bit phase accumulator. The reference's spectral contract:
    a constant PLFG word ``s`` produces a tone peaking at FFT bin
    ``s * num_points / (4 * table_size)`` (``RspChainVanillaTester.scala:85``),
    i.e. the phase step per sample is ``s / (4 * table_size)`` cycles."""

    table_size: int = 128
    table_width: int = 16
    phase_width: int = 9
    rasterized_mode: bool = False
    n_interpolation_terms: int = 0
    dither_enable: bool = False
    phase_acc_enable: bool = True
    rounding: Rounding = Rounding.HALF_UP
    quantized_lut: bool = False  # True => bit-faithful int LUT path
    # syncROMEnable (FixedNCOParams): registers the ROM read port — a one-cycle
    # latency choice in hardware with no whole-array-semantics analog (the
    # AXI-Stream handshake keeps sample alignment). Accepted for elaboration
    # parity; has no effect on computed values.
    sync_rom_enable: bool = False

    @property
    def amplitude(self) -> float:
        # NCO golden scales output to +/-2^14 (RspChainTesterUtils.scala:177-178)
        return float(2 ** (self.table_width - 2))


@dataclass(frozen=True)
class FftConfig:
    """FFT elaboration parameters (``FFTParams.fixed``,
    ``RspChainVanillaTester.scala:205-217``).

    ``max_size`` bounds the runtime-selectable size (power of two); ``runtime_size``
    enables per-call size selection without recompile (compiled as a
    ``lax.switch`` over all log2 sizes in [min_log2_size, log2(max_size)])."""

    max_size: int = 1024
    runtime_size: bool = True
    min_log2_size: int = 3
    scaling: FftScaling = FftScaling.DIV_N
    # Per-stage growth enables, mirroring FFTParams.expandLogic
    # (RspChainVanillaTester.scala:213): length log2(max_size); stage k with
    # expand_logic[k]=0 divides by 2 (the hardware truncates the grown LSB,
    # keepMSBorLSB=MSB). In float semantics this is an overall factor
    # 2^-(#zeros among the active stages), which adapts to the runtime size.
    # Overrides ``scaling`` when set.
    expand_logic: Optional[tuple] = None
    # Per-stage truncation side, mirroring FFTParams.keepMSBorLSB
    # (RspChainVanillaTester.scala:214): length log2(max_size); True = keep
    # MSBs (divide by 2, RoundHalfUp — the chains' tested setting), False =
    # keep LSBs (wraparound overflow, the raw hardware trim). LSB-keep has no
    # float analog: the float FFT rejects it; the bit-true integer pipeline
    # (``ops/bit_true.py``) reproduces it exactly. Only consulted on
    # non-expanding stages (an expanding stage grows the word instead).
    keep_msb_or_lsb: Optional[tuple] = None
    # Precision of the four-step FFT's matmuls: "highest" computes them in
    # full float32 (required for the ±2-LSB fixed-point fidelity contract; a
    # float32 matmul may otherwise run in TF32 on the GPU, about three decimal
    # digits); "default" lets the backend pick a faster, lower-precision mode
    # for throughput-first deployments.
    matmul_precision: str = "highest"
    window: Optional[str] = None  # optional pre-FFT window fn name
    # FFTParams.useBitReverse (RspChain.scala:111): True (the chains' setting)
    # emits natural-order bins; False reproduces the raw SDF datapath's
    # bit-reversed output order (a hardware artifact — offered for stream-level
    # parity with a reorder-less elaboration; not a hot path).
    use_bit_reverse: bool = True

    def __post_init__(self):
        n = self.max_size
        assert n > 0 and (n & (n - 1)) == 0, "fft max_size must be a power of two"
        assert 2 ** self.min_log2_size <= n
        if self.keep_msb_or_lsb is not None:
            assert len(self.keep_msb_or_lsb) == self.log2_max, (
                "keep_msb_or_lsb must have one entry per stage "
                f"(log2(max_size) = {self.log2_max})")

    @property
    def log2_max(self) -> int:
        return int(np.log2(self.max_size))


@dataclass(frozen=True)
class LogMagConfig:
    """LogMagMux elaboration parameters (``MAGParams.fixed``,
    ``RspChainVanillaTester.scala:218-227``).

    The input data proto (the reference's dataWidth/binPoint) is not duplicated
    here — it is the chain-wide ``FixedPointConfig`` policy. The log-path
    output proto IS kept: ``FixedPoint(data_width_log, bin_point_log)`` bounds
    and grids the log2 output on the LUT path."""

    data_width_log: int = 16     # log2-output proto width (protoLog)
    bin_point_log: int = 9       # log2-output fractional bits
    log2_lookup_width: int = 9   # LUT precision of the fractional log2 path
    use_lut_log: bool = False    # bit-faithful LUT log2 vs fast float log2


@dataclass(frozen=True)
class CfarConfig:
    """CFAR elaboration parameters (``CFARParams``,
    ``RspChainVanillaTester.scala:228-239``).

    ``max_ref_window`` = leadLaggWindowSize (max cells per side),
    ``max_guard_window`` = guardWindowSize. ``variant`` fixes which algorithms are
    compiled in; ``include_cash`` adds the CASH sub-window machinery."""

    max_ref_window: int = 64
    max_guard_window: int = 8
    max_fft_size: int = 1024
    variant: CfarVariant = CfarVariant.GOSCA
    include_cash: bool = True
    min_sub_window: int = 2
    send_cut: bool = False       # pack CUT value instead of bin index in out words
    emit_noise: bool = False     # also emit the pre-scaler noise estimate array
    edge_policy: EdgePolicy = EdgePolicy.PARTIAL
    threshold_bin_point: int = 3  # protoThreshold FixedPoint(16, 3.BP) (":230")
    scaler_bin_point: int = 6     # protoScaler FixedPoint(16, 6.BP) (":231")

    def __post_init__(self):
        w = self.max_ref_window
        assert w > 0 and (w & (w - 1)) == 0, "max_ref_window must be a power of two"
        assert self.max_guard_window >= 1


@dataclass(frozen=True)
class MatchedFilterConfig:
    """Matched-filter / pulse-compression stage (BASELINE config 2; not present in
    the reference checkout — north-star addition per SURVEY §7)."""

    num_taps: int = 128
    fft_size: int = 4096          # overlap-save / freq-domain block size
    # "freq": circular frame-sized frequency-domain correlation (the CPI
    # form; fusable/collapsible). "overlap_save": linear streaming
    # correlation via overlap-save blocks (continuous fast time, zero-history
    # edges instead of wraparound).
    method: str = "freq"
    normalize: bool = True

    def __post_init__(self):
        # ValueError, not assert: an invalid/typo'd method must fail under
        # python -O too (the stage dispatch would otherwise silently run the
        # circular filter with the wrong edge semantics)
        if self.method not in ("freq", "overlap_save"):
            raise ValueError(f"matched-filter method {self.method!r} "
                             "(choose 'freq' or 'overlap_save')")


@dataclass(frozen=True)
class DopplerConfig:
    """Doppler (slow-time) FFT over the pulse axis of a CPI (BASELINE config 3)."""

    num_pulses: int = 256
    window: Optional[str] = "hann"
    fft_shift: bool = True
    scaling: FftScaling = FftScaling.DIV_N


# ---------------------------------------------------------------------------
# runtime config — the "register file", a pytree of traced scalars
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass
class RuntimeConfig:
    """The runtime register file as a pytree of traced scalars.

    Mirrors ``RunTimeRspChainParams`` (``RspChainVanillaTester.scala:35-62``) plus the
    register-write sequence (``:96-146``). All fields are 0-d arrays inside jit;
    changing them between calls does not recompile.

    Register-map correspondence (offsets in beat-words, SURVEY §2.5):
      fft base+0        -> log2_fft_size      (number of active stages)
      mag base+0        -> mag_mode
      cfar base+0       -> cfar_fft_size (an INDEPENDENT register, as in the
                           reference's separate write at
                           RspChainVanillaTester.scala:113; make() defaults it
                           to the FFT size, the only sensible deployment)
      cfar base+1       -> threshold_scaler
      cfar base+2       -> log_or_linear
      cfar base+3       -> div_sum
      cfar base+4       -> peak_grouping
      cfar base+5       -> cfar_algorithm (CA/GOS)
      cfar base+6       -> cfar_mode (CA/GO/SO/CASH)
      cfar base+7       -> ref_window_size
      cfar base+8       -> guard_window_size
      cfar base+9/10    -> index_lagg / index_lead (GOS ranks)
      cfar base+11      -> sub_window_size (CASH)
      mem base+0        -> mem_start_reading (ChainWithMem ROM stream enable,
                           MemForTesting.scala:81-85; hardware resets to 0 and
                           the tester writes 1 — make() defaults it ON, the
                           only sensible always-running deployment)
      mem base+1        -> mem_run_last (the AXI-Stream ``last`` flag on
                           emitted beats, MemForTesting.scala:86-93; mapped to
                           the wire format's FLAG_LAST on served frames)
    """

    log2_fft_size: jnp.ndarray        # int32, FFT "number of active stages"
    mag_mode: jnp.ndarray             # int32, MagMode code
    cfar_mode: jnp.ndarray            # int32, CfarMode code
    cfar_algorithm: jnp.ndarray       # int32, CfarAlgorithm code (CA/GOS)
    ref_window_size: jnp.ndarray      # int32, runtime cells/side <= max_ref_window
    guard_window_size: jnp.ndarray    # int32
    sub_window_size: jnp.ndarray      # int32 (CASH)
    threshold_scaler: jnp.ndarray     # float32 (already de-fixed-pointed)
    div_sum: jnp.ndarray              # int32, CA divider shift
    peak_grouping: jnp.ndarray        # int32 bool
    index_lagg: jnp.ndarray           # int32, GOS rank in lagging window
    index_lead: jnp.ndarray           # int32, GOS rank in leading window
    log_or_linear: jnp.ndarray        # int32: 1 = linear, 0 = log domain
    nco_freq_word: jnp.ndarray        # int32, PLFG start value (self-stimulus chains)
    phase_offset: jnp.ndarray         # float32, NCO poff (cycles)
    cfar_fft_size: jnp.ndarray        # int32, CFAR active frame size (base+0)
    mem_start_reading: jnp.ndarray    # int32 bool, ChainWithMem ROM enable
    mem_run_last: jnp.ndarray         # int32 bool, stream last-flag register
    # The PLFG chirp-RAM content as runtime state: a float32 [frame_len] array
    # of frequency-word offsets (``ops.plfg.compile_program``), or None to use
    # the chain's compiled-in program. The hardware writes the segment RAM +
    # registers on a RUNNING bitstream between frames with no re-elaboration
    # (RspChainVanillaTester.scala:86-94); supplying a new profile array here
    # reprograms a compiled chain the same way — the array is a traced operand,
    # so no recompile (tests/test_rsp_chain.py pins this).
    plfg_profile: Optional[jnp.ndarray] = None

    @staticmethod
    def make(
        *,
        fft_size: int = 1024,
        mag_mode: int = MagMode.JPL,
        cfar_mode: int = CfarMode.CELL_AVERAGING,
        cfar_algorithm: int = CfarAlgorithm.CA,
        ref_window_size: int = 32,
        guard_window_size: int = 4,
        sub_window_size: Optional[int] = None,
        threshold_scaler: float = 3.5,
        div_sum: Optional[int] = None,
        peak_grouping: int = 0,
        index_lagg: Optional[int] = None,
        index_lead: Optional[int] = None,
        log_or_linear: int = 1,
        nco_freq_word: int = 16,
        phase_offset: float = 0.0,
        cfar_fft_size: Optional[int] = None,
        mem_start_reading: int = 1,
        mem_run_last: int = 1,
        plfg_profile=None,
        validate_against: Optional[CfarConfig] = None,
    ) -> "RuntimeConfig":
        """Build a RuntimeConfig from host Python values, applying the reference's
        ``require(...)`` validation (``RspChainVanillaTester.scala:50-61``)."""
        if fft_size <= 0 or (fft_size & (fft_size - 1)) != 0:
            raise ValueError("fftSize must be a power of two")
        if cfar_fft_size is None:
            cfar_fft_size = fft_size
        elif cfar_fft_size <= 0:
            raise ValueError("cfar fftSize must be positive")
        if ref_window_size <= 0 or (ref_window_size & (ref_window_size - 1)) != 0:
            raise ValueError("refWindowSize must be a power of two")
        if guard_window_size <= 0:
            raise ValueError("guardWindowSize must be > 0")
        if ref_window_size <= guard_window_size:
            raise ValueError("refWindowSize must be > guardWindowSize")
        if sub_window_size is not None and sub_window_size >= ref_window_size:
            raise ValueError("subWindowSize must be < refWindowSize")
        if index_lead is not None and index_lead >= ref_window_size:
            raise ValueError("indexLead must be < refWindowSize")
        if index_lagg is not None and index_lagg >= ref_window_size:
            raise ValueError("indexLagg must be < refWindowSize")
        if validate_against is not None:
            if ref_window_size > validate_against.max_ref_window:
                raise ValueError("refWindowSize exceeds elaborated max_ref_window")
            if guard_window_size > validate_against.max_guard_window:
                raise ValueError("guardWindowSize exceeds elaborated max_guard_window")
        if div_sum is None:
            div_sum = int(np.log2(ref_window_size))
        if sub_window_size is None:
            sub_window_size = max(2, ref_window_size // 4)
        if index_lagg is None:
            index_lagg = ref_window_size // 2
        if index_lead is None:
            index_lead = ref_window_size // 2
        i32 = lambda v: jnp.asarray(v, jnp.int32)
        f32 = lambda v: jnp.asarray(v, jnp.float32)
        return RuntimeConfig(
            log2_fft_size=i32(int(np.log2(fft_size))),
            mag_mode=i32(int(mag_mode)),
            cfar_mode=i32(int(cfar_mode)),
            cfar_algorithm=i32(int(cfar_algorithm)),
            ref_window_size=i32(ref_window_size),
            guard_window_size=i32(guard_window_size),
            sub_window_size=i32(sub_window_size),
            threshold_scaler=f32(threshold_scaler),
            div_sum=i32(div_sum),
            peak_grouping=i32(peak_grouping),
            index_lagg=i32(index_lagg),
            index_lead=i32(index_lead),
            log_or_linear=i32(log_or_linear),
            nco_freq_word=i32(nco_freq_word),
            phase_offset=f32(phase_offset),
            cfar_fft_size=i32(cfar_fft_size),
            mem_start_reading=i32(mem_start_reading),
            mem_run_last=i32(mem_run_last),
            plfg_profile=(None if plfg_profile is None
                          else jnp.asarray(plfg_profile, jnp.float32)),
        )

    @property
    def fft_size(self) -> jnp.ndarray:
        return jnp.left_shift(jnp.int32(1), self.log2_fft_size)

    def peek(self) -> dict:
        """Read the SCALAR register file back as plain Python values, keyed by
        the ``make()`` keyword names (the JTAG/debug-master *read* direction;
        round-trips through ``make(**peek())``). Array state — the PLFG
        profile RAM — is not a scalar register and is excluded (merge flows
        preserve it via ``merge_regs``)."""
        out = {}
        for f in dataclasses.fields(self):
            raw = getattr(self, f.name)
            if raw is None:
                continue
            v = np.asarray(raw)
            if v.ndim:
                continue
            out[f.name] = float(v) if v.dtype.kind == "f" else int(v)
        out["fft_size"] = 1 << out.pop("log2_fft_size")
        return out

    def merge_regs(self, validate_against: Optional[CfarConfig] = None,
                   **writes) -> "RuntimeConfig":
        """Register WRITE of only the named fields (the jtag2mm/control-server
        merge primitive): unnamed scalar registers keep their values, array
        state (the PLFG profile RAM) is carried over unless explicitly
        rewritten. Unknown names raise (the hardware has no such address)."""
        regs = self.peek()
        prof = writes.pop("plfg_profile", self.plfg_profile)
        unknown = set(writes) - set(regs)
        if unknown:
            raise ValueError(f"unknown registers: {sorted(unknown)}")
        regs.update(writes)
        return RuntimeConfig.make(validate_against=validate_against,
                                  plfg_profile=prof, **regs)


# ---------------------------------------------------------------------------
# chain-level static bundles (mirror the *Parameters case classes, SURVEY §2.8-2.11)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChainConfig:
    """Top-level static bundle, analog of ``RspChainVanillaParameters``
    (``RspChain.scala:24-37``) / ``FftMagCfarVanillaParameters``
    (``FftMagCfarChain.scala:21-29``). The AXI4 address map disappears; its function
    (binding a register file to each block) is RuntimeConfig."""

    plfg: PlfgConfig = field(default_factory=PlfgConfig)
    nco: NcoConfig = field(default_factory=NcoConfig)
    fft: FftConfig = field(default_factory=FftConfig)
    mag: LogMagConfig = field(default_factory=LogMagConfig)
    cfar: CfarConfig = field(default_factory=CfarConfig)
    matched_filter: Optional[MatchedFilterConfig] = None
    doppler: Optional[DopplerConfig] = None
    fixed_point: FixedPointConfig = field(default_factory=FixedPointConfig)
    compute_dtype: str = "complex64"

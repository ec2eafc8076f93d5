"""rsp_chains — a radar signal-processing framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
``milovanovic/rsp-chains`` (a Chisel RTL generator suite): PLFG/NCO chirp synthesis,
runtime-sized FFT, runtime-muxed magnitude extraction, CA/GO/SO/GOS/CASH CFAR
detection, matched-filter pulse compression and 2-D range-Doppler processing —
composed into single jitted pipelines with the reference's two-tier configurability
(compile-time structure vs recompile-free runtime registers), sharded over device
meshes with neighbor halo exchange for window operators.

See SURVEY.md for the layer-by-layer mapping to the reference.
"""

from .configs import (
    CfarAlgorithm,
    CfarConfig,
    CfarMode,
    CfarVariant,
    ChainConfig,
    DopplerConfig,
    EdgePolicy,
    FftConfig,
    FftScaling,
    FixedPointConfig,
    LogMagConfig,
    MagMode,
    MatchedFilterConfig,
    NcoConfig,
    PlfgConfig,
    Rounding,
    RuntimeConfig,
)
from .chain import Chain, Stage
from .presets import (
    beamformed_rd_chain,
    chain_with_mem,
    fft_mag_cfar_chain,
    integrated_search_chain,
    pulse_compression_chain,
    range_doppler_chain,
    real_rx_chain,
    rsp_chain_vanilla,
    rx_fft_mag_cfar_tx_chain,
    rx_rd_tx_chain,
)
from .ops.cfar_2d import Cfar2dConfig, Cfar2dRuntime, cfar_2d_op, rd_2d_cfar_chain
from .ops.plfg import PlfgProgram, Segment, lfm_program
from .cplx import C, as_pair, join, to_numpy
from . import cplx, ops, packing, numerics, golden

__version__ = "0.2.0"

"""PLFG — piecewise-linear function generator (chirp profile source, SURVEY §2.1).

Whole-array rebuild of ``PLFGDspBlockMem`` (constructor ``RspChain.scala:41``,
``FixedPLFGParams`` at ``RspChainVanillaTester.scala:182-191``). The hardware emits
a stream of frequency words organized frames -> chirps -> segments, programmed via
registers (frames/chirps/start value/segment counts/repeats/ordinals,
``RspChainVanillaTester.scala:80-94``) plus a packed segment-instruction RAM whose
bit encoding is not visible in the checkout; this build replaces the opaque RAM word
with explicit per-segment fields (``Segment``).

Spectral contract preserved: a constant profile at start value ``s`` feeds the NCO a
phase increment of ``s / (4 * nco_table_size)`` cycles/sample, putting the tone at
FFT bin ``s * num_points / (4 * table_size)`` (comment at
``RspChainVanillaTester.scala:85``; verified by ``tests/test_rsp_chain.py``).

Design: a *profile compiler*. The program structure (segment lengths, chirp
sequencing, frame count) is elaboration-static — like the reference, where the
total sample count per frame is fixed by the programmed registers before enable —
so the profile is compiled once into a flat frequency-word array (host numpy),
which jitted chains close over or take as a device argument. The runtime start
value remains a traced scalar: the profile stores *offsets from start*, and the
NCO adds ``rt.nco_freq_word`` at trace time, so re-steering the chirp start
frequency never recompiles.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..configs import PlfgConfig


@dataclass(frozen=True)
class Segment:
    """One piecewise-linear segment: ``num_samples`` outputs, frequency-word slope
    ``increment`` per sample (the analog of one packed RAM instruction)."""

    num_samples: int
    increment: float = 0.0      # freq-word delta per sample (0 = constant tone)
    reset_to_start: bool = False  # jump back to the chirp start value first


@dataclass(frozen=True)
class PlfgProgram:
    """The PLFG register file + instruction RAM, as explicit fields.

    Register correspondence (``RspChainVanillaTester.scala:80-94``):
      num_frames            <- ctrl base+2*bb
      chirps                <- number of different chirps (base+4*bb), one entry per
                               distinct chirp; each a tuple of Segments
                               (segmentNums array, base+6*bb.. + RAM instructions)
      repeat_counts         <- repeatedChirpNums array (base+10*bb..)
      chirp_ordinals        <- chirp ordinal numbers (base+18*bb..): the playback
                               order over distinct chirps
    The start value register (base+5*bb) is runtime (``RuntimeConfig.nco_freq_word``).
    """

    chirps: tuple = (Segment(num_samples=1024, increment=0.0),)
    repeat_counts: tuple = (1,)
    chirp_ordinals: tuple = (0,)
    num_frames: int = 1

    def __post_init__(self):
        chirps = self.chirps
        # normalize: allow a single Segment or a flat tuple of Segments as one chirp
        if isinstance(chirps, Segment):
            object.__setattr__(self, "chirps", ((chirps,),))
        elif chirps and isinstance(chirps[0], Segment):
            object.__setattr__(self, "chirps", (tuple(chirps),))

    def validate(self, cfg: PlfgConfig) -> None:
        """Apply the elaboration maxima (``FixedPLFGParams``)."""
        if len(self.chirps) > cfg.max_num_different_chirps:
            raise ValueError("too many distinct chirps for elaborated maximum")
        if self.num_frames > cfg.max_num_frames:
            raise ValueError("num_frames exceeds elaborated max_num_frames")
        for segs in self.chirps:
            if len(segs) > cfg.max_num_segments:
                raise ValueError("too many segments for elaborated maximum")
            for s in segs:
                if s.num_samples > 2 ** cfg.max_num_samples_width:
                    raise ValueError("segment length exceeds elaborated maximum")
        if max(self.repeat_counts) > cfg.max_num_repeated_chirps:
            raise ValueError("repeat count exceeds elaborated maximum")
        if max(self.chirp_ordinals, default=0) >= len(self.chirps):
            raise ValueError("chirp ordinal out of range")


def chirp_profile(program: PlfgProgram, cfg: PlfgConfig | None = None) -> np.ndarray:
    """Compile a PLFG program into a flat float32 array of frequency-word *offsets
    from the start value* (one entry per output sample, all frames concatenated).

    The NCO adds the runtime start value: words[t] = start + profile[t].
    """
    if cfg is not None:
        program.validate(cfg)

    def one_chirp(segs: Sequence[Segment]) -> np.ndarray:
        parts = []
        level = 0.0
        for s in segs:
            if s.reset_to_start:
                level = 0.0
            ramp = level + s.increment * np.arange(s.num_samples, dtype=np.float64)
            level = level + s.increment * s.num_samples
            parts.append(ramp)
        return np.concatenate(parts) if parts else np.zeros(0)

    chirp_words = [one_chirp(c) for c in program.chirps]
    frame_parts = []
    for ordinal in program.chirp_ordinals:
        rep = program.repeat_counts[ordinal] if ordinal < len(program.repeat_counts) else 1
        frame_parts.extend([chirp_words[ordinal]] * int(rep))
    frame = np.concatenate(frame_parts) if frame_parts else np.zeros(0)
    out = np.tile(frame, program.num_frames)
    return out.astype(np.float32)


def compile_program(program: PlfgProgram, cfg: PlfgConfig | None,
                    frame_len: int) -> np.ndarray:
    """Compile a program to the FIXED elaborated frame length — the chirp-RAM
    write for a *running* chain (``RspChainVanillaTester.scala:86-94``: RAM
    word + frame/chirp/segment registers written before enable, no
    re-elaboration). The compiled array is what ``RuntimeConfig.plfg_profile``
    carries: a new program within the elaborated maxima is a new array into
    the SAME compiled executable. A program whose sample stream is shorter
    than the frame is cycled to fill it (the hardware keeps streaming the
    programmed frame sequence); a longer one is truncated to the frame."""
    prof = chirp_profile(program, cfg)
    if prof.size == 0:
        return np.zeros(frame_len, np.float32)
    return np.resize(prof, frame_len).astype(np.float32)


def lfm_program(
    num_samples: int,
    sweep_words: float,
    num_frames: int = 1,
    max_segment: int = 256,
) -> PlfgProgram:
    """Convenience: a linear-FM chirp sweeping ``sweep_words`` frequency words over
    ``num_samples`` samples (the canonical radar LFM profile). Long ramps are split
    into <= ``max_segment``-sample segments (the level carries across segments, so
    the profile is one continuous ramp) to respect the elaborated
    ``maxNumOfSamplesWidth``."""
    inc = sweep_words / max(num_samples, 1)
    segs = []
    left = num_samples
    while left > 0:
        take = min(left, max_segment)
        segs.append(Segment(num_samples=take, increment=inc))
        left -= take
    return PlfgProgram(
        chirps=(tuple(segs),),
        repeat_counts=(1,),
        chirp_ordinals=(0,),
        num_frames=num_frames,
    )

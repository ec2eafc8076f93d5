"""Chain composition — the framework layer (SURVEY §L5).

The reference composes DSP blocks by connecting diplomatic stream nodes and exports
a combined ``streamNode = NodeHandle(first.in, last.out)`` so chains nest inside
bigger chains (``FftMagCfarChain.scala:37``, ``RxFftCfarMagTxChain.scala:26``). The
JAX analog: a ``Chain`` is an ordered list of named stages — pure functions
``(x, rt) -> x`` — composed into ONE function that jits as a single XLA program, so
every stage boundary that the hardware crossed through an elastic AXI4-Stream buffer
becomes an XLA fusion boundary (usually fused away entirely). Chains nest by
concatenation (``chain_a + chain_b``), exactly like NodeHandle chaining.

The AXI4 control crossbar (one ``mem`` node fanning out to every block's register
file, ``RspChain.scala:49-54``) becomes the single ``RuntimeConfig`` pytree passed
to every stage.

Stage-boundary fixed-point quantization (the dsptools FixedPoint grid the hardware
lives on) is injected between stages when ``ChainConfig.fixed_point.enabled`` —
fidelity mode without duplicating any op (SURVEY §7 hard part (e))."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .configs import ChainConfig, RuntimeConfig
from .numerics import quantize

StageFn = Callable[[Any, RuntimeConfig], Any]


@dataclass(frozen=True)
class Stage:
    """A named processing stage: the analog of one ``AXI4<Name>Block``."""

    name: str
    fn: StageFn
    # terminal stages (CFAR) emit structured output; no boundary quantization after
    terminal: bool = False


class Chain:
    """An ordered composition of stages over ``[..., frame]`` arrays.

    ``chain(x, rt)`` runs every stage under a ``jax.named_scope`` (profiler-visible,
    the analog of waveform probes) with optional fixed-point boundary quantization.
    ``chain.jit()`` returns the single compiled function. Chains nest:
    ``Chain(cfg, a) + Chain(cfg, b)`` is the NodeHandle composition.
    """

    def __init__(self, cfg: ChainConfig, stages: Sequence[Stage]):
        self.cfg = cfg
        self.stages = tuple(stages)
        self._jitted: Optional[Callable] = None

    def __call__(self, x: Any, rt: RuntimeConfig) -> Any:
        from .cplx import C

        fp = self.cfg.fixed_point
        for stage in self.stages:
            with jax.named_scope(stage.name):
                x = stage.fn(x, rt)
            if (fp.enabled and not fp.bit_true and not stage.terminal
                    and isinstance(x, (jnp.ndarray, C))):
                # float fidelity: snap stage boundaries to the FixedPoint grid.
                # bit_true mode needs no boundary quantization — the integer
                # ops (ops/bit_true.py) are exact at every internal step.
                x = quantize(x, fp)
        return x

    def __add__(self, other: "Chain") -> "Chain":
        if not isinstance(other, Chain):
            return NotImplemented
        return Chain(self.cfg, self.stages + other.stages)

    @property
    def stage_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    def jit(self, **jit_kwargs) -> Callable:
        """One compiled XLA program for the whole chain. RuntimeConfig fields are
        traced leaves — calling with different runtime values reuses the same
        executable (asserted in tests/test_no_recompile.py)."""
        if self._jitted is None or jit_kwargs:
            self._jitted = jax.jit(self.__call__, **jit_kwargs)
        return self._jitted

    def lower(self, x: Any, rt: RuntimeConfig):
        return jax.jit(self.__call__).lower(x, rt)


def source_chain(cfg: ChainConfig, stages: Sequence[Stage]) -> Chain:
    """A chain whose first stage ignores its input (self-stimulus topologies like
    ``RspChainVanilla``, which has no external data input — SURVEY §2.8)."""
    return Chain(cfg, stages)

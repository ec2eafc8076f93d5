"""UART block analog: field-for-field register semantics vs
`/root/reference/generators/uart/DSPBlockUART.scala` / `UARTCtrlRegs.scala` /
`UARTTx.scala` / `UARTRx.scala` (see rsp_chains/io/uart.py)."""

import pytest

from rsp_chains.io.uart import DspBlockUart, UartParams, UartRegs


def _loop(u: DspBlockUart, words):
    """TX → line → RX loopback through the bit codec."""
    u.submit(*words)
    got = []
    while True:
        bits = u.transmit()
        if bits is None:
            break
        u.receive(bits)
    return u.collect()


def full():
    return UartParams(data_bits=9, include_four_wire=True,
                      include_parity=True, include_independent_parity=False)


def test_param_requires():
    # UARTParams require() rules (DSPBlockUART.scala:44-47)
    with pytest.raises(ValueError):
        UartParams(divisor_bits=4, oversample=4)
    with pytest.raises(ValueError):
        UartParams(oversample=1, n_samples=3)
    with pytest.raises(ValueError):
        UartParams(data_bits=7)
    with pytest.raises(ValueError):
        DspBlockUart(divisor_init=0)
    with pytest.raises(ValueError):
        DspBlockUart(UartParams(divisor_bits=8, oversample=4),
                     divisor_init=1 << 8)


def test_register_offsets_and_resets():
    u = DspBlockUart(full(), divisor_init=868)
    # resets per the RegFieldDesc reset annotations
    assert u.peek(UartRegs.txctrl) == 0
    assert u.peek(UartRegs.rxctrl) == 0
    assert u.peek(UartRegs.ie) == 0
    assert u.peek(UartRegs.div) == 868
    assert u.peek(UartRegs.parity) == 0
    assert u.peek(UartRegs.wire4) == 0
    assert u.peek(UartRegs.either8or9) == 1   # reset=1 → 8-bit mode
    # field packing round-trips
    u.poke(UartRegs.txctrl, 0b11)             # txen + nstop=1
    assert u.peek(UartRegs.txctrl) == 0b11
    u.poke(UartRegs.ie, 0b10)
    assert u.peek(UartRegs.ie) == 0b10
    u.poke(UartRegs.div, 217)
    assert u.peek(UartRegs.div) == 217
    # optional registers absent in a minimal elaboration
    m = DspBlockUart(UartParams())
    for off in (UartRegs.parity, UartRegs.wire4, UartRegs.either8or9):
        with pytest.raises(KeyError):
            m.peek(off)
        with pytest.raises(KeyError):
            m.poke(off, 1)


def test_loopback_8bit():
    u = DspBlockUart()
    u.poke(UartRegs.txctrl, 1)
    u.poke(UartRegs.rxctrl, 1)
    words = [0x00, 0x5A, 0xFF, 0x81]
    assert _loop(u, words) == words


def test_frame_layout_8n1():
    u = DspBlockUart()
    u.poke(UartRegs.txctrl, 1)                # nstop=0 → 1 stop bit
    bits = u.frame_bits(0xA5)                 # 1010_0101 LSB-first
    assert bits == [0, 1, 0, 1, 0, 0, 1, 0, 1, 1]
    u.poke(UartRegs.txctrl, 0b11)             # nstop=1 → 2 stop bits
    assert u.frame_bits(0xA5)[-2:] == [1, 1]


def test_9bit_mode_and_runtime_8bit_shrink():
    u = DspBlockUart(full())
    u.poke(UartRegs.txctrl, 1)
    u.poke(UartRegs.rxctrl, 1)
    u.poke(UartRegs.either8or9, 0)            # 9 data bits
    assert _loop(u, [0x1A5, 0x0FF, 0x100]) == [0x1A5, 0x0FF, 0x100]
    # 9-bit frame is one bit longer than the 8-bit frame of the same config
    n9 = len(u.frame_bits(0x1A5))
    u.poke(UartRegs.either8or9, 1)            # runtime shrink to 8 data bits
    assert len(u.frame_bits(0xA5)) == n9 - 1
    assert _loop(u, [0x1A5]) == [0xA5]        # bit 8 dropped in 8-bit mode


@pytest.mark.parametrize("odd", [0, 1])
def test_parity_generation_and_check(odd):
    u = DspBlockUart(full())
    u.poke(UartRegs.txctrl, 1)
    u.poke(UartRegs.rxctrl, 1)
    u.poke(UartRegs.parity, 0b1 | (odd << 1))     # enparity, odd/even
    words = [0x00, 0x5A, 0xFF, 0x81, 0x7]
    assert _loop(u, words) == words
    assert (u.peek(UartRegs.parity) >> 2) & 1 == 0    # no sticky error
    # parity bit value per UARTTx.scala:43: xor(data) ^ parity_mode
    bits = u.frame_bits(0x03)                 # two ones → even parity 0
    assert bits[9] == (0 ^ odd)


def test_parity_error_sticky_and_errie_interrupt():
    u = DspBlockUart(full())
    u.poke(UartRegs.txctrl, 1)
    u.poke(UartRegs.rxctrl, 1)
    u.poke(UartRegs.parity, 0b1)              # enparity, even
    u.submit(0x55)
    bits = u.transmit()
    bits[9] ^= 1                              # corrupt the parity bit
    u.receive(bits)
    # the word is still delivered (UARTRx.scala: valid fires regardless) but
    # the sticky errorparity is set; errie gates the second interrupt line
    assert u.collect() == [0x55]
    assert (u.peek(UartRegs.parity) >> 2) & 1 == 1
    assert u.interrupts[1] == 0
    u.poke(UartRegs.parity, 0b1101)           # keep sticky, set errie
    assert u.interrupts[1] == 1
    u.poke(UartRegs.parity, 0b1001)           # W0 clears the sticky bit
    assert u.interrupts[1] == 0


def test_independent_parity_modes():
    # includeIndependentParity: RX checks the OPPOSITE mode of TX
    # (DSPBlockUART.scala:164) — a loopback through one block must now FAIL
    # parity on every word with an odd data population
    u = DspBlockUart(UartParams(include_parity=True,
                                include_independent_parity=True))
    u.poke(UartRegs.txctrl, 1)
    u.poke(UartRegs.rxctrl, 1)
    u.poke(UartRegs.parity, 0b1)
    u.submit(0x01)
    u.receive(u.transmit())
    assert (u.peek(UartRegs.parity) >> 2) & 1 == 1
    # two peer blocks with opposite parity registers interoperate
    a = DspBlockUart(UartParams(include_parity=True,
                                include_independent_parity=True))
    b = DspBlockUart(UartParams(include_parity=True,
                                include_independent_parity=True))
    for dev, par in ((a, 0b01), (b, 0b11)):   # a: even TX, b: odd TX
        dev.poke(UartRegs.txctrl, 1)
        dev.poke(UartRegs.rxctrl, 1)
        dev.poke(UartRegs.parity, par)
    a.submit(0x01)
    b.receive(a.transmit())
    assert b.collect() == [0x01]
    assert (b.peek(UartRegs.parity) >> 2) & 1 == 0


def test_watermark_interrupt_semantics():
    u = DspBlockUart(UartParams(n_tx_entries=8, n_rx_entries=8))
    u.poke(UartRegs.txctrl, 1)
    u.poke(UartRegs.rxctrl, 1)
    u.poke(UartRegs.txmark, 2)                # ip.txwm = count < 2
    u.poke(UartRegs.rxmark, 1)                # ip.rxwm = count > 1
    assert u.peek(UartRegs.ip) == 0b01        # empty tx below mark
    u.submit(1, 2, 3)
    assert u.peek(UartRegs.ip) == 0b00
    for _ in range(3):
        u.receive(u.transmit())
    assert u.peek(UartRegs.ip) & 0b10         # 3 rx words > 1
    assert u.interrupts[0] == 0               # masked until ie set
    u.poke(UartRegs.ie, 0b10)
    assert u.interrupts[0] == 1


def test_fifo_bounds_and_nonblocking_csr_access():
    u = DspBlockUart(UartParams(n_tx_entries=2, n_rx_entries=2))
    u.poke(UartRegs.txctrl, 1)
    u.poke(UartRegs.rxctrl, 1)
    assert u.submit(1, 2, 3) == 2             # third word refused
    assert u.peek(UartRegs.txfifo) >> 31 == 1  # full flag
    for _ in range(2):
        u.receive(u.transmit())
    assert u.receive([0] + [1] * 8 + [1]) is False   # rx full drops
    assert u.peek(UartRegs.rxfifo) == 1       # nonblocking dequeue
    assert u.peek(UartRegs.rxfifo) == 2
    assert u.peek(UartRegs.rxfifo) >> 31 == 1  # empty flag


def test_four_wire_flow_control():
    u = DspBlockUart(full())
    u.poke(UartRegs.txctrl, 1)
    u.poke(UartRegs.rxctrl, 1)
    u.poke(UartRegs.wire4, 0b01)              # enwire4: CTS/RTS mode
    u.submit(0xAB)
    u.set_cts(1)                              # peer not ready
    assert u.transmit() is None               # TX gated on CTS
    u.set_cts(0)
    assert u.transmit() is not None
    # RTS follows RX-FIFO room in four-wire mode
    assert u.rts_n == 0
    small = DspBlockUart(UartParams(include_four_wire=True, n_rx_entries=1))
    small.poke(UartRegs.rxctrl, 1)
    small.poke(UartRegs.wire4, 0b01)
    small.receive([0] + [1] * 8 + [1])
    assert small.rts_n == 1                   # full → deassert


def test_rs485_rts_polarity():
    u = DspBlockUart(full())
    u.poke(UartRegs.txctrl, 1)
    u.poke(UartRegs.wire4, 0b00)              # RS-485: rts = tx_busy ^ invpol
    assert u.rts_n == 0
    u.poke(UartRegs.wire4, 0b10)              # invpol
    assert u.rts_n == 1
    # disabled TX never reports busy
    m = DspBlockUart(UartParams(include_four_wire=True))
    assert m.rts_n == 0
    m.submit(1)
    m.transmit()                              # txen=0: gated, not busy
    assert m.rts_n == 0

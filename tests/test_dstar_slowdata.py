"""D-STAR slow-data message formats: radio text (0x40), DPRS/APRS
position ($$CRC fixed form) — constructed 480-bit fields (reference
dstar_slow_data.c)."""

import numpy as np

from dsdneo_tpu.protocol.base import DecoderContext
from dsdneo_tpu.protocol.dstar.decoder import SD_SCRAMBLE, DstarDecoder


def _bits_from_bytes(sd_bytes):
    """Inverse of DstarDecoder._slow_data's descramble/reverse/pack."""
    sd2 = np.zeros(480, dtype=np.uint8)
    for i in range(60):
        b = int(sd_bytes[59 - i])
        for k in range(8):
            sd2[i * 8 + k] = (b >> (7 - k)) & 1
    sd1 = sd2[::-1]
    return sd1 ^ np.tile(SD_SCRAMBLE, 20)


def _decode(sd_bytes):
    ctx = DecoderContext()
    line = DstarDecoder()._slow_data(_bits_from_bytes(sd_bytes), ctx)
    return line, ctx


def test_radio_text_message():
    sd = np.zeros(60, dtype=np.uint8)
    sd[0] = 0x40
    msg = "HELLO FROM DSDNEO GPU"
    j = 0
    for i in range(1, 59):
        if i % 6 == 0:
            continue
        if j < len(msg):
            sd[i] = ord(msg[j])
            j += 1
    line, ctx = _decode(sd)
    assert "SLOW DATA TEXT:" in line
    assert "HELLO FROM DSDNEO GPU" in line
    assert ctx.state.dstar_text.startswith("HELLO")


def test_dprs_aprs_position():
    sd = np.zeros(60, dtype=np.uint8)
    sd[0] = 0x35
    # payload stream with block-header bytes every 6th position;
    # the APRS body carries '!' at collected position 30-39 then
    # ddmm.ssN/dddmm.ssW
    body = " " * 25 + "!4217.93N/07148.65W>"
    k = 0
    for i in range(1, 60):
        if i % 6 == 0:
            continue
        if i in (1, 2, 3, 4, 5):
            sd[i] = ord("$$CRC "[i - 1])
        elif k < len(body):
            sd[i] = ord(body[k])
        if i > 5:
            k += 1
    line, ctx = _decode(sd)
    assert "APRS - Lat: 42d 17m 93s N" in line
    assert "Lon: 071d 48m 65s W" in line
    assert ctx.state.dstar_gps.startswith("APRS")


def test_unknown_type_safe():
    sd = np.full(60, 0xAA, dtype=np.uint8)
    line, _ = _decode(sd)
    assert line == "SLOW DATA"

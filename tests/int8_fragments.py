"""Numpy emulation of the int8 widening the Hopper int8 kernels share
(``widen2`` in ``csrc/int8_matmul_decode_sm90.cu`` and
``csrc/int8_matmul_prefill_sm90.cu``, whose two entries use it), for their
lane-by-lane tests."""

import numpy as np


def bf16_bits_to_f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def byte_perm(a, b, sel):
    """CUDA __byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of
    the 8 bytes of (b:a)."""
    src = (b.astype(np.uint64) << 32) | a.astype(np.uint64)
    out = np.zeros_like(a, dtype=np.uint32)
    for i in range(4):
        byte = (src >> np.uint64(8 * ((sel >> (4 * i)) & 7))) & np.uint64(0xFF)
        out |= (byte.astype(np.uint32) << np.uint32(8 * i))
    return out


def widen2(B, w0, w1):
    """The kernels' widen2 of byte B of w0 and w1: the two bf16 lanes (low,
    high) as floats."""
    return widen_permuted(byte_perm(w0, w1, B | ((B + 4) << 8)))


def widen_permuted(p):
    """widen2 after its byte permute: bytes 0 and 2 of ``p`` (int8) as the
    low and high bf16 lanes, through the masks, the 0x43004300 magic and
    one bf16x2 FMA; returns the two lanes as floats."""
    hi = (p & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    lo = (p & np.uint32(0x00800080)) | np.uint32(0x43004300)
    halves = []
    for shift in (0, 16):                     # fma.rn.bf16x2: lo * -1 + hi, per lane
        h = bf16_bits_to_f32((hi >> np.uint32(shift)) & np.uint32(0xFFFF))
        l_ = bf16_bits_to_f32((lo >> np.uint32(shift)) & np.uint32(0xFFFF))
        d = h - l_
        assert (d == d.astype(np.int32)).all() and (np.abs(d) <= 128).all()   # exact in bf16
        halves.append(d)
    return halves

"""pypolar — drop-in compatible API over the polar_codes_tpu framework.

Mirrors the reference's pybind11 module surface
(/root/reference/python/bindings/python_bindings.cc:24-31 and
python/__init__.py): `PolarEncoder`, `PolarDecoder`, `Detector`,
`Puncturer`, `frozen_bits` with identical constructor signatures, method
names, packed-byte numpy conventions (np.packbits MSB-first), and the
reference's decoder-type strings {"char","float","mixed","scan"}
(decoder.cpp:26-87 mapping, including the default CRC8 and the listSize<2
float fallback). The reference's qa_pypolar_* unittest suites are the
conformance target.

Single-vector calls are the reference's interface; every method here also
accepts a batched 2-D array as an extension for accelerator batching.
"""

from __future__ import annotations

import numpy as np

from polar_codes_tpu.construction import frozen_bits as _frozen_bits
from polar_codes_tpu.models import detectors as _det
from polar_codes_tpu.models.encoder import PolarEncoder as _Encoder
from polar_codes_tpu.models.fastssc import FastSSCDecoder
from polar_codes_tpu.models.scl import SCLDecoder
from polar_codes_tpu.models.adaptive import AdaptiveDecoder
from polar_codes_tpu.models.scan import ScanDecoder
from polar_codes_tpu.models.puncturer import Puncturer as _Puncturer

# pure-python re-export, as in the reference package __init__
# (python/__init__.py: from .frozen_bit_positions import ...)
from polar_codes_tpu.tools.strategies import get_frozen_bit_generator

# Above this block length PolarDecoder switches from the trace-time
# unrolled trees to the scan-over-schedule decoders (models/large.py):
# XLA program size for the unrolled trees grows linearly with N and
# compilation dominates beyond ~16k.
_LARGE_N_THRESHOLD = 16384

__all__ = [
    "PolarEncoder",
    "PolarDecoder",
    "Detector",
    "Puncturer",
    "frozen_bits",
    "get_frozen_bit_generator",
]


def frozen_bits(blockLength, infoLength, designSNR, constructorType="BB"):
    """Frozen-bit construction (frozen_bits_python.cc:24-30)."""
    return [int(i) for i in
            _frozen_bits(blockLength, infoLength, designSNR, constructorType)]


def _as_1d_uint8(array, name="input"):
    a = np.asarray(array, dtype=np.uint8)
    if a.ndim != 1:
        raise RuntimeError("Only ONE-dimensional vectors allowed!")
    return a


class Detector:
    """ErrorDetection facade (detector_python.cc:20-77)."""

    def __init__(self, size, type="crc"):
        self._d = _det.make_detector(size, type)

    def getCheckBitCount(self):
        return self._d.bits

    def getType(self):
        """Family string, matching the reference's per-class getType():
        crc8/16/32 -> "CRC", all 5G-NR CRCs -> "CRCNR", CMAC -> "CMAC",
        dummy -> "DUMMY" (crc6nr.h:34, crc32.h:34, cmac.h:44, dummy.cpp:22)."""
        name = self._d.name
        if "cmac" in name:
            return "CMAC"
        if "dummy" in name:
            return "DUMMY"
        return "CRCNR" if "nr" in name else "CRC"

    def calculate(self, data, bitsize):
        """Checksum value over the first `bitsize` bits of `data`."""
        data = np.asarray(data, dtype=np.uint8)
        bits = np.unpackbits(data)
        if bits.size < bitsize:
            raise RuntimeError(
                "Provided number of bits is smaller than stated significant "
                "bits!"
            )
        bits = bits[:bitsize]
        d = self._d
        if isinstance(d, _det.CRC32):
            if bitsize % 8:
                raise RuntimeError("CRC32 operates on whole bytes")
            return _det.crc32c_bytes(np.packbits(bits).tobytes())
        if isinstance(d, _det.CMAC):
            value_bits = d.compute_np(bits)
            return int("".join(map(str, value_bits)), 2)
        # native C++ engine when built (native/hostcodec.cpp), NumPy fallback
        from polar_codes_tpu.utils import hostcodec

        return hostcodec.crc_msb_first(bits, d.poly, d.bits, d.init)

    def generate(self, data):
        """Append the checksum bytes to `data` (detector_python.cc:46-65)."""
        data = _as_1d_uint8(data)
        crc_bytes = (self._d.bits + 7) // 8 if self._d.bits % 8 else (
            self._d.bits // 8
        )
        out = np.concatenate([data, np.zeros(crc_bytes, np.uint8)])
        bits = np.unpackbits(out)
        return np.packbits(self._d.generate_np(bits))

    def check(self, data):
        data = _as_1d_uint8(data)
        return bool(self._d.check_np(np.unpackbits(data)))


class PolarEncoder:
    """Systematic packed-byte encoder (encoder_python.cc:24-61)."""

    def __init__(self, blockLength, frozenBitPositions):
        self._n = int(blockLength)
        self._frozen = sorted(int(i) for i in frozenBitPositions)
        self._systematic = True
        self._detector = _det.Dummy()
        self._enc = None
        self._fn = None
        self._duration_ns = 0

    # -- config --

    def blockLength(self):
        return self._n

    def infoLength(self):
        return self._n - len(self._frozen)

    def setSystematic(self, flag):
        self._systematic = bool(flag)
        self._enc = None

    def isSystematic(self):
        return self._systematic

    def frozenBits(self):
        return list(self._frozen)

    def setErrorDetection(self, size=0, type="crc"):
        self._detector = _det.make_detector(size, type)
        self._enc = None

    def getErrorDetectionMode(self):
        return self._detector.name

    # -- encoding --

    def _build(self):
        if self._enc is None:
            import jax

            self._enc = _Encoder(
                self._n,
                self._frozen,
                systematic=self._systematic,
                detector=self._detector,
            )
            self._fn = jax.jit(self._enc.encode)
        return self._enc

    def duration_ns(self):
        """Wall-clock ns of the last encode_vector call
        (Encoder::duration_ns, encoder.h:59). This includes the fixed
        per-call dispatch overhead; use polar_codes_tpu.utils.timing for
        device-accurate kernel timing."""
        return self._duration_ns

    def encode_vector(self, info_bytes):
        """uint8[K/8] packed info -> uint8[N/8] packed codeword.

        Also accepts uint8[batch, K/8].

        Reference semantics: with error detection enabled, the generated
        CRC is written back INTO the caller's info buffer — the C++
        Detector::generate mutates xmInputData, which pybind11 hands the
        numpy buffer itself when it is already 1-D uint8 c-contiguous
        (butterfly_fip_packed.cpp:48, encoder_python.cc:45-61). The
        reference qa_pypolar_decoder suite depends on that mutation.
        """
        import time as _time

        enc = self._build()
        _t0 = _time.perf_counter_ns()
        arr = np.asarray(info_bytes, dtype=np.uint8)
        single = arr.ndim == 1
        if single and arr.size != enc.info_length // 8:
            raise RuntimeError("Input vector size != infoSize // 8!")
        bits = np.unpackbits(arr, axis=-1)[..., : enc.info_length]
        if self._detector.tail_bits:
            bits = self._detector.generate_np(bits)
            # mutate the caller's buffer exactly when pybind11 would have
            # passed it through without a forcecast copy
            if (
                isinstance(info_bytes, np.ndarray)
                and info_bytes.dtype == np.uint8
                and info_bytes.flags.c_contiguous
                and info_bytes.flags.writeable
                and enc.info_length % 8 == 0
            ):
                info_bytes[...] = np.packbits(bits, axis=-1).reshape(
                    info_bytes.shape
                )
        code = np.asarray(self._fn(bits))
        out = np.packbits(code, axis=-1)
        self._duration_ns = _time.perf_counter_ns() - _t0
        return out


class PolarDecoder:
    """Flexible decoder facade (decoder_python.cc:20-74); type strings and
    defaults follow Decoding::create (decoder.cpp:26-87)."""

    def __init__(self, blockLength, listSize, frozenBitPositions, decoderType):
        self._n = int(blockLength)
        self._list = int(listSize)
        self._frozen = sorted(int(i) for i in frozenBitPositions)
        t = decoderType.lower()
        if "char" in t:
            self._flag = 0
        elif "float" in t:
            self._flag = 1
        elif "mixed" in t:
            self._flag = 2
        elif "scan" in t:
            self._flag = 3
        else:
            raise RuntimeError("Unknown PolarDecoder type!")
        if self._list < 2 and self._flag != 0:
            self._flag = 1
        self._systematic = True
        self._detector = _det.CRC8()  # makeDecoder default (decoder.cpp:86)
        self._dec = None
        self._fn = None
        self._duration_ns = 0

    def blockLength(self):
        return self._n

    def infoLength(self):
        return self._n - len(self._frozen)

    def listSize(self):
        return self._list

    def setSystematic(self, flag):
        self._systematic = bool(flag)
        self._dec = None

    def isSystematic(self):
        return self._systematic

    def frozenBits(self):
        return list(self._frozen)

    def setErrorDetection(self, size=0, type="crc"):
        self._detector = _det.make_detector(size, type)
        self._dec = None

    def getErrorDetectionMode(self):
        return self._detector.name

    def _build(self):
        if self._dec is not None:
            return self._dec
        import jax
        import jax.numpy as jnp

        n, frozen, lst = self._n, self._frozen, self._list
        kw = dict(systematic=self._systematic, detector=self._detector)
        if n > _LARGE_N_THRESHOLD:
            # beyond the unrolled-tree compile budget: scan-over-schedule
            # decoders (models/large.py) with O(chunk + log N) programs
            from polar_codes_tpu.models.large import (
                LargeSCDecoder,
                LargeSCLDecoder,
            )

            dtype = jnp.int8 if self._flag == 0 else jnp.float32
            if lst == 1:
                self._dec = LargeSCDecoder(n, frozen, dtype=dtype, **kw)
            else:
                self._dec = LargeSCLDecoder(
                    n, frozen, list_size=lst, dtype=dtype, **kw
                )
        elif lst == 1:
            dtype = jnp.float32 if self._flag == 1 else jnp.int8
            self._dec = FastSSCDecoder(n, frozen, dtype=dtype, **kw)
        elif self._flag == 3:
            self._dec = ScanDecoder(n, frozen, iterations=lst, **kw)
        elif self._flag == 2 and self._detector.tail_bits:
            self._dec = AdaptiveDecoder(n, frozen, list_size=lst, **kw)
        else:
            # flag 0 = SclFipChar (int8), flag 1 = SclAvxFloat
            # (Decoding::makeDecoder, decoder.cpp:54-87)
            dtype = jnp.int8 if self._flag == 0 else jnp.float32
            self._dec = SCLDecoder(n, frozen, list_size=lst, dtype=dtype,
                                   **kw)
        if getattr(self._dec, "decode_is_host_orchestrated", False):
            self._fn = self._dec.decode
        else:
            self._fn = jax.jit(self._dec.decode)
        return self._dec

    def duration_ns(self):
        """Wall-clock ns of the last decode_vector call
        (Decoder::duration_ns, decoder.h:82). This includes the fixed
        per-call dispatch overhead; use polar_codes_tpu.utils.timing for
        device-accurate kernel timing."""
        return self._duration_ns

    def decode_vector(self, llrs):
        """float32/int8 [N] channel LLRs -> uint8[K/8] packed info bits.

        Also accepts [batch, N]. Sign convention: positive LLR = bit 0."""
        import time as _time

        dec = self._build()
        _t0 = _time.perf_counter_ns()
        arr = np.asarray(llrs)
        if arr.shape[-1] != self._n:
            raise RuntimeError("Input vector size != blockSize!")
        if getattr(dec, "dtype", None) is not None and dec.dtype == np.int8:
            arr = np.clip(np.round(arr), -127, 127).astype(np.int8)
        else:
            arr = arr.astype(np.float32)
        info, _, _ = self._fn(arr)
        out = np.packbits(np.asarray(info), axis=-1)
        self._duration_ns = _time.perf_counter_ns() - _t0
        return out


class Puncturer:
    """Rate-matcher facade (puncturer_python.cc:21-150)."""

    def __init__(self, blockLength, frozenBitPositions):
        self._p = _Puncturer(blockLength, [int(i) for i in frozenBitPositions])

    def blockLength(self):
        return self._p.block_length

    def parentBlockLength(self):
        return self._p.parent_block_length

    def blockOutputPositions(self):
        return [int(i) for i in self._p.output_positions]

    def puncture(self, array):
        arr = np.asarray(array)
        if arr.shape[-1] != self._p.parent_block_length:
            raise RuntimeError("Input vector size != parentBlockSize!")
        return arr[..., self._p.output_positions]

    def puncturePacked(self, array):
        arr = np.asarray(array, dtype=np.uint8)
        if arr.shape[-1] != self._p.parent_block_length // 8:
            raise RuntimeError("Input vector size != parentBlockSize!")
        return self._p.puncture_packed(arr)

    def depuncture(self, array):
        arr = np.asarray(array)
        if arr.shape[-1] != self._p.block_length:
            raise RuntimeError("Input vector size != blockSize!")
        out_shape = arr.shape[:-1] + (self._p.parent_block_length,)
        out = np.zeros(out_shape, dtype=arr.dtype)
        out[..., self._p.output_positions] = arr
        return out

    def depuncturePacked(self, array):
        arr = np.asarray(array, dtype=np.uint8)
        bits = np.unpackbits(arr, axis=-1)[..., : self._p.block_length]
        return np.packbits(self.depuncture(bits), axis=-1)

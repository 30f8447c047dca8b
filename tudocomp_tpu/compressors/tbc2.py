"""The flagship TBC2 device codec as a registered compressor.

``tbc2`` wraps ``models/blockcodec.BlockCodec`` (per-segment device RLE
+ shared canonical Huffman, self-describing TBC2 container) so the
flagship pipeline is reachable from the algorithm string and the CLI
like every other module — ``tdc -a "tbc2(min_code_len=4)" FILE``.

Options cover everything that changes *bytes or decode behavior*:

- ``offset``        RLE run-length bias (container header field)
- ``min_code_len``  Huffman minimum code length, 3..8 (trades payload
                    size against device decode slot count)
- ``dec``           decoder: ``auto`` (the device on the GPU, the
                    native host decoder on the CPU) | ``device`` |
                    ``host``

``TDC_MIN_CODE_LEN`` overrides ``min_code_len``. The device kernels are
chosen by ``backend.py``.

Reference counterpart: none (the reference is single-core C++); this
is the BASELINE.json config-1/2 pipeline (rle:encode(huff)) re-designed
for a data-parallel device.
"""

from __future__ import annotations

from tudocomp_tpu.compressors.base import Compressor
from tudocomp_tpu.meta import Meta
from tudocomp_tpu.stats import StatPhase


class TBC2Compressor(Compressor):
    @classmethod
    def meta(cls):
        m = Meta(
            "compressor",
            "tbc2",
            "device segment codec: per-segment RLE + shared canonical "
            "Huffman (TBC2 container; models/blockcodec.py)",
        )
        m.option_dynamic("offset", 0)
        m.option_dynamic("min_code_len", 3)
        m.option_dynamic("dec", "auto")
        return m

    def _codec(self):
        from tudocomp_tpu.models.blockcodec import BlockCodec

        return BlockCodec(
            offset=self.env.option("offset").as_int(),
            min_code_len=self.env.option("min_code_len").as_int(),
        )

    def decoder(self) -> str:
        """The decoder ``decompress`` runs: ``"host"`` (native spec
        path) or the device kernel ``backend.tbc2_decoder`` picks."""
        from tudocomp_tpu import backend

        dec = self.env.option("dec").as_string()
        if dec in ("pallas", "scan"):  # kernel names older headers carry
            dec = "device"
        if dec not in ("auto", "device", "host"):
            raise ValueError(f"tbc2: unknown dec={dec!r}")
        if dec == "host" or (
            dec == "auto" and not backend.decode_on_device()
        ):
            return "host"
        return backend.tbc2_decoder()

    def compress(self, data: bytes) -> bytes:
        return self._codec().compress(data)

    def decompress(self, data: bytes) -> bytes:
        codec = self._codec()
        decoder = self.decoder()
        StatPhase.log("tbc2 decoder", decoder)
        if decoder == "host":
            return codec.decompress(data)
        return codec.decompress_device(data)

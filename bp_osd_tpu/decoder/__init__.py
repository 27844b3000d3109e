"""Batched BP+OSD decoding under XLA (the hot path of the framework)."""

from .bp import BPResult, bp_decode, llr_from_channel
from .bposd import BpDecoder, BpOsdDecoder, bp_decoder, bposd_decoder
from .layered import LayeredTannerGraph, bp_decode_layered
from .osd import OsdResult, osd_decode
from .tanner import TannerGraph

__all__ = [
    "TannerGraph",
    "BPResult",
    "bp_decode",
    "llr_from_channel",
    "OsdResult",
    "osd_decode",
    "BpDecoder",
    "BpOsdDecoder",
    "bp_decoder",
    "bposd_decoder",
    "LayeredTannerGraph",
    "bp_decode_layered",
]

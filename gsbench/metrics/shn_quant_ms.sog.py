"""Ms a conversion in the SOG writer's stage sog.shN_quant_u8 (the shN u8 pre-quantization in the splats' order)."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("convert",), "sog.shN_quant_u8")

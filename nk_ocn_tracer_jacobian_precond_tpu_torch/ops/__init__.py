from .assemble import Assembly, assemble_jacobian
from .options import AssemblyOptions, PerTracerOptions
from .offsets import FACE_OFFSETS, ADV2_OFFSETS, ISOP_OFFSETS

__all__ = [
    "Assembly",
    "assemble_jacobian",
    "AssemblyOptions",
    "PerTracerOptions",
    "FACE_OFFSETS",
    "ADV2_OFFSETS",
    "ISOP_OFFSETS",
]

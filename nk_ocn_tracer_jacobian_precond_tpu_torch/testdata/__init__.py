from .synthetic import (
    make_circ_file,
    make_region_file,
    make_synthetic_grid,
    make_tracer_file,
)

__all__ = [
    "make_circ_file",
    "make_region_file",
    "make_synthetic_grid",
    "make_tracer_file",
]

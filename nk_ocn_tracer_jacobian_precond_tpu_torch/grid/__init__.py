from .grid import Grid, load_grid, grid_vars_for_output
from .indmap import IndexMaps, gen_ind_maps, ind_map_vars_for_output, load_ind_maps

__all__ = [
    "Grid",
    "load_grid",
    "grid_vars_for_output",
    "IndexMaps",
    "gen_ind_maps",
    "ind_map_vars_for_output",
    "load_ind_maps",
]

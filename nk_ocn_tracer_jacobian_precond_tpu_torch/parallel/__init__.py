from .stencil import StencilOperator
from .mesh import (Mesh, check_world, init_process_group, make_mesh,
                   run_world)

__all__ = ["StencilOperator", "Mesh", "check_world", "init_process_group",
           "make_mesh", "run_world"]

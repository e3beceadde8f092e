from .stencil import StencilOperator
from .mesh import Mesh, init_process_group, make_mesh, run_world

__all__ = ["StencilOperator", "Mesh", "init_process_group", "make_mesh",
           "run_world"]

from .stencil import StencilOperator
from .mesh import Mesh, init_process_group, make_mesh

__all__ = ["StencilOperator", "Mesh", "init_process_group", "make_mesh"]

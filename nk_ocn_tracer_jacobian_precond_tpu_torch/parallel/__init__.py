from .stencil import StencilOperator

__all__ = ["StencilOperator"]

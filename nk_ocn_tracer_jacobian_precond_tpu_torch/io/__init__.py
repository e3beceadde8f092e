from . import netcdf3
from .fields import (
    get_att_double,
    get_var_double,
    get_var_int,
    put_var_inplace,
    var_exists_in_file,
)

__all__ = [
    "netcdf3",
    "get_att_double",
    "get_var_double",
    "get_var_int",
    "put_var_inplace",
    "var_exists_in_file",
]

"""Input-field access for the assembly passes.

The reference re-opens the circulation/tracer NetCDF file for every field it
reads and zeroes _FillValue cells in most of them (src/matrix.c's
get_var + get_att(_FillValue) + set_fv pattern, e.g. matrix.c:1014-1023).
Here that becomes a FieldSource with explicit fv-zeroed and raw accessors;
FileFieldSource parses the header once and streams variables on demand.
"""

from __future__ import annotations

import numpy as np

from ..io import fields, netcdf3


class FileFieldSource:
    def __init__(self, path: str):
        self.path = path
        self.header = netcdf3.read_header(path)

    def exists(self, name: str) -> bool:
        return name in self.header.vars

    def get3(self, name: str) -> np.ndarray:
        return fields.get_var_double(self.path, name, 3, self.header)

    def get2(self, name: str) -> np.ndarray:
        return fields.get_var_double(self.path, name, 2, self.header)

    def get3_fv0(self, name: str) -> np.ndarray:
        return fields.get_field_fv_zeroed(self.path, name, 3, self.header)

    def get2_fv0(self, name: str) -> np.ndarray:
        return fields.get_field_fv_zeroed(self.path, name, 2, self.header)


class DictFieldSource:
    """In-memory source for tests; fields must already be fv-cleaned."""

    def __init__(self, data: dict[str, np.ndarray]):
        self.data = data

    def exists(self, name: str) -> bool:
        return name in self.data

    def get3(self, name: str) -> np.ndarray:
        return np.asarray(self.data[name], dtype=np.float64)

    get3_fv0 = get3

    def get2(self, name: str) -> np.ndarray:
        return np.asarray(self.data[name], dtype=np.float64)

    get2_fv0 = get2

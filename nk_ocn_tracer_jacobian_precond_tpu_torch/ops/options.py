"""Assembly option model, the rebuild of gen_A's two-tier config system.

Mirrors src/gen_A.c: defaults from set_opt_defaults (gen_A.c:95-110), the
per-tracer option block (src/matrix.h:38-49), and the validation rules of
read_opt_file (gen_A.c:114-351). The text option-file parser lives in
drivers/config.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

ADV_CHOICES = ("none", "donor", "centered", "upwind3")
HMIX_CHOICES = ("none", "const", "hor_file", "isop_file")
VMIX_CHOICES = ("none", "const", "file", "matrix_file")
SINK_CHOICES = ("none", "const", "const_shallow", "file", "generic_tracer")
COUPLED_CHOICES = ("none", "OCMIP_BGC_PO4_DOP", "DIC_SHADOW_ALK_SHADOW")

# Tracer names for the two supported coupled systems (src/matrix.c:112-113).
COUPLED_TRACER_NAMES = {
    "OCMIP_BGC_PO4_DOP": ("OCMIP_BGC_PO4", "OCMIP_BGC_DOP"),
    "DIC_SHADOW_ALK_SHADOW": ("DIC_SHADOW", "ALK_SHADOW"),
}


@dataclass
class PerTracerOptions:
    """Defaults from grow_per_tracer_opt (src/gen_A.c:78-88)."""
    sink_type: str = "none"
    sink_rate: float = 1.21e-4        # 1/yr, radiocarbon decay rate
    sink_depth: float = 10.0e2        # cm (10 m)
    sink_field_name: str | None = None
    sink_generic_tracer_name: str | None = None
    sink_generic_tracer_depends_layer_cnt: int = -1
    pv_field_name: str | None = None
    d_SF_d_TRACER_field_name: str | None = None


@dataclass
class AssemblyOptions:
    """Defaults from set_opt_defaults (src/gen_A.c:95-110)."""
    day_cnt: float = 365.0
    reg_fname: str | None = None
    circ_fname: str | None = None
    adv_type: str = "centered"
    l_adv_enforce_divfree: bool = True
    hmix_type: str = "isop_file"
    vmix_type: str = "file"
    tracer_fname: str | None = None
    coupled_tracer_cnt: int = 1
    per_tracer: list[PerTracerOptions] = field(default_factory=lambda: [PerTracerOptions()])
    coupled_tracer_type: str = "none"

    @property
    def delta_t(self) -> float:
        """Seconds in the linearization window (src/matrix.c:3778)."""
        return 60.0 * 60.0 * 24.0 * self.day_cnt

    @property
    def year_cnt(self) -> float:
        """Years in the window, scaling 1/yr decay rates (src/matrix.c:3779)."""
        return self.day_cnt / 365.0

    def validate(self) -> None:
        if self.adv_type not in ADV_CHOICES:
            raise ValueError(f"unknown adv_type: {self.adv_type}")
        if self.hmix_type not in HMIX_CHOICES:
            raise ValueError(f"unknown hmix_type: {self.hmix_type}")
        if self.vmix_type not in VMIX_CHOICES:
            raise ValueError(f"unknown vmix_type: {self.vmix_type}")
        if self.coupled_tracer_type not in COUPLED_CHOICES:
            raise ValueError(f"unknown coupled_tracer_type: {self.coupled_tracer_type}")
        if not (1 <= self.coupled_tracer_cnt <= 2):
            raise ValueError(
                f"coupled_tracer_cnt = {self.coupled_tracer_cnt} not supported")
        if len(self.per_tracer) != self.coupled_tracer_cnt:
            raise ValueError("per_tracer list length != coupled_tracer_cnt")
        if self.coupled_tracer_cnt == 2 and self.coupled_tracer_type == "none":
            # gen_A.c:340-348
            raise ValueError(
                "coupled_tracer_cnt = 2 only supported for coupled_tracer_type "
                "= OCMIP_BGC_PO4_DOP, DIC_SHADOW_ALK_SHADOW")
        if self.hmix_type == "hor_file" and self.adv_type == "upwind3":
            # add_hmix forbids this combination (src/matrix.c:2747-2750)
            raise ValueError("cannot use hmix_hor_file with adv_upwind3")
        for pt in self.per_tracer:
            if pt.sink_type not in SINK_CHOICES:
                raise ValueError(f"unknown sink_type: {pt.sink_type}")

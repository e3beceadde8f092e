"""Option-file parser, rebuild of read_opt_file (src/gen_A.c:114-351).

Format: one "name value" pair per whitespace-separated line. sink_type
takes inline sub-options (rate / depth / field name / generic-tracer name +
optional depends_layer_cnt). The tracer_ind option scopes subsequent
per-tracer options (sink_type, pv, sf) to that tracer. Notable reference
quirk preserved: adv_type "centered" is matched on its first 4 characters
(gen_A.c:172), so "cent", "center", "centered" all parse.
"""

from __future__ import annotations

from ..ops.options import AssemblyOptions, PerTracerOptions


class OptionError(ValueError):
    pass


def parse_opt_file(path: str, opts: AssemblyOptions | None = None) -> AssemblyOptions:
    if opts is None:
        opts = AssemblyOptions()
    with open(path) as fp:
        lines = fp.readlines()
    tracer_ind = 0
    for lineno, line in enumerate(lines, 1):
        toks = line.split()
        if not toks:
            continue
        name = toks[0]
        vals = toks[1:]
        if not vals:
            raise OptionError(f"unspecified value for {name} (line {lineno})")
        v = vals[0]
        if name == "day_cnt":
            opts.day_cnt = float(v)
        elif name == "reg_fname":
            opts.reg_fname = v
        elif name == "circ_fname":
            opts.circ_fname = v
        elif name == "adv_type":
            if v == "none":
                opts.adv_type = "none"
            elif v == "donor":
                opts.adv_type = "donor"
            elif v[:4] == "centered"[:4]:
                opts.adv_type = "centered"
            elif v == "upwind3":
                opts.adv_type = "upwind3"
            else:
                raise OptionError(f"unknown adv_type: {v}")
        elif name == "l_adv_enforce_divfree":
            if v not in ("0", "1"):
                raise OptionError(f"unknown l_adv_enforce_divfree: {v}")
            opts.l_adv_enforce_divfree = v == "1"
        elif name == "hmix_type":
            if v not in ("none", "const", "hor_file", "isop_file"):
                raise OptionError(f"unknown hmix_type: {v}")
            opts.hmix_type = v
        elif name == "vmix_type":
            if v not in ("none", "const", "file", "matrix_file"):
                raise OptionError(f"unknown vmix_type: {v}")
            opts.vmix_type = v
        elif name == "tracer_fname":
            opts.tracer_fname = v
        elif name == "coupled_tracer_cnt":
            new_cnt = int(v)
            while len(opts.per_tracer) < new_cnt:
                opts.per_tracer.append(PerTracerOptions())
            opts.coupled_tracer_cnt = new_cnt
            if not (1 <= new_cnt <= 2):
                raise OptionError(f"coupled_tracer_cnt = {new_cnt} not supported")
        elif name == "tracer_ind":
            tracer_ind = int(v)
            if not (0 <= tracer_ind < opts.coupled_tracer_cnt):
                raise OptionError(
                    f"tracer_ind = {tracer_ind} out of bounds for "
                    f"coupled_tracer_cnt = {opts.coupled_tracer_cnt}")
        elif name == "sink_type":
            pt = opts.per_tracer[tracer_ind]
            if v not in ("none", "const", "const_shallow", "file", "generic_tracer"):
                raise OptionError(f"unknown sink_type: {v}")
            pt.sink_type = v
            rest = vals[1:]
            if v in ("const", "const_shallow"):
                if not rest:
                    raise OptionError("unspecified sink_rate")
                pt.sink_rate = float(rest[0])
                if v == "const_shallow":
                    if len(rest) < 2:
                        raise OptionError("unspecified sink_depth")
                    pt.sink_depth = float(rest[1])
            elif v == "file":
                if not rest:
                    raise OptionError("unspecified sink_field_name")
                pt.sink_field_name = rest[0]
            elif v == "generic_tracer":
                if not rest:
                    raise OptionError("unspecified sink_generic_tracer_name")
                pt.sink_generic_tracer_name = rest[0]
                if len(rest) > 1:
                    pt.sink_generic_tracer_depends_layer_cnt = int(rest[1])
        elif name == "pv":
            opts.per_tracer[tracer_ind].pv_field_name = v
        elif name == "sf":
            opts.per_tracer[tracer_ind].d_SF_d_TRACER_field_name = v
        elif name == "coupled_tracer_type":
            if v not in ("none", "OCMIP_BGC_PO4_DOP", "DIC_SHADOW_ALK_SHADOW"):
                raise OptionError(f"unknown coupled_tracer_type: {v}")
            opts.coupled_tracer_type = v
        else:
            raise OptionError(f"unknown option name: {name}")
    opts.validate()
    return opts

"""The port's multi-rank dry run (parallel/dryrun.py) and its entry points
(entry.py), against the JAX package's ``__graft_entry__.py``.

``dryrun_multichip(2, "cpu")`` starts a gloo world of 2 ranks that runs
the whole distributed workflow (the transport matrix to 1e-10 with sharded
rounds, the upwind3 secondary against SuperLU's residual, the band-sharded
stencil against the single-device apply, and the forced 32x24x12 case:
chunked, row-sharded, masked, factor-only and streamed); each check
raises in the rank that fails it, and the first rank prints the summary.
``entry`` is the JAX ``entry()``'s forward step on the same float32 field.
"""

import re

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nk_ocn_tracer_jacobian_precond_tpu_torch import entry
from nk_ocn_tracer_jacobian_precond_tpu_torch.parallel import dryrun, make_mesh


def test_dryrun_on_two_gloo_ranks(capfd):
    entry.dryrun_multichip(2, "cpu")
    out = capfd.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("dryrun ok"))
    assert line.startswith("dryrun ok: 2 devices, ")
    assert int(re.search(r"(\d+) sharded factor rounds", line)[1]) >= 1
    assert int(re.search(r"(\d+) row-sharded", line)[1]) >= 1
    assert int(re.search(r"(\d+) masked-substitution", line)[1]) >= 1
    chunked, default = map(int, re.search(
        r"(\d+) chunked rounds \((\d+) default\)", line).groups())
    assert chunked > default
    for key in ("transport-matrix residual", "front-sharded residual",
                "streamed-rounds residual"):
        assert float(re.search(key + r" ([0-9.e+-]+)", line)[1]) <= 1e-10


def test_dryrun_refuses_what_it_cannot_run():
    """More cards than there are (none here; one on the card's machine),
    and a mesh of one rank, which shards nothing."""
    with pytest.raises(ValueError, match="requested 2 devices, have "):
        dryrun.main(["2", "--device", "cuda"])
    with pytest.raises(ValueError, match="at least 2 ranks"):
        dryrun.run(make_mesh(1, ("front",)), "cpu")


def test_entry_matches_jax_entry():
    """The forward step and its field against the JAX entry() at float32
    tolerance (the field is float32 in both; the operator's fields are
    float64 in both, so the products are float64)."""
    fwd, (x,) = entry.entry(torch.device("cpu"))
    jfwd, (jx,) = graft.entry()
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    y, jy = fwd(x).numpy(), np.asarray(jfwd(jx))
    assert y.shape == jy.shape
    np.testing.assert_allclose(y, jy, rtol=1e-6,
                               atol=1e-6 * np.abs(jy).max())

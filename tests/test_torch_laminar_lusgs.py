"""The laminar implicit step with LU_SGS (the flow's 13 x 13 system through
the multicolor sweep) against su2_tpu over 3 iterations.  A file of its
own: su2_tpu traces its one-launch _fgmres_call at v = 13 in interpret
mode for about two minutes, and with --dist loadfile the file runs on a
worker of its own."""

import pytest

import test_torch_laminar as tl


@pytest.mark.parametrize("run_id", ["implicit-lusgs"])
def test_laminar_run_matches_jax(tmp_path, run_id):
    """EULER_IMPLICIT with MUSCL and the Venkatakrishnan limiter, FGMRES
    with LU_SGS: su2_tpu's one-launch FGMRES at v = 13 in interpret mode,
    the port's plain one-launch solve (stencil_solve.solve_tier's f64
    tier), from the mixed state; rtol 1e-9, atol 1e-12 max|field|."""
    text = tl.laminar_text(tmp_path, implicit=(True, "VENKATAKRISHNAN"),
                           prec="LU_SGS")
    tl.run_matches_jax(text, True)

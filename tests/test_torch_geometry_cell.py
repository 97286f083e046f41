"""Ions + cell relaxation of bcc Li (Smargiassi-Madden + PBE, 10^3) from
the sheared cell of tests/test_geometry.py, in the port against the JAX
package: the check and its tolerances are in tests/test_torch_geometry.py
(the first 3 steps at rtol 1e-8, the converged state judged by the
reference's own forces and stress at rtol 1e-9)."""

from test_torch_geometry import check_relaxation_matches_jax


def test_optimize_geometry_ions_and_cell_matches_jax(tmp_path):
    check_relaxation_matches_jax(tmp_path, stol=0.003)

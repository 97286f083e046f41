"""Physical constants and unit conversions (2018 CODATA).

Same values as ``professad_tpu.utils.constants``.
"""

M_PER_BOHR = 5.29177210903e-11
A_PER_B = M_PER_BOHR * 1e10  # Angstrom per bohr

J_PER_HA = 4.3597447222071e-18
EV_PER_HA = J_PER_HA / 1.602176634e-19

GPA_PER_ATOMIC = J_PER_HA / M_PER_BOHR**3 * 1e-9

# Legacy constants used by CASTEP-style recpot files (slightly different,
# older values on purpose: they are what the recpot format was written with)
RECPOT_BOHR = 0.529177208607388
RECPOT_HARTREE_TO_EV = 27.2113834279111
RECPOT_POT_CONV = 1.0 / (RECPOT_BOHR**3 * RECPOT_HARTREE_TO_EV)

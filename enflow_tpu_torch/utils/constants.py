"""Physical constants and the Lennard-Jones (argon) reduced unit system.

A copy of ``enflow_tpu/utils/constants.py`` (the port imports nothing of the
JAX package). Parity with reference ``enflow/utils/constants.py:1-7``. The reference pulls the
argon atomic weight from RDKit (``Chem.GetPeriodicTable().GetAtomicWeight('Ar')``);
RDKit is not a dependency here, so the same IUPAC value is hardcoded.
"""

# Argon LJ parameters define the reduced unit system.
M = 39.948          # argon atomic weight, amu (reference constants.py:2 via RDKit)
sigma = 3.4e-10     # LJ length scale, m (reference constants.py:3)
eps = 0.238e3       # LJ energy scale, J/mol (reference constants.py:4)
kB = 8.3144621      # Boltzmann/gas constant, J/(K mol) (reference constants.py:5)

# Fixed one-hot atom-type vocabulary (reference constants.py:7).
atom_types = {'H': 0, 'C': 1, 'N': 2, 'O': 3, 'F': 4}

# Element symbols indexed for mass-based element guessing
# (reference ``enflow/utils/helpers.py:31-41`` references an undefined global
# ``ELEMENTS`` — a latent bug; here the table actually exists).
# Index convention kept from the reference: ``ELEMENTS[round(mass)//2]`` for
# masses 2..35 (He..Cl), which works because Z ~ A/2 for light elements.
ELEMENTS = [
    'n', 'H', 'He', 'Li', 'Be', 'B', 'C', 'N', 'O', 'F', 'Ne',
    'Na', 'Mg', 'Al', 'Si', 'P', 'S', 'Cl', 'Ar',
]

# Standard atomic masses (amu) for the supported vocabulary, used for
# Maxwell-Boltzmann velocity sampling and element guessing.
ATOMIC_MASSES = {
    'H': 1.008, 'He': 4.0026, 'Li': 6.94, 'Be': 9.0122, 'B': 10.81,
    'C': 12.011, 'N': 14.007, 'O': 15.999, 'F': 18.998, 'Ne': 20.180,
    'Na': 22.990, 'Mg': 24.305, 'Al': 26.982, 'Si': 28.085, 'P': 30.974,
    'S': 32.06, 'Cl': 35.45, 'Ar': 39.948,
}

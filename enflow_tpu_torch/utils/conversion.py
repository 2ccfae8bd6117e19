"""Conversions between laboratory units and LJ (argon) reduced units.

A copy of ``enflow_tpu/utils/conversion.py`` (the port imports nothing of the
JAX package). All functions are pure and operate on Python floats, NumPy
arrays, or torch tensors alike.

Reduced-unit definitions (argon): length ``sigma``, energy ``eps``, mass ``M``;
the derived time unit is ``sigma*sqrt(M/eps)`` and velocity ``sqrt(eps/M)``.

Deviations from the reference (deliberate bug fixes):
- ``vel_to_lj``/``lj_to_vel`` with ``unit2='femto'`` use ``b=1e-15``. The
  reference has ``b=1e-12`` in both branches (copy-paste bug,
  reference conversion.py:35,61).
"""

import math

from .constants import sigma, eps, kB, M

_TIME_UNITS = {'pico': 1e-12, 'femto': 1e-15}
_DIST_UNITS = {'ang': 1e-10, 'nm': 1e-9}


def meter_to_lj(x):
    return x / sigma


def meter_per_sec_to_lj(x):
    return x * math.sqrt(M / eps)


def amu_to_lj(m):
    return m / M


def second_to_lj(t):
    return t * math.sqrt(eps / M) / sigma


def time_to_lj(t, unit='pico'):
    return second_to_lj(t * _TIME_UNITS[unit])


def lj_to_time(t_, unit='pico'):
    return t_ * sigma / math.sqrt(eps / M) / _TIME_UNITS[unit]


def dist_to_lj(x, unit='ang'):
    return meter_to_lj(x * _DIST_UNITS[unit])


def vel_to_lj(x, unit1='ang', unit2='pico'):
    a = _DIST_UNITS[unit1]
    b = _TIME_UNITS[unit2]
    return meter_per_sec_to_lj(x * a / b)


def kelvin_to_lj(T):
    return T * kB / eps


def lj_to_kelvin(kBT):
    return kBT * eps / kB


def lj_to_meter(x_):
    return x_ * sigma


def lj_to_meter_per_sec(x):
    return x * math.sqrt(eps / M)


def lj_to_dist(x_, unit='ang'):
    return lj_to_meter(x_) / _DIST_UNITS[unit]


def lj_to_vel(x_, unit1='ang', unit2='pico'):
    a = _DIST_UNITS[unit1]
    b = _TIME_UNITS[unit2]
    return lj_to_meter_per_sec(x_) * b / a


# ---------------------------------------------------------------------------
# Dimensionally-correct time conversion for MD.
#
# The reference's reduced time/velocity scale ``sqrt(eps/M)`` mixes molar
# energy (J/mol) with per-particle mass (amu = g/mol), leaving a residual
# factor sqrt(1000 g/kg): physically, sqrt(eps/(M*1e-3 kg/mol)) has units of
# m/s. Everything in the reference is *self-consistent* in its convention
# (velocities, dt, kelvin_to_lj), so flow/NLL parity keeps the plain
# functions above. The MD *dynamics*, however, should advance real time the
# way OpenMM does (reference simulated.py:110 runs in real units): the
# simulator uses these corrected conversions for dt and friction so that
# "0.004 ps" means the same amount of decorrelation it does in the reference.
# ---------------------------------------------------------------------------

_MOLAR_MASS_FIX = math.sqrt(1000.0)


def second_to_lj_md(t):
    return second_to_lj(t) * _MOLAR_MASS_FIX


def time_to_lj_md(t, unit='pico'):
    return second_to_lj_md(t * _TIME_UNITS[unit])


def vel_to_lj_md(x, unit1='ang', unit2='pico'):
    """Dimensionally-correct velocity to reduced units (lab dist/time)."""
    return vel_to_lj(x, unit1, unit2) / _MOLAR_MASS_FIX


def lj_to_vel_md(x_, unit1='ang', unit2='pico'):
    """Dimensionally-correct reduced velocity back to lab dist/time units."""
    return lj_to_vel(x_, unit1, unit2) * _MOLAR_MASS_FIX

"""Solvated-ligand simulated dataset, the port of
``enflow_tpu/data/lig.py`` (OpenMM/OpenFF-backed, optional).

A SMIRNOFF-parameterized solvated ligand is built and simulated with
OpenMM + OpenFF on the host. They are data-preparation dependencies only:
the frames end in ``append`` as host arrays and reach the driver's device
through ``pad_samples`` like any other dataset's. Without them the dataset
raises the JAX package's ``ImportError`` when it is processed.
"""

from __future__ import annotations

from .datasets import InMemoryDataset, register_dataset

_IMPORT_ERROR = (
    "LIGDataset requires the optional host-side dependencies openmm, "
    "openmmforcefields, and openff-toolkit (reference enflow/data/lig.py). "
    "They are data-prep only; install them on a CPU host, run dataset mode "
    "to produce a processed_file, and train/generate from that cache."
)


@register_dataset("lig")
class LIGDataset(InMemoryDataset):
    def process(self, smiles, force_field, name="ligand", n_conformers=1,
                padding=None, box=None, temp=300.0, n_iter=1000, interval=100,
                discard=-1, dt=0.002, friction=1.0, dist_unit="ang",
                time_unit="pico", log=None, traj=None, **_):
        try:
            import openmm  # noqa: F401
            import openmm.app  # noqa: F401
            from openmmforcefields.generators import (  # noqa: F401
                SMIRNOFFTemplateGenerator)
            from openff.toolkit import Molecule  # noqa: F401
        except ImportError as e:
            raise ImportError(_IMPORT_ERROR) from e

        # the OpenMM path (enflow_tpu/data/lig.py:38-106)
        import math
        import numpy as np
        import openmm as mm
        import openmm.app as app
        import openmm.unit as unit
        from openmm.vec3 import Vec3
        from openmmforcefields.generators import SMIRNOFFTemplateGenerator
        from openff.units.openmm import to_openmm
        from openff.toolkit import Molecule

        dist_units = unit.angstrom if dist_unit == "ang" else unit.nanometers
        scale = 1e-3 if time_unit == "femto" else 1.0

        # BaseDataset pops `box` into self.box before process() runs;
        # recover it here so the explicit-box solvation branch is reachable
        if box is None:
            box = self.box
        if padding is None and box is None:
            raise ValueError("LIGDataset needs either `padding` or `box` "
                             "for solvation (reference lig.py:26-33 prints "
                             "'error' and crashes later; we fail fast)")

        molecule = Molecule.from_smiles(smiles)
        for atom in molecule.atoms:
            atom.metadata["residue_name"] = name.upper()[:3]
        topology = molecule.to_topology().to_openmm()
        smirnoff = SMIRNOFFTemplateGenerator(molecules=molecule)
        ff = app.ForceField(*force_field)
        ff.registerTemplateGenerator(smirnoff.generator)
        molecule.generate_conformers(n_conformers=int(n_conformers))
        positions = to_openmm(molecule.conformers[0])
        modeller = app.Modeller(topology, positions)
        if padding is not None:
            modeller.addSolvent(ff, padding=float(padding) * dist_units)
        else:
            modeller.addSolvent(ff, boxSize=Vec3(*[float(b) for b in box]) * dist_units)
        system = ff.createSystem(modeller.topology, nonbondedMethod=app.PME,
                                 nonbondedCutoff=1 * unit.nanometer,
                                 constraints=app.HBonds)
        integrator = mm.LangevinMiddleIntegrator(
            float(temp) * unit.kelvin,
            float(friction) / (scale * unit.picosecond),
            float(dt) * scale * unit.picoseconds)
        simulation = app.Simulation(modeller.topology, system, integrator)
        simulation.context.setPositions(modeller.positions)
        simulation.minimizeEnergy()
        simulation.context.setVelocitiesToTemperature(float(temp) * unit.kelvin)

        report_from = int(discard)
        if report_from == -1:
            report_from = int(interval)
        n_steps = int(n_iter)
        z = [a.element.symbol for a in simulation.topology.atoms()]
        for start in range(0, n_steps, int(interval)):
            simulation.step(int(interval))
            step = start + int(interval)
            state = simulation.context.getState(getPositions=True,
                                                getVelocities=True)
            if step < report_from:
                continue
            pos = np.asarray(state.getPositions().value_in_unit(dist_units))
            tu = unit.picoseconds if time_unit == "pico" else unit.femtoseconds
            vel = np.asarray(state.getVelocities().value_in_unit(dist_units / tu))
            bv = simulation.topology.getUnitCellDimensions().value_in_unit(dist_units)
            self.append(z=z, pos=pos, vel=vel, box=np.asarray(bv),
                        label=f"Solvated {name} ({smiles}) Frame: {step}")
        del math

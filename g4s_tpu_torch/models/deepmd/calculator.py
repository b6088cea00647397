"""ASE calculator interface (counterpart of
g4s_tpu/models/deepmd/calculator.py; deepmd/infer/calculator.py DP class).

The reference exposes frozen models to ASE through a Calculator subclass.
`DP` is built at its first use: with ase importable it is that
Calculator, and without ase it raises a clear ImportError. The evaluation
path (DeepPot.eval on positions, cell and types) is the same either way,
and `calc_ase_free` runs it without ase.
"""

from __future__ import annotations

import numpy as np

from g4s_tpu_torch.models.deepmd.infer import DeepPot

# eV/Angstrom units are native to the training data; no conversion needed
__all__ = ["DP", "calc_ase_free"]


def calc_ase_free(model_file, positions, cell, symbols, type_map, *,
                  device="cuda"):
    """ASE-free evaluation with the calculator's conventions: positions
    (N, 3) Angstrom, cell (3, 3), symbols a list of element names,
    type_map the list mapping type index -> element. Returns a dict of
    energy (eV, a float), forces ((N, 3) eV/A) and virial ((3, 3)), host
    numpy arrays."""
    dp = DeepPot(model_file, device=device)
    types = np.asarray([type_map.index(s) for s in symbols], np.int64)
    e, f, v = dp.eval(np.asarray(positions, np.float64),
                      np.asarray(cell, np.float64), types)
    return {"energy": float(e),
            "forces": f.cpu().numpy(),
            "virial": v.cpu().numpy()}


def _make_dp_class():
    try:
        from ase.calculators.calculator import Calculator, all_changes
    except ImportError as err:
        raise ImportError(
            "ase is not installed in this environment; use "
            "g4s_tpu_torch.models.deepmd.calculator.calc_ase_free "
            "instead") from err

    class _DP(Calculator):
        """ASE Calculator backed by a frozen model (reference DP class,
        deepmd/infer/calculator.py:33)."""

        name = "DP"
        implemented_properties = ["energy", "free_energy", "forces",
                                  "virial", "stress"]

        def __init__(self, model, label="DP", type_dict=None, *,
                     device="cuda", **kwargs):
            Calculator.__init__(self, label=label, **kwargs)
            self.dp = DeepPot(model, device=device)
            if type_dict:
                self.type_dict = type_dict
            else:
                self.type_dict = {s: i for i, s in
                                  enumerate(self.dp.type_map)}

        def calculate(self, atoms=None, properties=("energy", "forces"),
                      system_changes=all_changes):
            if atoms is not None:
                self.atoms = atoms.copy()
            coord = self.atoms.get_positions()
            cell = np.asarray(self.atoms.get_cell())
            symbols = self.atoms.get_chemical_symbols()
            atype = np.asarray([self.type_dict[k] for k in symbols],
                               np.int64)
            e, f, v = self.dp.eval(coord, cell, atype)
            W = v.cpu().numpy().reshape(3, 3)
            self.results["energy"] = float(e)
            self.results["free_energy"] = float(e)
            self.results["forces"] = f.cpu().numpy()
            self.results["virial"] = W
            if "stress" in properties:
                vol = abs(np.linalg.det(cell))
                # ASE Voigt order xx yy zz yz xz xy, sign per ASE docs
                stress = -0.5 * (W + W.T) / vol
                self.results["stress"] = stress[[0, 1, 2, 1, 0, 0],
                                                [0, 1, 2, 2, 2, 1]]

    return _DP


class DP:
    """The ASE Calculator over a frozen model, DP(model, label="DP",
    type_dict=None, device="cuda", **kwargs); raises ImportError where
    ase is not installed (calc_ase_free evaluates the same without it)."""

    def __new__(cls, *args, **kwargs):
        return _make_dp_class()(*args, **kwargs)

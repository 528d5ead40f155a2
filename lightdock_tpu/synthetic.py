"""Seeded synthetic docking inputs at the reference examples' atom counts.

The reference example structures are not shipped with this package, so
smoke runs, benchmarks and tests build stand-ins from a seed: PDB files
with real residue and atom names (so DFIRE typing and the AMBER tables
resolve), atoms packed as two compact globules at protein density on a
jittered lattice, poses placed by ``lightdock-tpu-tools setup``, and
optional smooth ANM modes written as ``rec_nm.npy``/``lig_nm.npy``.

Shapes (receptor x ligand atoms) follow the reference examples
(README table; scripts/bench_examples.py): only the atom counts, method
and extras are real, the geometry is synthetic.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class ComplexShape:
    name: str
    n_rec: int
    n_lig: int
    method: str              # dfire | dna | pydock
    anm: bool = False        # 10 + 10 modes when on
    membrane: int = 0        # receptor atoms that are MMB.BJ membrane beads
    restraints: int = 0      # active restraint residues on each partner


SHAPES = {
    "1ppe": ComplexShape("1ppe", 1615, 221, "dfire"),
    "2uuy": ComplexShape("2uuy", 1615, 415, "dfire", anm=True),
    "1czy": ComplexShape("1czy", 1281, 53, "dfire", anm=True),
    "1azp": ComplexShape("1azp", 1094, 506, "dna", anm=True),
    "1k4c": ComplexShape("1k4c", 3413, 3268, "dfire", membrane=160,
                         restraints=6),
}

ANM_MODES = 10
LATTICE = 2.7      # A between lattice atoms: ~0.05 atoms / A^3
JITTER = 0.35      # A of uniform jitter per coordinate
_STANDARD = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS",
             "ILE", "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP",
             "TYR", "VAL")
_NUCLEOTIDES = ("DA", "DC", "DG", "DT")


def residue_templates(method: str, kind: str = "protein"):
    """{residue name: [atom names]} accepted by ``method``'s typing tables
    (DFIRE heavy atoms; AMBER atoms, hydrogens included)."""
    from .scoring import tables

    names = _NUCLEOTIDES if kind == "dna" else _STANDARD
    out = {}
    if method == "dfire":
        if kind == "dna":
            raise ValueError("DFIRE has no nucleotide types")
        slots = tables.dfire_tables()["atom_slot"]
        for res in names:
            atoms = sorted((k[len(res):] for k in slots if k[:3] == res),
                           key=lambda a: slots[res + a])
            out[res] = atoms
    else:
        amber = tables.amber_tables(method)["amber_types"]
        for res in names:
            out[res] = [k.split("-", 1)[1] for k in amber
                        if k.split("-", 1)[0] == res]
    return out


def globule(n: int, rng: np.random.RandomState) -> np.ndarray:
    """(n, 3) coordinates: the n lattice points nearest the origin, in a
    snake order (z slabs, then y rows, then x) so consecutive atoms, and so
    residues, are spatially compact; jittered, centred on the origin."""
    k = int(np.ceil((3.0 * n / (4.0 * np.pi)) ** (1.0 / 3.0))) + 2
    ax = np.arange(-k, k + 1) * LATTICE
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.argsort((pts ** 2).sum(1), kind="stable")[:n]]
    iz = np.round(pts[:, 2] / LATTICE).astype(int)
    iy = np.round(pts[:, 1] / LATTICE).astype(int)
    ix = np.round(pts[:, 0] / LATTICE).astype(int)
    y_snake = np.where(iz % 2 == 0, iy, -iy)
    x_snake = np.where((iz + iy) % 2 == 0, ix, -ix)
    pts = pts[np.lexsort((x_snake, y_snake, iz))]
    pts = pts + rng.uniform(-JITTER, JITTER, pts.shape)
    return pts - pts.mean(axis=0)


def _pdb_line(serial, atom, res, chain, res_seq, xyz):
    name = atom if len(atom) >= 4 else f" {atom:<3}"
    return (f"ATOM  {serial % 100000:5d} {name:<4} {res:>3} {chain}"
            f"{res_seq % 10000:4d}    {xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}"
            f"  1.00  0.00")


def write_pdb(path, coords: np.ndarray, templates: dict, chain: str,
              rng: np.random.RandomState, membrane: int = 0) -> List[str]:
    """Write ``coords`` as residues drawn (seeded) from ``templates``; the
    last ``membrane`` atoms become MMB.BJ beads.  Returns the residue ids
    ("chain.res.seq") in file order."""
    names = sorted(templates)
    n_mol = coords.shape[0] - membrane
    lines, res_ids = [], []
    i, seq = 0, 0
    while i < n_mol:
        seq += 1
        res = names[rng.randint(len(names))]
        res_ids.append(f"{chain}.{res}.{seq}")
        for atom in templates[res][:n_mol - i]:
            lines.append(_pdb_line(i + 1, atom, res, chain, seq, coords[i]))
            i += 1
    for j in range(membrane):
        lines.append(_pdb_line(i + 1, "BJ", "MMB", "M", j + 1, coords[i]))
        i += 1
    pathlib.Path(path).write_text("\n".join(lines + ["END", ""]))
    return res_ids


def membrane_beads(m: int, radius: float, rng) -> np.ndarray:
    """(m, 3) beads on a disc annulus in the z = 0 plane around a receptor
    of ``radius``: the slab a membrane-embedded receptor sits in."""
    r = np.sqrt(rng.uniform((radius + 3.0) ** 2, (radius + 25.0) ** 2, m))
    phi = rng.uniform(0.0, 2.0 * np.pi, m)
    return np.stack([r * np.cos(phi), r * np.sin(phi),
                     rng.uniform(-1.0, 1.0, m)], axis=1)


def anm_modes(coords: np.ndarray, k: int, rng) -> np.ndarray:
    """(k, N, 3) smooth, unit-norm displacement fields: sums of a few
    low-frequency plane waves, the shape of elastic-network modes."""
    span = max(float(np.ptp(coords, axis=0).max()), 1.0)
    modes = np.empty((k, coords.shape[0], 3))
    for m in range(k):
        w = rng.standard_normal((4, 3)) * (np.pi / span) * (0.5 + 0.1 * m)
        amp = rng.standard_normal((4, 3))
        phase = rng.uniform(0, 2 * np.pi, 4)
        modes[m] = np.sin(coords @ w.T + phase) @ amp
        modes[m] /= np.linalg.norm(modes[m])
    return modes


def make_complex(shape, workdir, seed: int = 324324, swarms: int = 10,
                 glowworms: int = 200) -> dict:
    """Write a full simulation input set for ``shape`` under ``workdir``.

    Structures, then ``lightdock-tpu-tools setup`` (swarm centres and
    poses), then ANM modes and restraints.  Returns a dict with the paths
    a run needs: ``setup``, ``positions`` (one file per swarm), ``anm_dir``
    and ``method``.
    """
    from . import cli_tools

    if isinstance(shape, str):
        shape = SHAPES[shape]
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    rec_kind, lig_kind = ("protein", "dna") if shape.method == "dna" else ("protein", "protein")
    n_mol = shape.n_rec - shape.membrane
    rec_xyz = globule(n_mol, rng)
    if shape.membrane:
        radius = float(np.linalg.norm(rec_xyz, axis=1).max())
        rec_xyz = np.concatenate(
            [rec_xyz, membrane_beads(shape.membrane, radius, rng)])
    lig_xyz = globule(shape.n_lig, rng)
    rec_ids = write_pdb(workdir / "rec.pdb", rec_xyz,
                        residue_templates(shape.method, rec_kind), "A", rng,
                        membrane=shape.membrane)
    lig_ids = write_pdb(workdir / "lig.pdb", lig_xyz,
                        residue_templates(shape.method, lig_kind), "B", rng)
    argv = ["setup", str(workdir / "rec.pdb"), str(workdir / "lig.pdb"),
            "--swarms", str(swarms), "--glowworms", str(glowworms),
            "--workdir", str(workdir), "--seed", str(seed),
            "--starting-points-seed", str(seed)]
    if shape.anm:
        argv += ["--anm", "--anm-rec", str(ANM_MODES), "--anm-lig", str(ANM_MODES)]
    cli_tools.main(argv)
    if shape.anm:
        np.save(workdir / "rec_nm.npy", anm_modes(rec_xyz, ANM_MODES, rng))
        np.save(workdir / "lig_nm.npy", anm_modes(lig_xyz, ANM_MODES, rng))
    if shape.restraints or shape.membrane:
        setup_path = workdir / "setup.json"
        setup = json.loads(setup_path.read_text())
        if shape.restraints:
            pick = lambda ids: sorted(  # noqa: E731
                rng.choice(ids, shape.restraints, replace=False).tolist())
            setup["restraints"] = "restraints.list"
            setup["receptor_restraints"] = {"active": pick(rec_ids),
                                            "passive": [], "blocked": []}
            setup["ligand_restraints"] = {"active": pick(lig_ids),
                                          "passive": [], "blocked": []}
        setup["membrane"] = bool(shape.membrane)
        setup_path.write_text(json.dumps(setup, indent=4))
    return {
        "setup": str(workdir / "setup.json"),
        "positions": [str(workdir / "init" / f"initial_positions_{s}.dat")
                      for s in range(swarms)],
        "anm_dir": str(workdir),
        "method": shape.method,
        "shape": shape,
    }


def contact_positions(sim, pull: float = 0.6) -> np.ndarray:
    """The simulation's initial poses with each ligand translation pulled
    toward the receptor centre (scaled by ``pull``): poses in contact, so
    most tile pairs hold atom pairs inside the DFIRE cutoff, where ``setup``
    places them clear of the receptor."""
    pos = np.array(sim.positions, dtype=np.float64)
    centre = sim.receptor.coordinates.mean(axis=0)
    pos[:, :3] = centre + (pos[:, :3] - centre) * pull
    return pos


def load(inputs: dict):
    """``simulation.load_simulation`` for swarm 0 of ``make_complex``."""
    from .simulation import load_simulation

    return load_simulation(inputs["setup"], inputs["positions"][0],
                           inputs["method"], anm_dir=inputs["anm_dir"])

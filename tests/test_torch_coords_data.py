"""The port's internal coordinates and trajectory I/O against the JAX
package, on the CPU: bonds, angles, torsions, BAT and NeRF (float32, to
1e-5 abs on shared inputs), DCD files written by either package and read
by the other with both of the port's backends, and PDB and XYZ round
trips against the JAX package's parsers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import coords as jcoords
from vaemolsim_tpu.data import dcd as jdcd
from vaemolsim_tpu.data import pdb as jpdb
from vaemolsim_tpu.data import xyz as jxyz
from vaemolsim_tpu_torch import coords as tcoords
from vaemolsim_tpu_torch.data import dcd as tdcd
from vaemolsim_tpu_torch.data import (DCDReader, PDBTopology, read_pdb,
                                      read_xyz, write_dcd, write_pdb,
                                      write_xyz)

torch.set_num_threads(1)

A = 8


def _bat(seed, n=64):
    rng = np.random.default_rng(seed)
    bonds = (1.53 + 0.03 * rng.normal(size=(n, A - 1))).astype(np.float32)
    angles = (1.91 + 0.05 * rng.normal(size=(n, A - 2))).astype(np.float32)
    tors = rng.uniform(-np.pi, np.pi, size=(n, A - 3)).astype(np.float32)
    return bonds, angles, tors


def _frames(seed, n=64):
    b, a, t = _bat(seed, n)
    return np.asarray(jcoords.cartesian_from_bat(
        jnp.asarray(b), jnp.asarray(a), jnp.asarray(t),
        jcoords.chain_zmatrix(A)))


@pytest.mark.parametrize("zmatrix", ["chain", "branched"])
def test_nerf_matches_jax(zmatrix):
    z = (jcoords.chain_zmatrix(A) if zmatrix == "chain" else
         np.array([[2, 1, 0], [2, 1, 0], [4, 2, 1], [4, 2, 1], [5, 4, 2]]))
    b, a, t = _bat(1)
    want = np.asarray(jcoords.cartesian_from_bat(
        jnp.asarray(b), jnp.asarray(a), jnp.asarray(t), z))
    got = tcoords.cartesian_from_bat(torch.tensor(b), torch.tensor(a),
                                     torch.tensor(t), z)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_bat_and_measurements_match_jax():
    x = _frames(2) + 0.05 * np.random.default_rng(2).normal(
        size=(64, A, 3)).astype(np.float32)
    z = jcoords.chain_zmatrix(A)
    for got, want in zip(tcoords.bat_from_cartesian(torch.tensor(x), z),
                         jcoords.bat_from_cartesian(jnp.asarray(x), z)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    pairs, triples, quads = [[0, 5], [7, 2]], [[0, 3, 6]], [[6, 1, 4, 2]]
    tx = torch.tensor(x)
    for fn, idx in (("bond_lengths", pairs), ("bond_angles", triples),
                    ("dihedrals", quads)):
        np.testing.assert_allclose(
            getattr(tcoords, fn)(tx, idx).numpy(),
            np.asarray(getattr(jcoords, fn)(jnp.asarray(x), idx)),
            atol=1e-5, rtol=0, err_msg=fn)


def test_bat_round_trip():
    b, a, t = _bat(3)
    z = tcoords.chain_zmatrix(A)
    x = tcoords.cartesian_from_bat(torch.tensor(b), torch.tensor(a),
                                   torch.tensor(t), z)
    for got, want in zip(tcoords.bat_from_cartesian(x, z), (b, a, t)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("box", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dcd_across_packages_and_backends(tmp_path, writer, box):
    x = _frames(4, n=17)
    cell = (np.tile([[9.0, 0.0, 10.0, 90.0, 90.0, 11.0]], (17, 1))
            if box else None)
    path = str(tmp_path / "traj.dcd")
    (jdcd if writer == "jax" else tdcd).write_dcd(path, x, cell)
    readers = [DCDReader(path), DCDReader(path, force_numpy=True),
               jdcd.DCDReader(path, force_numpy=True)]
    assert readers[1].backend == "numpy"
    assert readers[0].backend in ("native", "numpy")
    for r in readers:
        assert (r.n_frames, r.n_atoms, r.has_box) == (17, A, box)
        got, got_box = r.read()
        np.testing.assert_array_equal(got, x)
        if box:
            np.testing.assert_array_equal(got_box, cell)
        part, _ = r.read(5, 3)
        np.testing.assert_array_equal(part, x[5:8])
        batches = list(r.iter_batches(8))
        assert [len(b) for b in batches] == [8, 8, 1]
        r.close()
    with pytest.raises(IOError):
        DCDReader(path, force_numpy=True).read(15, 5)


def test_dcd_native_backend_builds_here():
    """The native reader compiles from the repository's source with the
    host compiler where one is present."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    assert tdcd._native_lib() is not None


def test_pdb_round_trip_against_jax(tmp_path):
    x = _frames(5, n=3)
    topo = PDBTopology(
        atom_names=["N", "CA", "C", "O", "N", "CA", "C", "OXT"],
        res_names=["ALA"] * 4 + ["GLY"] * 4,
        res_ids=np.array([1] * 4 + [2] * 4, np.int32),
        chain_ids=["A"] * 8, elements=["N", "C", "C", "O"] * 2)
    box = np.array([20.0, 21.0, 22.0], np.float32)
    path = str(tmp_path / "a.pdb")
    write_pdb(path, x, topo, box)
    jpath = str(tmp_path / "b.pdb")
    jpdb.write_pdb(jpath, x, jpdb.PDBTopology(
        topo.atom_names, topo.res_names, topo.res_ids, topo.chain_ids,
        topo.elements), box)
    assert open(path).read() == open(jpath).read()
    for reader in (read_pdb, jpdb.read_pdb):
        got, t2, b2 = reader(path)
        np.testing.assert_allclose(got, x, atol=6e-4)
        np.testing.assert_array_equal(b2, box)
        assert t2.atom_names == topo.atom_names
        assert t2.residues() == [("ALA", 1), ("GLY", 2)]
        np.testing.assert_array_equal(t2.res_atom_nums(), [4, 4])
        np.testing.assert_allclose(
            t2.masses(), jpdb.read_pdb(path)[1].masses())


def test_xyz_round_trip_against_jax(tmp_path):
    x = _frames(6, n=4)
    path = str(tmp_path / "a.xyz")
    write_xyz(path, x, ["C", "N"] * 4)
    for reader in (read_xyz, jxyz.read_xyz):
        got, elements = reader(path)
        np.testing.assert_allclose(got, x, atol=6e-6)
        assert elements == ["C", "N"] * 4
    jpath = str(tmp_path / "b.xyz")
    jxyz.write_xyz(jpath, x)
    got, elements = read_xyz(jpath)
    np.testing.assert_allclose(got, x, atol=6e-6)
    assert elements == ["C"] * A

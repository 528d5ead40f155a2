"""CLI contract tests (in-process main(), CPU platform)."""

import os
import shutil

import numpy as np
import pytest

from lightdock_tpu.cli import main as cli_main
from lightdock_tpu.cli_analysis import main as analysis_main
from lightdock_tpu.cli_tools import main as tools_main


@pytest.fixture()
def workdir(tmp_path, reference_dir, monkeypatch):
    """Chdir into a temp dir with the 1czy ANM files (cwd-relative like the
    reference binary)."""
    ex = reference_dir / "example/1czy"
    shutil.copy(ex / "rec_nm.npy", tmp_path / "rec_nm.npy")
    shutil.copy(ex / "lig_nm.npy", tmp_path / "lig_nm.npy")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_cli_single_swarm(workdir, reference_dir):
    ex = reference_dir / "example/1czy"
    rc = cli_main([str(ex / "setup.json"),
                   str(ex / "init/initial_positions_0.dat"),
                   "3", "dfire", "--platform", "cpu", "--dtype", "float32"])
    assert rc == 0
    out = workdir / "swarm_0/gso_1.out"
    assert out.exists()
    assert len(out.read_text().splitlines()) == 201


def test_cli_multi_swarm_and_analysis(workdir, reference_dir):
    ex = reference_dir / "example/1czy"
    pos = ",".join(str(ex / f"init/initial_positions_{i}.dat") for i in (0, 1))
    rc = cli_main([str(ex / "setup.json"), pos, "3", "dfire",
                   "--platform", "cpu", "--dtype", "float32"])
    assert rc == 0
    assert (workdir / "swarm_0/gso_1.out").exists()
    assert (workdir / "swarm_1/gso_1.out").exists()
    # gso files only exist for steps 1 (3 steps -> no step-10 snapshot)
    assert not (workdir / "swarm_0/gso_3.out").exists()

    rc = analysis_main(["all", str(workdir), "1",
                        "--setup", str(ex / "setup.json"), "-n", "3"])
    assert rc == 0
    assert (workdir / "rank_by_scoring.list").exists()
    assert (workdir / "swarm_0/cluster.repr").exists()
    tops = sorted((workdir / "top").glob("top_*.pdb"))
    assert len(tops) == 3


def test_cli_dq_bf16_and_kernel_flag(workdir, reference_dir, capsys):
    """XLA DFIRE has one form, the flat-table gather: the removed
    --dq-bf16 option (bfloat16 step tables) is refused; --energy-mode
    pallas off a GPU fails instead of falling back to the interpreter."""
    ex = reference_dir / "example/1czy"
    argv = [str(ex / "setup.json"), str(ex / "init/initial_positions_0.dat"),
            "1", "dfire", "--platform", "cpu", "--dtype", "float32",
            "--energy-mode", "xla"]
    assert cli_main(argv) == 0
    scores = np.array([float(ln.rsplit()[-1]) for ln in
                       (workdir / "swarm_0/gso_1.out").read_text().splitlines()[1:]])
    assert np.isfinite(scores).all()

    with pytest.raises(SystemExit):
        cli_main(argv + ["--dq-bf16"])
    assert "--dq-bf16" in capsys.readouterr().err

    with pytest.raises(RuntimeError, match="NVIDIA GPUs only"):
        cli_main(argv + ["--energy-mode", "pallas"])


def test_cli_bad_method(reference_dir, capsys):
    ex = reference_dir / "example/1czy"
    with pytest.raises(SystemExit):
        cli_main([str(ex / "setup.json"),
                  str(ex / "init/initial_positions_0.dat"), "3", "nonsense"])


def test_tools_flatten(tmp_path, reference_dir):
    src = reference_dir / "example/1azp/lightdock_rec.nm.npy"
    dst = tmp_path / "rec_nm.npy"
    assert tools_main(["flatten", str(src), str(dst)]) == 0
    assert np.array_equal(np.load(dst),
                          np.load(reference_dir / "example/1azp/rec_nm.npy"))


@pytest.fixture(scope="module")
def tiny_complex(tmp_path_factory):
    from lightdock_tpu import synthetic

    shape = synthetic.ComplexShape("tiny", 120, 40, "dfire")
    return synthetic.make_complex(shape, tmp_path_factory.mktemp("tiny"),
                                  swarms=1, glowworms=6)


def test_cli_platform_gpu_without_gpu_raises(tiny_complex, tmp_path):
    import jax

    before = jax.config.jax_platforms
    argv = [tiny_complex["setup"], tiny_complex["positions"][0], "1",
            "dfire", "--platform", "gpu", "--output-dir", str(tmp_path)]
    try:
        with pytest.raises(RuntimeError):
            cli_main(argv)
    finally:
        jax.config.update("jax_platforms", before)
    assert jax.default_backend() == "cpu"


def test_cli_kernel_mode_off_gpu_raises(tiny_complex, tmp_path):
    argv = [tiny_complex["setup"], tiny_complex["positions"][0], "1",
            "dfire", "--energy-mode", "pallas", "--output-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="NVIDIA GPUs only"):
        cli_main(argv)


def test_cli_auto_mode_runs_xla_on_cpu(tiny_complex, tmp_path):
    argv = [tiny_complex["setup"], tiny_complex["positions"][0], "10",
            "dfire", "--platform", "cpu", "--output-dir", str(tmp_path)]
    assert cli_main(argv) == 0
    assert (tmp_path / "gso_10.out").exists()


def test_energy_chunk_from_budget():
    from lightdock_tpu.cli import (HOST_ENERGY_BUDGET, energy_budget_bytes,
                                   pick_energy_chunk)

    assert energy_budget_bytes() == HOST_ENERGY_BUDGET  # CPU: no bytes_limit
    pairs = 3413 * 3268
    assert pick_energy_chunk(pairs, 200, 4, HOST_ENERGY_BUDGET) == 5
    # a 60 GB device budget (a quarter of it for intermediates) -> 50 poses
    assert pick_energy_chunk(pairs, 200, 4, 0.25 * 60e9) == 50
    assert pick_energy_chunk(1615 * 221, 200, 4, 0.25 * 60e9) == 0

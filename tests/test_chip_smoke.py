"""chip_smoke.py: refuses to run without a GPU; its main-path phase
closes a tiny deployment on the CPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(script, cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["cpu_backend", "script_alone"])
def test_refuses_without_gpu_or_repo(where, tmp_path):
    if where == "cpu_backend":
        res = _run(ROOT / "chip_smoke.py", ROOT, {"JAX_PLATFORMS": "cpu"})
        assert "not 'gpu'" in res.stderr
    else:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        res = _run(tmp_path / "chip_smoke.py", tmp_path,
                   {"JAX_PLATFORMS": "cpu"})
        assert "no gappadder package" in res.stderr
    assert res.returncode != 0
    for line in res.stdout.splitlines():
        assert '"ok"' not in line, line


def test_main_path_phase_tiny(tmp_path):
    import chip_smoke
    chip_smoke._import_paths()
    res = chip_smoke.main_path(tmp_path, n_gaps=8, scaf_kb=8,
                               kset=((25, 21),), flank=100)
    assert res["gaps"] == 8 and res["closed"] == 8 and res["wrong"] == 0
    assert set(res["metrics"]["stages"]) == {"preprocess", "collect",
                                             "assembly", "patch"}
    cfg = json.loads((tmp_path / "work.json").read_text())
    assert cfg["parameters"]["flank_length"] == 100
    assert cfg["kmer_length"] == [{"k": 25, "k_velvet": [{"k": 21}]}]


def test_four_phase_tiny(tmp_path, capsys):
    """The four-device phase gives byte-equal outputs on a mesh of four
    CPU devices and on one."""
    import chip_smoke
    chip_smoke._import_paths()
    chip_smoke.four_phase("cpu", tmp_path, n_gaps=8, scaf_kb=8, n=4,
                          kset=((25, 21),), flank=100)
    out = capsys.readouterr().out
    for name in ("picked_seqs.fa", "picked_seqs.fa_ori.txt",
                 "merge_info.txt"):
        assert f"four: {name} byte-equal" in out


def test_parse_ksets():
    import chip_smoke
    assert chip_smoke.parse_ksets("30:29,50:47") == ((30, 29), (50, 47))

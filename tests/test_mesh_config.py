"""device.mesh_shape beyond the available devices is an error, never a
quiet single-device run."""

import dataclasses

import jax
import pytest

from gappadder.config import Config, DeviceParams
from gappadder.parallel.mesh import mesh_from_config
from gappadder.pipeline import collect, run
from gappadder.pipeline.workspace import Workspace


def test_mesh_from_config_sizes():
    n = len(jax.devices())
    assert mesh_from_config((1,)) is None
    m = mesh_from_config((2, 2))
    assert m.devices.size == 4
    with pytest.raises(RuntimeError, match="needs"):
        mesh_from_config((n + 1,))


@pytest.mark.parametrize("stage", ["collect", "assembly"])
def test_stage_raises_when_mesh_exceeds_devices(stage, tmp_path):
    too_many = len(jax.devices()) * 2
    cfg = Config(draft_genome=str(tmp_path / "draft.fa"),
                 working_folder=str(tmp_path / "work"),
                 device=DeviceParams(mesh_shape=(too_many,)))
    ws = Workspace(cfg.workdir)
    fn = collect.run_collect if stage == "collect" \
        else run.run_assembly_and_pick
    with pytest.raises(RuntimeError, match=f"needs {too_many} devices"):
        fn(cfg, ws)
    # the same config with a mesh that fits gets past the check (and
    # then fails for want of a preprocessed workspace)
    ok = dataclasses.replace(cfg, device=DeviceParams(mesh_shape=(2,)))
    with pytest.raises(FileNotFoundError):
        fn(ok, ws)


@pytest.mark.parametrize("extra,error", [
    ({"accelerator": {"mesh_shape": [4]}}, "top level"),   # unknown section
    ({"device": {"mesh": [4]}}, "section 'device'"),       # misspelt knob
    ({"software_path": {"bwa": "bwa"}, "__comment": "x",
      "device": {"mesh_shape": [4]}}, None),               # reference extras
])
def test_config_rejects_unknown_keys(extra, error):
    """A mesh_shape in a section the loader does not read would leave the
    run on one device without a word: unknown keys raise instead."""
    from gappadder.config import config_from_dict
    data = dict({"draft_genome": {"fa": "draft.fa"}}, **extra)
    if error is None:
        assert config_from_dict(data).device.mesh_shape == (4,)
    else:
        with pytest.raises(ValueError, match=error):
            config_from_dict(data)

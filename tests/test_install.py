"""What the package needs installed, and where it keeps its compile cache."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """$JAX_COMPILATION_CACHE_DIR when set (and no directory set in code),
    the fixed <repo>/.jax_cache otherwise."""
    import jax

    from datmo_using_optical_flow.utils import compile_cache

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(tmp_path / "c"))
        assert compile_cache.enable() == str(tmp_path / "c")
        assert updates["jax_compilation_cache_dir"] == str(tmp_path / "c")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env_dir))
        assert compile_cache.enable() == str(tmp_path / env_dir)
        assert "jax_compilation_cache_dir" not in updates
    assert os.path.isdir(compile_cache.enable())


def test_default_cache_dir_is_in_the_repo():
    from datmo_using_optical_flow.utils.compile_cache import DEFAULT_DIR

    assert DEFAULT_DIR == os.path.join(REPO, ".jax_cache")


_BLOCKED_IMPORT = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("yaml", "pandas", "matplotlib"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Block())
import os
import jax
jax.config.update("jax_platforms", "cpu")
import datmo_using_optical_flow
from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA
from datmo_using_optical_flow.models.gmfa import GMFAPipeline, save_tracks_to_excel
from datmo_using_optical_flow.io.artifacts import ArtifactSink
out = sys.argv[1]
sink = ArtifactSink(out, save_png=False)
sink.save_ekf_tracks({3: [1.0, 2.0, 0.5, -0.25]}, 0)
save_tracks_to_excel([{"Frame": 0, "Track ID": 3, "X": 1.0, "Y": 2.0,
                       "VX": 0.5, "VY": -0.25}], os.path.join(out, "t.xlsx"))
print(open(os.path.join(out, "t.csv")).read(), end="")
"""


def test_import_without_yaml_pandas_matplotlib(tmp_path):
    """The package, both pipelines and the artifact writers need only numpy,
    scipy and JAX; the track log falls back to the csv module."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.splitlines()[-2:] == ["Frame,Track ID,X,Y,VX,VY",
                                            "0,3,1.0,2.0,0.5,-0.25"]
    assert (tmp_path / "ekf_tracks_frame_0.yaml").read_text() == \
        "3:\n- 1.0\n- 2.0\n- 0.5\n- -0.25\n"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracks_yaml_matches_yaml_dump(seed):
    """The in-repo emitter writes what yaml.dump writes, byte for byte."""
    yaml = pytest.importorskip("yaml")
    from datmo_using_optical_flow.io.artifacts import dump_tracks_yaml

    rng = np.random.default_rng(seed)
    special = [0.0, -0.0, 1e17, -2.5e-8, float("inf"), float("-inf"),
               float("nan"), 3.0, 123456789.0]
    tracks = {}
    for _ in range(int(rng.integers(0, 12))):
        vals = [float(v) for v in rng.normal(size=4) * 10.0 ** rng.integers(-6, 8)]
        vals[int(rng.integers(0, 4))] = special[int(rng.integers(0, len(special)))]
        tracks[int(rng.integers(-5, 100000))] = vals
    if seed == 2:
        tracks[7] = []
    assert dump_tracks_yaml(tracks) == yaml.dump(tracks)


def test_tracks_yaml_roundtrip():
    from datmo_using_optical_flow.io.artifacts import dump_tracks_yaml, load_tracks_yaml

    tracks = {3: [1.0, -2.5e-08, 1e17, -0.0], 7: [], -4: [0.5, float("inf")]}
    assert load_tracks_yaml(dump_tracks_yaml(tracks)) == tracks
    assert load_tracks_yaml(dump_tracks_yaml({})) == {}

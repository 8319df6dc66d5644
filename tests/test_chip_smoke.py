"""chip_smoke.py refuses to run, before compiling anything, without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("args,alone", [([], False), (["--four-cards"], False),
                                        ([], True)])
def test_chip_smoke_fails_on_cpu(tmp_path, args, alone):
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:               # a directory holding the script and nothing else
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    r = subprocess.run([sys.executable, script, *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs" in r.stderr and "GPU" in r.stderr
    assert not (tmp_path / "cache").exists()      # nothing was compiled

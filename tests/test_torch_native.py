"""The port's native helper (``ns_gls_tpu_torch/utils/native.py``) built
by many processes at once: each waits for the one build under the lock
and loads a complete library, none falls back to numpy.  The build goes
to a directory of the test's own; nothing of the repository is deleted
or written.
"""

import os
import subprocess
import sys
import time

from ns_gls_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 10
STAGGER_S = 0.1

# loads the library from the build directory argv[1] and uses it once
CHILD = """
import sys
import numpy as np
from ns_gls_tpu_torch.utils import native
lib = native.load_library(sys.argv[1])
assert lib is not None, "no library"
keys = np.array([[1, 2], [3, 4], [1, 2]], np.int64)
out = np.empty(3, np.int64)
assert lib.mk_unique_rows(keys, 3, 2, out) == 2
assert out.tolist() == [0, 1, 0], out
print("loaded")
"""


def test_simultaneous_first_builds_all_load(tmp_path):
    """Ten processes started 0.1 s apart on an empty build directory,
    most of them while the first one's compiler runs (the build takes
    about 2 s on an 8-core CPU): every one loads the library, one
    library is left and no temporary file."""
    assert native._compiler() is not None
    build = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = []
    try:
        for _ in range(N_PROCS):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD, build], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            time.sleep(STAGGER_S)
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "loaded", out
    files = sorted(os.listdir(build))
    libs = [f for f in files if f.endswith(".so")]
    assert len(libs) == 1 and libs[0].startswith("libmeshkit-"), files
    assert not [f for f in files if f.endswith(".tmp")], files

"""``utils/cuda_build.py`` without nvcc: a stub compiler that writes its
output slowly, and two processes that build the same library at once, as
the ranks of ``torchrun`` do on a cold build directory."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CHUNKS = 5
CHUNK = 100_000

STUB = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write("run\\n")
with open(out, "wb") as f:
    for i in range({chunks}):
        f.write(bytes([i + 1]) * {chunk})
        f.flush()
        time.sleep(0.2)
"""

BUILD = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from detectinblur_tpu_torch.utils import cuda_build as cb
cb.CSRC = Path({csrc!r})
cb.BUILD_DIR = cb.CSRC / "build"
cb.build(["k"])
data = cb.library_path("k").read_bytes()
want = b"".join(bytes([i + 1]) * {chunk} for i in range({chunks}))
print(len(data), data == want)
"""


def test_concurrent_builds_compile_once_and_read_whole_files(tmp_path):
    """Two build processes started together: one runs the compiler, the
    other waits on the lock and finds the library built; both read the
    whole file (the compiler writes a temporary name, renamed when it
    ends), and no temporary file is left."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a stub kernel\n")
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable, log=str(log),
                                chunks=CHUNKS, chunk=CHUNK))
    nvcc.chmod(0o755)
    code = BUILD.format(root=str(ROOT), csrc=str(csrc), chunks=CHUNKS,
                          chunk=CHUNK)
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == [str(CHUNKS * CHUNK), "True"], out
    assert log.read_text().count("run") == 1
    built = sorted(q.name for q in (csrc / "build").iterdir())
    assert [n for n in built if n.endswith(".so")] and not [
        n for n in built if n.endswith(".tmp")], built

"""Launch a script as the ranks of a ``torch.distributed`` group on the
CPU (gloo) for the port's multi-process tests. Each rank's output goes to a
file, never a pipe: the ranks advance in lockstep through collectives, so a
rank blocked on a full pipe that nobody reads would stall every rank. A
launch that outlives its timeout kills every rank it started."""
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(script: str, tmp: Path, tag: str, args=(), n: int = 2,
           timeout: float = 120.0, meanwhile=None) -> list[str]:
    """Run ``script`` (Python source) in ``n`` processes as ``python
    script RANK PORT *args``, and ``meanwhile()`` (if given) in this
    process while they run; returns each rank's output after asserting
    that every rank exited with 0."""
    path = tmp / f"{tag}.py"
    path.write_text(script)
    port = str(free_port())
    # one PyTorch thread per rank, and no JAX in the ranks' environment
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "MASTER_ADDR", "MASTER_PORT",
                        "WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    logs = [tmp / f"{tag}_rank{r}.log" for r in range(n)]
    procs = []
    try:
        for r in range(n):
            with open(logs[r], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, str(path), str(r), port,
                     *map(str, args)],
                    cwd=str(ROOT), env=env, stdout=fh,
                    stderr=subprocess.STDOUT))
        if meanwhile is not None:
            meanwhile()
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{tag}: the ranks did not finish in {timeout} "
                             "s; output:\n" + "\n---\n".join(
                                 log.read_text()[-3000:] for log in logs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{tag} rank {r} failed:\n{out[-4000:]}"
    return outs

"""Start one process per rank and wait for them all.

Each rank process gets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT (mesh.init_from_env reads them). Rank 0 writes to the caller's
standard output and error; the other ranks' output goes to files and is
printed only when a rank fails. When any rank exits with a nonzero code,
the others are killed and the run fails: no rank is left waiting in a
collective for a peer that is gone.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankFailure(RuntimeError):
    """A rank process exited with a nonzero code or ran out of time."""


def run_ranks(world: int, argv: Callable[[int], List[str]], *,
              env: Optional[dict] = None, cwd: Optional[str] = None,
              timeout: Optional[float] = None) -> None:
    """Run `argv(rank)` for rank 0..world-1 as processes of one group.

    Raises RankFailure when a rank fails or the run outlasts `timeout`
    seconds; every rank process has ended when this returns or raises."""
    port = str(free_port())
    base = dict(os.environ if env is None else env)
    procs, logs = [], {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
        try:
            for r in range(world):
                e = dict(base, RANK=str(r), WORLD_SIZE=str(world),
                         LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                         MASTER_PORT=port)
                out = err = None
                if r > 0:
                    logs[r] = out = stack.enter_context(
                        open(os.path.join(tmp, f"rank{r}.log"), "w+"))
                    err = subprocess.STDOUT
                procs.append(subprocess.Popen(
                    argv(r), env=e, cwd=cwd, stdin=subprocess.DEVNULL,
                    stdout=out, stderr=err))
            t0 = time.monotonic()
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                for r, p in enumerate(procs):
                    if p.poll() not in (None, 0):
                        failed = (r, f"exit code {p.returncode}")
                        break
                if (failed is None and timeout is not None
                        and time.monotonic() - t0 > timeout):
                    failed = (None, f"time limit of {timeout:.0f} s")
                time.sleep(0.05)
            if failed is None:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failed = (bad[0], f"exit code {procs[bad[0]].returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        if failed is not None:
            for r, log in logs.items():
                log.seek(0)
                sys.stderr.write(f"--- rank {r} ---\n{log.read()[-4000:]}\n")
            r, why = failed
            who = "the run" if r is None else f"rank {r} of {world}"
            raise RankFailure(f"{who} failed: {why}")

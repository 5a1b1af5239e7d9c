#!/usr/bin/env python3
"""Where the time of ``chip_smoke.py``'s ``dispatch`` phase goes, on one
NVIDIA GPU.

Times the disk first (one 1 GiB raw write, and an npz write and read of
the same bytes in the temporary directory), then runs the phase with
timers around the checkpoint manager's save (host copy, and the write
where it blocks), its write (``np.savez``), its restore and each leaf it
reads, the ZeRO-3 gathers of a save (``Zero3.gather_state``), the
reshard at a degree switch (``Zero3.reshard_state``) and
``train.restore_state``.  The timers are installed when this module is
imported, so the ranks the phase spawns (which import it again) time
their calls too.  Each call prints a ``TIMING <what> pid=<pid> s=<s>``
line to stderr; the phase's own lines go to stdout.

    python3 scripts/dispatch_ckpt_profile.py
"""

from __future__ import annotations

import functools
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch.checkpoint.manager as cm  # noqa: E402
import repro_torch.launch.train as tr  # noqa: E402
import repro_torch.runtime.zero as zm  # noqa: E402


def timed(owner, name: str, what: str) -> None:
    """Replace ``owner.name`` by a wrapper that prints its wall time."""
    orig = getattr(owner, name)

    @functools.wraps(orig)
    def wrap(*args, **kw):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kw)
        finally:
            print(f"TIMING {what} pid={os.getpid()} "
                  f"s={time.perf_counter() - t0:.3f}", file=sys.stderr,
                  flush=True)
    setattr(owner, name, wrap)


timed(cm.CheckpointManager, "save", "ckpt.save")
timed(cm.CheckpointManager, "_write", "ckpt._write")
timed(cm.CheckpointManager, "restore", "ckpt.restore")
timed(cm, "_from_host", "ckpt._from_host(leaf)")
timed(np, "savez", "np.savez")
timed(zm.Zero3, "gather_state", "zero.gather_state")
timed(zm.Zero3, "reshard_state", "zero.reshard_state")
timed(tr, "restore_state", "train.restore_state")


def disk_times() -> None:
    d = tempfile.mkdtemp()
    try:
        x = np.random.default_rng(0).integers(0, 255, 1 << 30,
                                              dtype=np.uint8)
        t0 = time.perf_counter()
        with open(f"{d}/raw.bin", "wb") as f:
            f.write(x.tobytes())
        cs.emit("disk_raw_write_1GiB", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.savez(f"{d}/a.npz", x=x)
        cs.emit("disk_npz_write_1GiB", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        with np.load(f"{d}/a.npz") as z:
            z["x"]
        cs.emit("disk_npz_read_1GiB", seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(d)


def main() -> int:
    import torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("dispatch_ckpt_profile: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    disk_times()
    cs.timed(cs.dispatch_phase, torch)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        cs.close_rank_pool()
    sys.exit(code)
